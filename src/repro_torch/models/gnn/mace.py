"""MACE — higher-order E(3)-equivariant message passing (arXiv:2206.07697);
the JAX package's ``models/gnn/mace.py``.

Message passing is a scatter-add over the edge index
(``Tensor.index_add_``, the reference's ``jax.ops.segment_sum``); no
kernel of the port's is on this path.  The model, as the reference
keeps it:

- a radial Bessel basis (n_rbf) with a polynomial cutoff envelope;
- real spherical harmonics up to l_max = 2 (explicit formulas);
- the A-basis: per node and channel, the sum of R(r)·Y_lm(r̂)·(W h_j)
  over the incoming edges;
- the invariant products of correlation order ≤ 3 of the A-features
  (Σ_m A_lm² is rotation-invariant);
- per layer a residual update, then linear readouts, the energy summed
  per graph.

Inter-layer messages carry the scalar channel only (the reference's
simplification), so energies are E(3)-invariant and the forces from
autograd equivariant.

Parameters are a plain dict: ``embed``, ``node_head``, ``energy_head``
and ``layers``, a list of dicts (``w_radial``, ``w_neighbor``,
``w_product``, ``w_self``, ``norm``), as ``optim/tree.py`` walks it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.optim.tree import from_numpy as params_from_numpy  # noqa: F401

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# invariant product features per channel (see ``_products``)
N_INVARIANTS = 7


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    d_feat: int = 64  # input node feature dim (species embedding or graph feats)
    r_cut: float = 5.0
    n_classes: int = 8  # node-level readout width (classification shapes)
    dtype: str = "float32"

    @property
    def n_sh(self) -> int:  # 1 + 3 + 5 for l_max=2
        return (self.l_max + 1) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# --------------------------------------------------------------------------
# geometric bases
# --------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """sin(nπr/rc)/r Bessel basis with smooth polynomial cutoff."""
    r = torch.clamp_min(r, 1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    x = r[..., None] / r_cut
    basis = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * x) / r[..., None]
    # polynomial cutoff envelope (p=6), zero at r_cut with smooth derivs
    p = 6.0
    env = (
        1.0
        - (p + 1) * (p + 2) / 2 * x ** p
        + p * (p + 2) * x ** (p + 1)
        - p * (p + 1) / 2 * x ** (p + 2)
    )
    env = torch.where(x < 1.0, env, torch.zeros_like(env))
    return basis * env


def real_sph_harm(unit: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real spherical harmonics Y_lm(r̂) for l ≤ 2, [E, (l_max+1)²]."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    out = [torch.ones_like(x) * 0.2820948]  # l=0
    if l_max >= 1:
        c1 = 0.4886025
        out += [c1 * y, c1 * z, c1 * x]
    if l_max >= 2:
        out += [
            1.0925484 * x * y,
            1.0925484 * y * z,
            0.3153916 * (3 * z * z - 1.0),
            1.0925484 * x * z,
            0.5462742 * (x * x - y * y),
        ]
    return torch.stack(out, dim=-1)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init(cfg: MACEConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's distributions (matrices
    N(0, 1) · d_in^-½, zero norms), drawn from ``generator`` on
    ``device`` (the generator's own by default; a CPU generator may draw
    onto ``meta``)."""
    device = generator.device if device is None else torch.device(device)
    c = cfg.d_hidden

    def dense(d_in, d_out):
        return layers.dense_init(generator, d_in, d_out, device=device)

    params = {
        "embed": dense(cfg.d_feat, c),
        "node_head": dense(c, cfg.n_classes),
        "energy_head": dense(c, 1),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "w_radial": dense(cfg.n_rbf, c),
            "w_neighbor": dense(c, c),
            "w_product": dense(N_INVARIANTS * c, c),
            "w_self": dense(c, c),
            "norm": torch.zeros((c,), dtype=torch.float32, device=device),
        })
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _products(a: torch.Tensor, cfg: MACEConfig) -> torch.Tensor:
    """Invariant product basis up to correlation order 3.

    a: [N, C, n_sh] A-basis features.  Returns [N, C, 7]:
      order 1: A_00
      order 2: |A_1|², |A_2|², A_00²
      order 3: A_00·|A_1|², A_00·|A_2|², A_00³
    """
    a0 = a[..., 0]
    b1 = (torch.sum(torch.square(a[..., 1:4]), dim=-1) if cfg.l_max >= 1
          else a0 * 0)
    b2 = (torch.sum(torch.square(a[..., 4:9]), dim=-1) if cfg.l_max >= 2
          else a0 * 0)
    return torch.stack(
        [a0, b1, b2, a0 * a0, a0 * b1, a0 * b2, a0 * a0 * a0], dim=-1)


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """``jax.ops.segment_sum(values, ids, num_segments=n)``: rows of
    ``values`` added into ``n`` segments (in atomic order on the card)."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids.to(torch.int64), values)


def forward(
    params: dict,
    node_feats: torch.Tensor,  # [N, d_feat]
    positions: torch.Tensor,  # [N, 3]
    senders: torch.Tensor,  # [E] int
    receivers: torch.Tensor,  # [E] int
    cfg: MACEConfig,
    edge_mask: torch.Tensor | None = None,  # [E] (padding)
    graph_ids: torch.Tensor | None = None,  # [N] int for batched graphs
    n_graphs: int = 1,
):
    """Returns (node_logits [N, n_classes], energies [n_graphs])."""
    n = node_feats.shape[0]
    dt = cfg.compute_dtype
    senders, receivers = senders.to(torch.int64), receivers.to(torch.int64)
    h = node_feats.to(dt) @ params["embed"].to(dt)

    r_vec = positions[receivers] - positions[senders]  # [E, 3]
    r_len = torch.sqrt(torch.sum(torch.square(r_vec), dim=-1) + 1e-12)
    unit = r_vec / r_len[..., None]
    rbf = bessel_rbf(r_len, cfg.n_rbf, cfg.r_cut)  # [E, n_rbf]
    sh = real_sph_harm(unit, cfg.l_max)  # [E, n_sh]
    # degenerate edges (r ≈ 0: self-loops, padding) carry no message: a
    # zero vector's "direction" does not co-rotate
    valid = (r_len > 1e-5).to(rbf.dtype)
    if edge_mask is not None:
        valid = valid * edge_mask
    rbf = rbf * valid[:, None]

    for lp in params["layers"]:
        radial = rbf @ lp["w_radial"].to(dt)  # [E, C]
        hj = (h @ lp["w_neighbor"].to(dt))[senders]  # [E, C]
        # edge message: per-channel radial gate × neighbour state × Y_lm
        msg = (radial * hj)[:, :, None] * sh[:, None, :]  # [E, C, n_sh]
        a = _segment_sum(msg, receivers, n)  # [N, C, n_sh]
        b = _products(a, cfg)  # [N, C, 7]
        upd = b.reshape(n, -1) @ lp["w_product"].to(dt)
        h = h + F.silu(
            layers.rms_norm(upd + h @ lp["w_self"].to(dt), lp["norm"],
                            unit_offset=True))

    node_logits = h @ params["node_head"].to(dt)
    node_energy = (h @ params["energy_head"].to(dt))[:, 0]
    if graph_ids is None:
        energies = torch.sum(node_energy, dim=0, keepdim=True)
    else:
        energies = _segment_sum(node_energy, graph_ids, n_graphs)
    return node_logits, energies


def energy_and_forces(params, node_feats, positions, senders, receivers,
                      cfg: MACEConfig, **kw):
    """(E, forces): the energy summed over the graphs and forces =
    -∂E/∂pos (exactly equivariant by construction)."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_()
        _, energies = forward(params, node_feats, pos, senders, receivers,
                              cfg, **kw)
        energy = torch.sum(energies)
        (grad,) = torch.autograd.grad(energy, pos)
    return energy.detach(), -grad
