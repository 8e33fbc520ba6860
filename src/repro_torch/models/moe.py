"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``):
dropless sort + grouped products.

Routing: an f32 softmax router → the top-k experts of each token
(optionally renormalized, qwen3 style).  Dispatch: the (token, slot)
pairs are stably sorted by expert id, the tokens gathered in that order,
both expert products run as grouped products over the expert-sorted rows
(``torch._grouped_mm``, the counterpart of ``jax.lax.ragged_dot``), the
rows put back in (token, slot) order and combined with the gates.
Shared experts (deepseek) are a plain MLP.  Aux: the Switch load-balance
loss, mean(prob) · mean(assignment) · E, computed as the reference
computes it.

Nothing reads back to the host, so a prefill or decode step with MoE
layers can be captured into a CUDA graph: the group ends come from
``searchsorted`` over the sorted expert ids on the device (``bincount``
sizes its output from the data), empty groups are empty ranges, and the
combine sums each token's k rows in slot order (no atomics: a replay
gives the eager step's bits).

The reference's multi-device forms serve its token-sharded training
mesh (``launch/mesh.make_host_mesh``).  The port's host mesh places no
token shard on a card of its own (one data replica on one card), so
``sharding_ctx`` keeps the reference's name and changes nothing: the
dropless dispatch of each token's (token, slot) pairs is the same
whether the tokens are sorted per shard or all at once.
``apply_expert_parallel`` is the capacity-bounded expert-parallel form:
each expert shard of the model axis owns E/n_ep experts and gathers at
most ``capacity`` of the (token, slot) pairs routed to them (GShard
semantics: overflow drops), and the shards' outputs are summed in shard
order (the reference's psum).  On one card the shards are logical: they
run one after another on the card.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import layers


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    norm_topk: bool = True
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.001


@contextlib.contextmanager
def sharding_ctx(mesh, token_axes: tuple[str, ...]):
    """The reference's token-sharded dispatch context.  The port places
    no token shard on a card of its own, and dispatching the shards one
    by one on one card gives what ``apply`` gives, so the context
    changes nothing."""
    yield


def init(gen: torch.Generator, cfg: MoEConfig, d_model: int,
         device=None) -> dict:
    """The reference's distributions: router [D, E] and the stacked
    experts w_gate/w_up [E, D, F] (normal × D^-1/2), w_down [E, F, D]
    (normal × F^-1/2), and a shared MLP of F · n_shared; float32."""
    e, f = cfg.n_experts, cfg.d_ff_expert

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * scale

    params = {
        "router": layers.dense_init(gen, d_model, e, device=device),
        "w_gate": normal(e, d_model, f, scale=d_model ** -0.5),
        "w_up": normal(e, d_model, f, scale=d_model ** -0.5),
        "w_down": normal(e, f, d_model, scale=f ** -0.5),
    }
    if cfg.n_shared:
        params["shared"] = layers.mlp_init(gen, d_model, f * cfg.n_shared,
                                           device=device)
    return params


def route(params, x: torch.Tensor, cfg: MoEConfig):
    """(probs [T, E] f32, gates [T, k] f32, expert ids [T, k] int64).
    The top k are taken by a stable descending sort, so ties go to the
    lower expert id, as ``jax.lax.top_k`` breaks them."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    if cfg.norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, ids


def group_ends(sorted_expert: torch.Tensor, n_experts: int) -> torch.Tensor:
    """int32 [E]: the end of each expert's rows in the sorted order (the
    ``offs`` of ``torch._grouped_mm``), on the device."""
    bounds = torch.arange(1, n_experts + 1, device=sorted_expert.device,
                          dtype=sorted_expert.dtype)
    return torch.searchsorted(sorted_expert, bounds, out_int32=True)


def expert_products(xs, ends, w_gate, w_up, w_down):
    """The grouped SwiGLU of the expert-sorted rows xs [T·k, D]: rows
    before ends[0] through expert 0, then up to ends[1] through expert
    1, and so on.  Returns [T·k, D]."""
    gate = torch._grouped_mm(xs, w_gate, ends)
    up = torch._grouped_mm(xs, w_up, ends)
    return torch._grouped_mm(F.silu(gate) * up, w_down, ends)


def dispatch(x, expert_ids, gates, params, cfg: MoEConfig):
    """Dropless core: sort → grouped products → combine.  x [T, D],
    expert_ids and gates [T, k]; returns [T, D] in x's type."""
    t, d = x.shape
    k = cfg.top_k
    flat = expert_ids.reshape(-1)
    sorted_expert, order = torch.sort(flat, stable=True)
    xs = x[order // k]  # the token of each (token, slot) pair, sorted
    w = [params[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down")]
    ys = expert_products(xs, group_ends(sorted_expert, cfg.n_experts), *w)
    # back to (token, slot) order through the inverse permutation, then
    # each token's k rows weighted and summed in slot order
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    ys = ys[inverse].view(t, k, d)
    return (ys * gates[..., None].to(ys.dtype)).sum(dim=1).to(x.dtype)


def aux_loss(probs, expert_ids, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load balance: E · Σ mean(prob) · (fraction routed)."""
    e, k = cfg.n_experts, cfg.top_k
    me = probs.mean(dim=0)
    experts = torch.arange(e, device=expert_ids.device)
    hits = (expert_ids[..., None] == experts).to(torch.float32).sum(dim=1)
    ce = hits.mean(dim=0) / k
    return cfg.aux_loss_weight * e * (me * ce).sum()


def _ep_compute(x, expert_ids, gates, w_gate, w_up, w_down, shard: int,
                capacity: int):
    """One expert shard's part of the output, [T, D] (the
    reference's ``_ep_compute`` before its psum).  The shard owns the
    experts [shard · E_loc, (shard + 1) · E_loc) of the local slices
    w_gate/w_up [E_loc, D, F], w_down [E_loc, F, D].  Its (token, slot)
    pairs are stably sorted first, grouped by local expert, and the
    first ``capacity`` rows are taken: pairs past capacity drop, and so
    do the other shards' pairs the capacity still reaches — those run
    through the last local expert with a zero gate, so they add exact
    zeros (and no gradient) instead of leaving rows of the grouped
    products unwritten."""
    t, d = x.shape
    k = expert_ids.shape[1]
    e_loc = w_gate.shape[0]
    local = expert_ids.reshape(-1) - shard * e_loc
    mine = (local >= 0) & (local < e_loc)
    order = torch.sort(torch.where(mine, local, e_loc + 1), stable=True)[1]
    sel = order[:capacity]
    valid = mine[sel]
    sel_e = local[sel].clamp(0, e_loc - 1)
    sel_gate = gates.reshape(-1)[sel] * valid.to(gates.dtype)
    sel_token = sel // k
    # group ends over the selected rows; the last group runs to the end
    ends = group_ends(torch.where(valid, sel_e, e_loc - 1), e_loc)
    ys = expert_products(x[sel_token], ends, w_gate, w_up, w_down)
    ys = ys * sel_gate[:, None].to(ys.dtype)
    return torch.zeros((t, d), dtype=ys.dtype,
                       device=x.device).index_add_(0, sel_token, ys)


def apply_expert_parallel(params, x: torch.Tensor, cfg: MoEConfig, mesh,
                          token_axes: tuple[str, ...],
                          ep_axis: str = "model",
                          capacity_factor: float = 2.0):
    """Expert-parallel MoE layer: x [T, D] → (out [T, D], aux).  The
    routing is the dropless layer's; the ``mesh.shape[ep_axis]`` expert
    shards each take ``capacity = max(⌊T · k / n_ep · capacity_factor⌋,
    8)`` pairs; ``token_axes`` must name one token shard.  Equal to
    ``apply`` (within the products' rounding) when no pair drops."""
    e, k = cfg.n_experts, cfg.top_k
    probs, gates, ids = route(params, x, cfg)
    n_ep = mesh.shape[ep_axis]
    if e % n_ep:
        raise ValueError(f"{e} experts do not split over {n_ep} shards")
    if math.prod(mesh.shape[a] for a in token_axes) != 1:
        raise ValueError("token shards on cards of their own need a "
                         "multi-card host mesh, which the port does not "
                         "place yet")
    capacity = max(int(x.shape[0] * k / n_ep * capacity_factor), 8)
    e_loc = e // n_ep
    w = [params[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down")]
    out = None
    for s in range(n_ep):
        part = _ep_compute(x, ids, gates,
                           *(wi[s * e_loc:(s + 1) * e_loc] for wi in w),
                           s, capacity)
        out = part if out is None else out + part
    return add_shared(params, x, out, cfg), aux_loss(probs, ids, cfg)


def add_shared(params, x: torch.Tensor, out: torch.Tensor,
               cfg: MoEConfig) -> torch.Tensor:
    """The routed experts' output ``out`` [T, D] plus the shared experts'
    MLP of x, where the config has shared experts."""
    if cfg.n_shared:
        out = out + layers.mlp_apply(params["shared"], x)
    return out


def apply(params, x: torch.Tensor, cfg: MoEConfig):
    """x [T, D] (already flattened) → (out [T, D], aux loss f32)."""
    probs, gates, ids = route(params, x, cfg)
    out = dispatch(x, ids, gates, params, cfg)
    return add_shared(params, x, out, cfg), aux_loss(probs, ids, cfg)
