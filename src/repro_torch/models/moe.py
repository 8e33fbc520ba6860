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

The reference's multi-device forms (``sharding_ctx``, the expert-
parallel ``apply_expert_parallel``) serve its token-sharded training
mesh; they come with the port's training substrate (ROADMAP Queue 1
item 10) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_MULTI_DEVICE = ("the expert-parallel and sharded MoE forms serve the "
                 "token-sharded training mesh; they come with the training "
                 "substrate of the PyTorch port (ROADMAP Queue 1 item 10)")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    norm_topk: bool = True
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.001


def sharding_ctx(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


def apply_expert_parallel(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


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


def apply(params, x: torch.Tensor, cfg: MoEConfig):
    """x [T, D] (already flattened) → (out [T, D], aux loss f32)."""
    probs, gates, ids = route(params, x, cfg)
    out = dispatch(x, ids, gates, params, cfg)
    if cfg.n_shared:
        out = out + layers.mlp_apply(params["shared"], x)
    return out, aux_loss(probs, ids, cfg)
