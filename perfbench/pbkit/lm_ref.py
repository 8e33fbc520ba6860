"""Building blocks of the plain language-model references: float32
PyTorch, no kernels, no cache, no batching of sequences into one
attention.  A reference runs whole sequences (prompt and served tokens)
layer by layer, each layer's weights taken to float32 once for every
sequence, and returns the logits at the positions asked for."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pbkit.linear import Linear, no_tf32


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float):
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * gain.to(torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float,
         inv: torch.Tensor | None = None):
    """Rotary embedding of x [L, H, d] at positions [L], pairs (i,
    i + d/2), at the inverse frequencies ``inv`` [d/2] (float64), by
    default ``base``'s.  The published checkpoints pair (2i, 2i + 1);
    with random weights the two are the same model under a fixed
    permutation of the rotated columns of the projections."""
    half = x.shape[-1] // 2
    if inv is None:
        inv = base ** (-torch.arange(half, dtype=torch.float64) / half)
    inv = inv.to(x.device)
    ang = (positions.to(torch.float64)[:, None] * inv[None, :])
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, head_chunk: int = 8):
    """Softmax attention of one sequence: q [L, H, dq], k [L, Hk, dq],
    v [L, Hk, dv], each query head reading kv head h // (H / Hk)."""
    n, h = q.shape[0], q.shape[1]
    group = h // k.shape[1]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    out = []
    for lo in range(0, h, head_chunk):
        hs = torch.arange(lo, min(h, lo + head_chunk), device=q.device)
        qh = q[:, hs].transpose(0, 1)                     # [h, L, dq]
        kh = k[:, hs // group].transpose(0, 1)
        vh = v[:, hs // group].transpose(0, 1)
        s = (qh @ kh.transpose(1, 2)) * scale
        s = s.masked_fill(~mask, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ vh)         # [h, L, dv]
    return torch.cat(out).transpose(0, 1)                 # [L, H, dv]


def swiglu(lin: Linear, x, w_gate, w_up, w_down):
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def moe(lin: Linear, x, router, w_gate, w_up, w_down, top_k: int,
        norm_topk: bool, scaling: float):
    """Softmax router in float32, the top ``top_k`` experts a token,
    their probabilities as gates (renormalized where ``norm_topk``),
    each expert's SwiGLU over its tokens."""
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32), -1)
    gates, ids = probs.topk(top_k, dim=-1)
    if norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * scaling
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        rows, slots = torch.nonzero(ids == e, as_tuple=True)
        y = swiglu(lin, x[rows], w_gate[e], w_up[e], w_down[e])
        out.index_add_(0, rows, y * gates[rows, slots, None])
    return out


def run(seqs: list[list[int]], wanted: list[list[int]], weights: dict,
        n_layers: int, attention_fn, mlp_fn, eps: float, fp8: bool = False,
        mlp_chunk: int = 16384) -> list[torch.Tensor]:
    """Logits [len(wanted[j]), V] (float32) of each sequence j at the
    positions ``wanted[j]``.  ``attention_fn(lin, i, x_j, positions)``
    and ``mlp_fn(lin, i, h)`` give layer i's two sublayers on its
    normalized input; ``weights`` holds ``embed``, ``ln1``, ``ln2``,
    ``final_norm`` and ``lm_head``."""
    lin = Linear(fp8)
    dev = weights["embed"].device
    with no_tf32(), torch.no_grad():
        xs = [weights["embed"][torch.tensor(s, device=dev)].to(torch.float32)
              for s in seqs]
        pos = [torch.arange(len(s), device=dev) for s in seqs]
        for i in range(n_layers):
            for j, x in enumerate(xs):
                h = rms_norm(x, weights["ln1"][i], eps)
                xs[j] = x + attention_fn(lin, i, h, pos[j])
            sizes = [x.shape[0] for x in xs]
            cat = torch.cat(xs)
            for lo in range(0, cat.shape[0], mlp_chunk):
                part = cat[lo:lo + mlp_chunk]
                h = rms_norm(part, weights["ln2"][i], eps)
                cat[lo:lo + mlp_chunk] = part + mlp_fn(lin, i, h)
            xs = list(torch.split(cat, sizes))
        out = []
        for x, w in zip(xs, wanted):
            h = rms_norm(x[torch.tensor(w, device=dev)],
                         weights["final_norm"], eps)
            out.append(lin(h, weights["lm_head"]))
        return out
