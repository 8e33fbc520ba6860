"""Attention math: the hand-written kernel, the plain blockwise paths,
and decode (the JAX package's ``models/attention.py``).

Two execution strategies for prefill and forward, one semantics (tested
against each other and against the JAX package):

- ``backend="kernel"``: the CUDA flash-attention kernel
  (kernels/flash_attention) — the counterpart of the reference's
  ``"pallas"``; on CPU tensors its wrapper runs the dense plain version.
- ``backend="blockwise"``: the counterpart of the reference's ``"xla"``
  — online-softmax attention as a loop over kv blocks (no L×L score
  matrix), and for sliding-window layers the *banded* chunked form
  (query chunk i attends key chunks {i-1, i}), O(L·2w) instead of O(L²).
- ``backend="auto"``: ``"kernel"`` on CUDA tensors, ``"blockwise"`` on
  the CPU.

GQA is computed in grouped form — queries reshaped to [B, Hkv, G, ...]
against un-repeated KV.  The plain paths take bf16 operands to float32
before each product, which is what the reference's bf16 einsums with a
float32 result compute, and round p to the value dtype before P·V, as
the reference does.

Decode (one new token against a KV cache) here is plain PyTorch, as the
reference computes it outside any Pallas kernel: the decode step's
plain path and ``kernels/decode_attention``'s plain version.  Where that
kernel has a design, the decode step takes it instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

MASK_VALUE = -1e30
BACKENDS = ("auto", "kernel", "blockwise")


def _softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, L, D] → [B, Hkv, G, L, D]."""
    b, hq, l, d = q.shape
    return q.reshape(b, hkv, hq // hkv, l, d)


def _ungroup(o: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, L, D] → [B, Hq, L, D]."""
    b, hkv, g, l, d = o.shape
    return o.reshape(b, hkv * g, l, d)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# --------------------------------------------------------------------------
# blockwise flash attention (loop over kv blocks)
# --------------------------------------------------------------------------

def flash_attention_blockwise(
    q: torch.Tensor,  # [B, Hq, Lq, D]
    k: torch.Tensor,  # [B, Hkv, Lk, D]
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    block_k: int = 1024,
) -> torch.Tensor:
    b, hq, lq, _ = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    block_k = max(1, min(block_k, lk))
    dev = q.device

    qf = _f32(_group_q(q, hkv))  # [B, Hkv, G, Lq, D]
    q_pos = q_offset + torch.arange(lq, device=dev)
    m = torch.full((b, hkv, g, lq, 1), MASK_VALUE, device=dev)
    l = torch.zeros((b, hkv, g, lq, 1), device=dev)
    acc = torch.zeros((b, hkv, g, lq, dv), device=dev)
    for start in range(0, lk, block_k):
        kblk = _f32(k[:, :, None, start:start + block_k])  # [B,Hkv,1,bk,D]
        vblk = v[:, :, None, start:start + block_k]
        s = (qf @ kblk.transpose(-1, -2)) * scale
        s = _softcap(s, softcap)
        k_pos = start + torch.arange(kblk.shape[3], device=dev)
        mask = (k_pos < lk)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next) * mask
        alpha = torch.exp(m - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _f32(p.to(v.dtype)) @ _f32(vblk)
        m = m_next
    out = acc / torch.where(l == 0.0, 1.0, l)
    return _ungroup(out).to(q.dtype)


# --------------------------------------------------------------------------
# banded (sliding-window) attention: O(L · 2w) instead of O(L²)
# --------------------------------------------------------------------------

def local_attention(
    q: torch.Tensor,  # [B, Hq, L, D]
    k: torch.Tensor,  # [B, Hkv, L, D]
    v: torch.Tensor,
    *,
    scale: float,
    window: int,
    softcap: float | None = None,
) -> torch.Tensor:
    """Causal sliding-window attention via chunked band products.

    Chunk size = window; query chunk i attends key chunks {i-1, i}.
    Exact for the mask 0 <= q_pos - k_pos < window.
    """
    b, hq, l, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    w = window
    pad = (-l) % w
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    lp = q.shape[2]
    nb = lp // w
    dev = q.device
    qb = _group_q(q, hkv).reshape(b, hkv, g, nb, w, d)
    kb = k.reshape(b, hkv, nb, w, d)
    vb = v.reshape(b, hkv, nb, w, d)
    # previous chunk (zeros before chunk 0)
    kprev = F.pad(kb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    vprev = F.pad(vb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    kext = torch.cat([kprev, kb], dim=3)  # [B, Hkv, nb, 2w, D]
    vext = torch.cat([vprev, vb], dim=3)

    s = (_f32(qb) @ _f32(kext)[:, :, None].transpose(-1, -2)) * scale
    s = _softcap(s, softcap)  # [B, Hkv, G, nb, w, 2w]

    a = torch.arange(w, device=dev)[:, None]  # in-chunk q offset
    bcol = torch.arange(2 * w, device=dev)[None, :]  # extended k offset
    delta = a + w - bcol  # q_pos - k_pos
    mask = (delta >= 0) & (delta < w)
    chunk = torch.arange(nb, device=dev)[:, None, None]
    k_pos = chunk * w + (bcol[None] - w)  # absolute key position
    mask = mask[None] & (k_pos >= 0) & (k_pos < l)  # [nb, w, 2w]
    s = torch.where(mask, s, MASK_VALUE)

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    lsum = p.sum(dim=-1, keepdim=True)
    o = _f32(p.to(vext.dtype)) @ _f32(vext)[:, :, None]
    o = o / torch.where(lsum == 0.0, 1.0, lsum)
    o = o.reshape(b, hkv, g, lp, d)[:, :, :, :l]
    return _ungroup(o).to(q.dtype)


# --------------------------------------------------------------------------
# unified entry point
# --------------------------------------------------------------------------

def resolve_backend(backend: str, device) -> str:
    """``"auto"`` → ``"kernel"`` on a CUDA device, ``"blockwise"``
    elsewhere (the engine's ``scoring_path="auto"`` rule)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" \
            else "blockwise"
    return backend


def attention(
    q, k, v, *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    backend: str = "auto",
):
    if resolve_backend(backend, q.device) == "kernel":
        return fa_ops.flash_attention(
            q, k, v, scale=scale, causal=causal, window=window,
            softcap=softcap, q_offset=q_offset,
        )
    if window is not None and causal and q_offset == 0 \
            and q.shape[2] == k.shape[2] and q.shape[2] > window:
        return local_attention(q, k, v, scale=scale, window=window,
                               softcap=softcap)
    return flash_attention_blockwise(
        q, k, v, scale=scale, causal=causal, window=window,
        softcap=softcap, q_offset=q_offset,
    )


# --------------------------------------------------------------------------
# decode attention (one query token against a KV cache)
# --------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,  # [B, Hq, 1, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    length,  # current cache fill (int or [B] tensor)
    *,
    scale: float,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Memory-bound decode attention (the query position is length-1)."""
    b = q.shape[0]
    s_max = k_cache.shape[2]
    dev = q.device
    if isinstance(length, int):
        length = torch.full((b,), length, dtype=torch.int32, device=dev)
    k_pos = torch.arange(s_max, device=dev)
    q_pos = (length - 1)[:, None]  # [B, 1]
    mask = k_pos[None, :] < length[:, None]
    if window is not None:
        mask = mask & ((q_pos - k_pos[None, :]) < window)
    return masked_decode_attention(q, k_cache, v_cache, mask, scale=scale,
                                   softcap=softcap)


def masked_decode_attention(
    q: torch.Tensor,  # [B, Hq, 1, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    mask: torch.Tensor,  # [B, S] bool — slot validity
    *,
    scale: float,
    softcap: float | None = None,
) -> torch.Tensor:
    hkv = k_cache.shape[1]
    qg = _f32(_group_q(q, hkv))  # [B, Hkv, G, 1, D]
    s = (qg @ _f32(k_cache)[:, :, None].transpose(-1, -2)) * scale
    s = _softcap(s, softcap)
    mb = mask[:, None, None, None, :]
    s = torch.where(mb, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mb
    l = p.sum(dim=-1, keepdim=True)
    o = _f32(p.to(v_cache.dtype)) @ _f32(v_cache)[:, :, None]
    o = o / torch.where(l == 0.0, 1.0, l)
    return _ungroup(o).to(q.dtype)
