"""Plain PyTorch version of the flash attention kernel: dense, in f32.

A port of the JAX package's ``attention_ref`` with the kernel's
``kv_len`` padding mask added.  Semantics (shared with the kernel):

- GQA: q heads grouped onto kv heads (Hq % Hkv == 0), head h reads kv
  head h // (Hq / Hkv);
- causal mask; optional sliding window (attend iff q_pos - k_pos <
  window), positions q_pos = q_offset + row;
- optional logit softcap ``cap · tanh(s / cap)``, after the scale and
  before the mask;
- keys at or past ``kv_len`` are masked;
- rows with no attendable key return zeros.

CPU tensors use it, and so do the tests; the wrapper never takes it for
a CUDA tensor.  ``attention_base2_tiles`` emulates the wgmma kernel's
per-tile online softmax in base 2, for the tests.
"""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30
LOG2E = math.log2(math.e)


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Lq, Dh]
    k: torch.Tensor,  # [B, Hkv, Lk, Dh]
    v: torch.Tensor,  # [B, Hkv, Lk, Dh]
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    lq = q.shape[2]
    hkv, lk = k.shape[1], k.shape[2]
    group = q.shape[1] // hkv
    kr = k.repeat_interleave(group, dim=1).to(torch.float32)
    vr = v.repeat_interleave(group, dim=1).to(torch.float32)

    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    q_pos = q_offset + torch.arange(lq, device=q.device)[:, None]
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = k_pos < (lk if kv_len is None else kv_len)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask, s, MASK_VALUE)

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def attention_base2_tiles(
    q: torch.Tensor,  # [B, Hq, Lq, Dh]
    k: torch.Tensor,  # [B, Hkv, Lk, Dh]
    v: torch.Tensor,  # [B, Hkv, Lk, Dh]
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
    block_k: int = 64,
) -> torch.Tensor:
    """The kernel's online softmax over key tiles of ``block_k``, in f32:
    logits times log2 e (``softcap·log2e · tanh(s·scale/softcap)`` with a
    softcap), masked ones set to -1e30, then per tile m' = max(m, row
    max), α = 2^(m − m'), p = 2^(x − m')·mask, l = α·l + Σp, o = α·o +
    p·v; o / l at the end, 0 where l = 0 (a row with no key)."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1).to(torch.float32)
    vr = v.repeat_interleave(group, dim=1).to(torch.float32)
    qf = q.to(torch.float32)
    limit = lk if kv_len is None else kv_len
    q_pos = q_offset + torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hq, lq, 1), MASK_VALUE, device=q.device)
    l = torch.zeros((b, hq, lq, 1), device=q.device)
    o = torch.zeros((b, hq, lq, dh), device=q.device)
    for k0 in range(0, lk, block_k):
        kt, vt = kr[:, :, k0:k0 + block_k], vr[:, :, k0:k0 + block_k]
        dots = torch.einsum("bhqd,bhkd->bhqk", qf, kt)
        if softcap is not None:
            x = (softcap * LOG2E) * torch.tanh(dots * (scale / softcap))
        else:
            x = dots * (scale * LOG2E)
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        mask = k_pos < limit
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        x = torch.where(mask, x, MASK_VALUE)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new) * mask
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        o = alpha * o + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)
