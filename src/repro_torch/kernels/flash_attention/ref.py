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
a CUDA tensor.
"""
from __future__ import annotations

import torch

MASK_VALUE = -1e30


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
