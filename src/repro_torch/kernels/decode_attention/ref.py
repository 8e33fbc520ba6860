"""The decode attention core's plain version: what the port's decode
step computed in PyTorch after the q/k/v projections, and what the
kernel (``csrc/decode_attention.cu``) is held to.

One token a row: qk-norm and split-half RoPE at position length - 1 (in
float32, rounded to the heads' dtype, as ``layers.rms_norm`` and
``layers.apply_rope`` do), the new k and v written into slot
(length - 1) % S of the cache in place, then ``attention.decode_attention``
over the slots below the fill.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers


def rotate(x: torch.Tensor, gain: torch.Tensor | None, positions,
           base: float) -> torch.Tensor:
    """x [B, H, L, Dh] normalised per head (the gain applied as 1 + w;
    none where ``gain`` is None) and rotated at ``positions`` [B, L]."""
    if gain is not None:
        x = layers.rms_norm(x, gain, unit_offset=True)
    return layers.apply_rope(x, positions, base)


def append(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new, v_new,
           lengths: torch.Tensor) -> None:
    """k_new, v_new [B, H, 1, Dh] into slot (length - 1) % S of each
    row's cache [B, H, S, Dh], in place."""
    n_slots = k_cache.shape[2]
    slot = ((lengths - 1) % n_slots).to(torch.int64)  # [B]
    b_idx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[b_idx, :, slot, :] = k_new[:, :, 0, :].to(k_cache.dtype)
    v_cache[b_idx, :, slot, :] = v_new[:, :, 0, :].to(v_cache.dtype)


def decode_attention_ref(q, k_new, v_new, k_cache, v_cache, lengths, *,
                         scale: float, rope_base: float, q_norm=None,
                         k_norm=None) -> torch.Tensor:
    """[B, Hq, 1, Dh] in q's dtype: the projections' q [B, Hq, 1, Dh],
    k_new and v_new [B, Hkv, 1, Dh] against the linear cache [B, Hkv, S,
    Dh], which gets the new slot; lengths [B] is the fill including this
    token."""
    positions = (lengths - 1)[:, None].to(torch.int64)  # [B, 1]
    q = rotate(q, q_norm, positions, rope_base)
    k_new = rotate(k_new, k_norm, positions, rope_base)
    append(k_cache, v_cache, k_new, v_new, lengths)
    return attn.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
