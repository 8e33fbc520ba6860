"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; the JAX
package's ``models/mla.py``).

KV compression: x → c_kv (kv_lora_rank) + a decoupled shared RoPE key
(rope_dim).  The cache holds only ``{"c_kv": [B, S, R], "k_rope": [B, 1,
S, rope]}``: (512 + 64) values per token instead of 2·H·128 = 4,096.

Two execution paths:
- ``apply`` (forward/prefill): up-project c_kv to per-head K/V and run
  ordinary causal attention.  Its q/k heads are nope + rope wide (192 at
  FULL) and its v heads v_head_dim (128).  Where the flash kernel has a
  design for (dtype, q/k width, v width) — bf16 192/128, FULL's serving
  heads — the heads go to attention as they are.  Elsewhere (f32, whose
  design takes equal widths only, and SMOKE's 24/16) q, k and v are
  zero-padded to the smallest head size the kernel has that holds both
  (256 at FULL, 32 at SMOKE), attention runs with the scale of the
  unpadded heads, and the output is cut back to v's width.  The padding
  is exact: zero columns add nothing to q·k, and the padded v columns
  are dropped.  The rule reads only the dtype and the widths, on every
  backend, so the CPU runs the same code the card does; it never
  depends on a failure at run time.
- ``decode_absorbed``: the up-projections are absorbed into the query
  and output (q_nope·W_uk → a query in latent space; attn·W_uv → the
  output), so a step reads only the compressed cache.  The scores and
  the p·c_kv product are accumulated and kept in float32, as the
  reference's ``preferred_element_type`` does.

Both paths rotate q and the shared RoPE key at ``rope_base``, or, where
the model's configuration asks for YaRN, at the inverse frequencies
``inv_freq`` with cos and sin times ``rope_mscale``
(``layers.yarn_rope``); ``scale`` is then the softmax scale times
YaRN's mscale² (``LMConfig.attn_scale``).  Each layer call counts its
route in ``counts`` (``prefill_unpadded``, ``prefill_padded``,
``decode_absorbed``), registered with ``kernels/counters`` so that a
replayed CUDA graph counts the calls it captured.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import counters
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import layers

_counts_lock = threading.Lock()
# layer calls by route: the prefill's heads as they are (a flash design
# takes them) or zero-padded, and the absorbed decode step
counts = {"prefill_unpadded": 0, "prefill_padded": 0, "decode_absorbed": 0}
counters.register("mla", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int | None = None  # V2-Lite: queries uncompressed

    @property
    def qk_head_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim

    @property
    def scale(self) -> float:
        return self.qk_head_dim ** -0.5


def init(gen: torch.Generator, cfg: MLAConfig, d_model: int, n_heads: int,
         device=None) -> dict:
    """The reference's distributions (normal × d_in^-1/2 matrices, zero
    norm), float32."""
    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, device=device)

    r = cfg.kv_lora_rank
    return {
        "w_q": dense(d_model, n_heads * cfg.qk_head_dim),
        "w_dkv": dense(d_model, r),
        "w_kr": dense(d_model, cfg.rope_head_dim),
        "kv_norm": torch.zeros((r,), dtype=torch.float32, device=device),
        "w_uk": dense(r, n_heads * cfg.nope_head_dim),
        "w_uv": dense(r, n_heads * cfg.v_head_dim),
        "w_o": dense(n_heads * cfg.v_head_dim, d_model),
    }


def _project_q(params, x, cfg: MLAConfig, n_heads: int, positions,
               rope_base, inv_freq=None, rope_mscale: float = 1.0):
    b, l, _ = x.shape
    q = (x @ params["w_q"].to(x.dtype)).view(b, l, n_heads,
                                             cfg.qk_head_dim)
    q = q.transpose(1, 2)  # [B, H, L, qdim]
    q_nope = q[..., :cfg.nope_head_dim]
    q_rope = layers.apply_rope(q[..., cfg.nope_head_dim:], positions,
                               rope_base, inv_freq, rope_mscale)
    return q_nope, q_rope


def compress_kv(params, x, cfg: MLAConfig, positions, rope_base,
                inv_freq=None, rope_mscale: float = 1.0):
    """x → (c_kv [B, L, R] normalized, k_rope [B, 1, L, rope_dim])."""
    c_kv = layers.rms_norm(x @ params["w_dkv"].to(x.dtype),
                           params["kv_norm"].to(torch.float32) + 1.0)
    k_rope = (x @ params["w_kr"].to(x.dtype))[:, None]  # one shared head
    return c_kv, layers.apply_rope(k_rope, positions, rope_base, inv_freq,
                                   rope_mscale)


def padded_head_dim(cfg: MLAConfig, dtype: torch.dtype) -> int | None:
    """The head size the prefill gives attention: None (the heads as
    they are) where the flash kernel has a design for (dtype, q/k width,
    v width), else its smallest equal head size holding both."""
    if fa_ops.has_design(dtype, cfg.qk_head_dim, cfg.v_head_dim):
        return None
    need = max(cfg.qk_head_dim, cfg.v_head_dim)
    return next(d for d in fa_ops.HEAD_DIMS if d >= need)


def padded_attention(q, k, v, *, scale: float, head_dim: int | None,
                     backend: str = "auto"):
    """Causal attention of q, k [B, H, L, Dqk] and v [B, H, L, Dv] with
    every head zero-padded to ``head_dim`` (none when it is None);
    returns [B, H, L, Dv]."""
    if head_dim is None:
        return attn.attention(q, k, v, scale=scale, causal=True,
                              backend=backend)

    def pad(t):
        return F.pad(t, (0, head_dim - t.shape[-1]))

    o = attn.attention(pad(q), pad(k), pad(v), scale=scale, causal=True,
                       backend=backend)
    return o[..., :v.shape[-1]]


def apply(params, x, cfg: MLAConfig, n_heads: int, positions,
          rope_base: float, backend: str = "auto", *,
          scale: float | None = None, inv_freq=None,
          rope_mscale: float = 1.0):
    """Forward/prefill path.  Returns (out [B, L, D], (c_kv, k_rope)).
    ``scale`` defaults to ``cfg.scale``; ``inv_freq`` and ``rope_mscale``
    are YaRN's (module docstring)."""
    b, l, _ = x.shape
    h = n_heads
    rope = (rope_base, inv_freq, rope_mscale)
    q_nope, q_rope = _project_q(params, x, cfg, h, positions, *rope)
    c_kv, k_rope = compress_kv(params, x, cfg, positions, *rope)
    k_nope = (c_kv @ params["w_uk"].to(x.dtype)) \
        .view(b, l, h, cfg.nope_head_dim).transpose(1, 2)
    v = (c_kv @ params["w_uv"].to(x.dtype)) \
        .view(b, l, h, cfg.v_head_dim).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, l, cfg.rope_head_dim)],
                  dim=-1)
    head_dim = padded_head_dim(cfg, q.dtype)
    counters.bump("mla", "prefill_unpadded" if head_dim is None
                  else "prefill_padded")
    o = padded_attention(q, k, v,
                         scale=cfg.scale if scale is None else scale,
                         head_dim=head_dim, backend=backend)
    o = o.transpose(1, 2).reshape(b, l, h * cfg.v_head_dim)
    return o @ params["w_o"].to(x.dtype), (c_kv, k_rope)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P] accumulated and returned in float32 (the
    reference's ``preferred_element_type``): bf16 operands go to cuBLAS
    as they are on the card; elsewhere they are taken to float32, which
    is exact."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def decode_absorbed(params, x, cfg: MLAConfig, n_heads: int,
                    c_kv_cache: torch.Tensor,  # [B, S, R]
                    k_rope_cache: torch.Tensor,  # [B, 1, S, rope_dim]
                    length,  # [B] current fill AFTER inserting this token
                    positions,  # [B, 1] position of the new token
                    rope_base: float, *, scale: float | None = None,
                    inv_freq=None, rope_mscale: float = 1.0):
    """Absorbed decode of one token against the compressed cache, whose
    slot length - 1 it writes in place.  Returns (out [B, 1, D],
    (c_kv_cache, k_rope_cache)).  ``scale``, ``inv_freq`` and
    ``rope_mscale`` as ``apply``."""
    b = x.shape[0]
    h, r = n_heads, cfg.kv_lora_rank
    counters.bump("mla", "decode_absorbed")
    rope = (rope_base, inv_freq, rope_mscale)
    q_nope, q_rope = _project_q(params, x, cfg, h, positions, *rope)
    c_new, kr_new = compress_kv(params, x, cfg, positions, *rope)
    idx = (length - 1).to(torch.int64)
    b_idx = torch.arange(b, device=x.device)
    c_kv_cache[b_idx, idx, :] = c_new[:, 0, :].to(c_kv_cache.dtype)
    k_rope_cache[b_idx, :, idx, :] = kr_new[:, :, 0, :].to(k_rope_cache.dtype)
    s_max = c_kv_cache.shape[1]

    # absorb W_uk into the query: q_c[b,h,r] = q_nope[b,h,d] · W_uk[r, h*d]
    w_uk = params["w_uk"].view(r, h, cfg.nope_head_dim)
    q_c = torch.einsum("bhqd,rhd->bhqr", q_nope, w_uk)  # [B, H, 1, R]
    s_c = _f32_product(q_c.reshape(b, h, r), c_kv_cache.transpose(1, 2))
    s_r = _f32_product(q_rope.reshape(b, h, cfg.rope_head_dim),
                       k_rope_cache[:, 0].transpose(1, 2))
    scale = cfg.scale if scale is None else scale
    s = ((s_c + s_r) * scale)[:, :, None, :]  # [B, H, 1, S]
    mask = (torch.arange(s_max, device=x.device)[None, :]
            < length[:, None])[:, None, None, :]
    s = torch.where(mask, s, attn.MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    attn_c = _f32_product(p.to(c_kv_cache.dtype).reshape(b, h, s_max),
                          c_kv_cache).view(b, h, 1, r)
    attn_c = attn_c / torch.where(l == 0.0, 1.0, l)  # [B, H, 1, R]

    # absorb W_uv into the output projection
    w_uv = params["w_uv"].view(r, h, cfg.v_head_dim)
    o = torch.einsum("bhqr,rhd->bhqd", attn_c.to(x.dtype), w_uv)
    o = o.transpose(1, 2).reshape(b, 1, h * cfg.v_head_dim)
    return o @ params["w_o"].to(x.dtype), (c_kv_cache, k_rope_cache)
