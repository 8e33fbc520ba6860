"""Shared neural building blocks (the JAX package's ``models/layers.py``).

Weights are plain tensors: matrices in the compute dtype, norm weights
in float32.  ``rms_norm`` and RoPE compute in float32 and cast back, as
the reference does.  ``dense_mlp_*`` are the recsys towers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# init helpers (the reference's distributions, drawn from a torch.Generator)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, device=None) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                       device=device) * scale


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               device=None) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                       device=device) * 0.01


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in float32.  ``unit_offset=True`` uses the gemma
    convention (weights parameterized around 0, applied as 1 + w)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + weight) if unit_offset else weight
    return (x * w).to(dtype)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def _mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 0.1 · mscale · ln(factor) + 1 (1 where
    the factor does not stretch)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_rope(head_dim: int, base: float,
              scaling: dict) -> tuple[torch.Tensor, float, float]:
    """YaRN (arXiv:2309.00071) as DeepSeek-V2's ``modeling_deepseek.py``
    applies it, for a RoPE of ``head_dim`` at ``base`` and the
    configuration's ``rope_scaling`` group: (inverse frequencies
    [head_dim/2] in float64 on the host, the factor on cos and sin, the
    factor on the softmax scale).  Each frequency is blended between
    ``base``'s and it over ``factor`` by a linear ramp between the
    correction dimensions of ``beta_fast`` and ``beta_slow`` rotations in
    ``original_max_position_embeddings``; cos and sin take mscale(factor,
    mscale) / mscale(factor, mscale_all_dim), the softmax scale
    mscale(factor, mscale_all_dim)²."""
    half = head_dim // 2
    factor = float(scaling["factor"])
    orig = scaling["original_max_position_embeddings"]
    extra = float(base) ** (-torch.arange(half, dtype=torch.float64) / half)

    def correction_dim(rotations: float) -> float:
        return (head_dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(scaling.get("beta_fast", 32))), 0)
    high = min(math.ceil(correction_dim(scaling.get("beta_slow", 1))),
               head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = extra / factor * ramp + extra * (1 - ramp)
    all_dim = scaling.get("mscale_all_dim", 0)
    cos_sin = (_mscale(factor, scaling.get("mscale", 1))
               / _mscale(factor, all_dim))
    softmax = _mscale(factor, all_dim) ** 2 if all_dim else 1.0
    return inv_freq, cos_sin, softmax


def rope_table(positions: torch.Tensor, head_dim: int, base: float,
               inv_freq: torch.Tensor | None = None, mscale: float = 1.0):
    """(sin, cos) tables for positions [..., L] → [..., L, head_dim/2],
    in float32, at ``base``'s frequencies, or at ``inv_freq`` [head_dim/2]
    (float32, on the positions' device: YaRN's) with both tables times
    ``mscale``."""
    if inv_freq is None:
        half = head_dim // 2
        exps = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
        # a Python-float base: no host → device copy (which would wait
        # for the queued device work) on every call
        freqs = torch.pow(float(base), exps)
        angles = positions[..., None].to(torch.float32) * freqs
        return torch.sin(angles), torch.cos(angles)
    angles = positions[..., None].to(torch.float32) * inv_freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    if mscale != 1.0:
        sin, cos = sin * mscale, cos * mscale
    return sin, cos


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               inv_freq: torch.Tensor | None = None,
               mscale: float = 1.0) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: [B, H, L, D],
    positions: [B, L]; ``inv_freq`` and ``mscale`` as ``rope_table``."""
    sin, cos = rope_table(positions, x.shape[-1], base, inv_freq, mscale)
    sin = sin[:, None, :, :]  # [B, 1, L, D/2]
    cos = cos[:, None, :, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             device=None) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, device=device),
        "w_up": dense_init(gen, d_model, d_ff, device=device),
        "w_down": dense_init(gen, d_ff, d_model, device=device),
    }


def mlp_apply(params, x: torch.Tensor, activation: str = "silu"):
    """``params`` maps w_gate/w_up/w_down to matrices, cast to x's dtype
    at use (a no-op for weights already in it).  "gelu" is the tanh
    approximation, as ``jax.nn.gelu`` defaults to."""
    dt = x.dtype
    gate = x @ params["w_gate"].to(dt)
    up = x @ params["w_up"].to(dt)
    act = (F.gelu(gate, approximate="tanh") if activation == "gelu"
           else F.silu(gate))
    return (act * up) @ params["w_down"].to(dt)


# --------------------------------------------------------------------------
# plain MLP (recsys towers)
# --------------------------------------------------------------------------

def dense_mlp_init(gen: torch.Generator, dims: tuple[int, ...],
                   device=None) -> dict:
    """dims = (in, h1, ..., out): ``w{i}`` [dims[i], dims[i+1]] drawn as
    ``dense_init``, ``b{i}`` zeros, as the reference's tree."""
    n = len(dims) - 1
    out = {f"w{i}": dense_init(gen, dims[i], dims[i + 1], device=device)
           for i in range(n)}
    out.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=torch.float32,
                                     device=device) for i in range(n)})
    return out


def dense_mlp_apply(params: dict, x: torch.Tensor, n_layers: int,
                    final_activation: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"w{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype)
        if i + 1 < n_layers or final_activation:
            x = torch.relu(x)
    return x
