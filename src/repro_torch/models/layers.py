"""Shared neural building blocks (the JAX package's ``models/layers.py``).

Weights are plain tensors: matrices in the compute dtype, norm weights
in float32.  ``rms_norm`` and RoPE compute in float32 and cast back, as
the reference does.  ``dense_mlp_*`` are the recsys towers.
"""
from __future__ import annotations

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

def rope_table(positions: torch.Tensor, head_dim: int, base: float):
    """(sin, cos) tables for positions [..., L] → [..., L, head_dim/2],
    in float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python-float base: no host → device copy (which would wait for
    # the queued device work) on every call
    freqs = torch.pow(float(base), exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: [B, H, L, D],
    positions: [B, L]."""
    sin, cos = rope_table(positions, x.shape[-1], base)
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
