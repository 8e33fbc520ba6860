"""The matrix product of the plain references: float32 with TF32 off,
or, for the control, each operand rounded to fp8 (e4m3, scaled per row
of the activations and per output column of the weights) first — the
precision below the bfloat16 that the configurations state."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``
    (the amax maps to the largest finite value), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    """``lin(x, w)`` = x @ w for x [..., K] and w [K, N]."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        w = w.to(torch.float32)
        if self.fp8:
            x = fp8_round(x, -1)
            w = fp8_round(w, -2)
        return x @ w


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 on the card (TF32 off) inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
