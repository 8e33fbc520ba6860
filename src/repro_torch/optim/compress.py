"""Error-feedback int8 gradient compression (the JAX package's
``optim/compress.py``; 1-bit-Adam lineage).

Quantizing an all-reduce's payload to int8 with per-leaf scales cuts
its bytes 4× (f32) / 2× (bf16); error feedback adds step t's residual
back at step t+1, so the accumulated update converges to the
uncompressed one.

- ``quantize``/``dequantize`` + ``ef_roundtrip``: the optimizer-level
  transform (the wire format, simulated);
- ``compressed_psum``: the reference's int8 all-reduce inside a
  ``shard_map``.  The port runs one process with no collective, so it
  takes the shards' trees as a sequence (logical shards) and returns the
  tree every shard would hold after the reference's collective.
"""
from __future__ import annotations

import torch

from repro_torch.optim import tree as tree_lib


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0,
                       torch.ones_like(amax)).to(torch.float32)


def _grid(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x on the int8 grid of ``scale``: round half to even, clipped to
    ±127, as float32."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q int8, scale f32)."""
    scale = _scale(torch.max(torch.abs(x)))
    return _grid(x, scale).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_roundtrip(grads, error_state):
    """Quantize-dequantize each leaf with error feedback.

    Returns (compressed-equivalent grads, new error state).  error_state
    is a tree of f32 residuals matching grads (init = zeros).
    """
    def leaf(g, e):
        y = g.to(torch.float32) + e
        q, s = quantize(y)
        deq = dequantize(q, s)
        return deq.to(g.dtype), y - deq

    out = tree_lib.map_(leaf, grads, error_state)
    return (tree_lib.map_(lambda _, o: o[0], grads, out),
            tree_lib.map_(lambda _, o: o[1], grads, out))


def compressed_psum(shard_trees):
    """The int8 all-reduce over the logical shards ``shard_trees`` (one
    tree each, all of one structure).  Per leaf: (1) one GLOBAL scale
    from the largest magnitude over every shard (per-shard scales cannot
    be unmixed after the sum); (2) each shard quantized with it and the
    int8 grid values summed as int32 (127·n_shards overflows int8).
    Returns the tree every shard holds afterwards: the mean of the
    shards' leaves within half a quantization step, in each leaf's
    dtype."""
    n = len(shard_trees)

    def leaf(*gs):
        scale = _scale(torch.stack([torch.max(torch.abs(g)) for g in gs])
                       .max())
        q_sum = sum(_grid(g, scale).to(torch.int32) for g in gs)
        return (q_sum.to(torch.float32) * scale / n).to(gs[0].dtype)

    return tree_lib.map_(leaf, *shard_trees)
