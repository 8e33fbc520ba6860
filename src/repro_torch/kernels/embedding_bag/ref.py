"""Plain PyTorch version of the EmbeddingBag kernel
(``csrc/embedding_bag.cu``): gather the rows, weight them, and add them
into float32 zeros by bag — ``index_select`` then ``index_add_``.

Segments need no order and bags with no index stay zero.  ``mean``
divides each bag by max(count, 1); the result is cast to the table's
dtype, as the JAX package's wrapper does.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      segment_ids: torch.Tensor, n_bags: int,
                      weights: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """out[b] = Σ_{seg[i]==b} w[i] · table[idx[i]], [n_bags, E]."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    seg = segment_ids.to(torch.int64)
    rows = torch.index_select(table, 0, indices.to(torch.int64)
                              ).to(torch.float32)
    if weights is not None:
        rows = rows * weights.to(torch.float32)[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device).index_add_(0, seg, rows)
    if mode == "mean":
        counts = torch.zeros((n_bags,), dtype=torch.float32,
                             device=table.device)
        counts.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))
        out = out / counts.clamp_min(1.0)[:, None]
    return out.to(table.dtype)
