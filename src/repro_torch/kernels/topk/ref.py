"""Plain PyTorch version of the streaming top-k kernel (``csrc/topk.cu``).

A stable descending sort of the whole vector, then the first k — the
(score desc, id asc) order.  Like the kernel (and the JAX package's
kernel, whose carry starts from (-inf, sentinel) slots), a slot that
holds -inf carries the sentinel id 2³¹−1 rather than the id of a -inf
entry; the JAX package's ``top_k_ref`` oracle gives the entry's id there.
"""
from __future__ import annotations

import torch

ID_SENTINEL = 2**31 - 1


def top_k_ref(scores: torch.Tensor, k: int):
    """(values [k] f32, ids [k] int32) of a [N] score vector."""
    vals, order = torch.sort(scores.to(torch.float32), descending=True,
                             stable=True)
    vals, ids = vals[:k], order[:k].to(torch.int32)
    return vals, ids.masked_fill(torch.isneginf(vals), ID_SENTINEL)
