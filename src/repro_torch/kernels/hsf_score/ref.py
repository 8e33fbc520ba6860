"""Plain PyTorch version of the fused HSF top-k kernel (paper §4).

Full [B, N] scores, then a stable sort — the expensive way the kernel
avoids, and the function it must equal.  Mirrors the JAX package's
``hsf_score_topk_ref``.  CPU tensors use it, and so do the tests; the
wrapper never takes it for a CUDA tensor when k fits the kernel.
"""
from __future__ import annotations

import torch


def containment_matrix(doc_sigs: torch.Tensor,
                       query_sigs: torch.Tensor) -> torch.Tensor:
    """Bloom containment, float32 [B, N]: 1 where every bit of the query
    signature is set in the doc's.  Folded word by word (as the TPU
    kernel does) so no [B, N, W] intermediate exists; int32 bitwise ops
    compare bit patterns, sign bit included."""
    b, n = query_sigs.shape[0], doc_sigs.shape[0]
    ok = torch.ones((b, n), dtype=torch.bool, device=doc_sigs.device)
    for wi in range(query_sigs.shape[1]):
        qw = query_sigs[:, wi, None]                     # [B, 1]
        ok &= (doc_sigs[None, :, wi] & qw) == qw         # [B, N]
    return ok.to(torch.float32)


def hsf_score_matrix(doc_vecs, doc_sigs, query_vecs, query_sigs,
                     alpha: float, beta: float) -> torch.Tensor:
    """α·(q @ docsᵀ) + β·containment — float32 [B, N] (a full-precision
    gemm; not bit-stable across batch sizes)."""
    cos = query_vecs.to(torch.float32) @ doc_vecs.to(torch.float32).T
    return alpha * cos + beta * containment_matrix(doc_sigs, query_sigs)


def hsf_score_topk_ref(doc_vecs, doc_sigs, query_vecs, query_sigs,
                       alpha: float, beta: float, k: int, n_valid=None):
    """(vals [B, k] f32, ids [B, k] int32) ordered (score desc, id asc);
    rows ``>= n_valid`` score -inf.  Ids of -inf slots are whatever the
    sort leaves there — the wrapper maps them to the sentinel."""
    scores = hsf_score_matrix(doc_vecs, doc_sigs, query_vecs, query_sigs,
                              alpha, beta)
    if n_valid is not None:
        ids = torch.arange(scores.shape[1], device=scores.device)
        scores = scores.masked_fill(ids[None, :] >= n_valid, float("-inf"))
    vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], order[:, :k].to(torch.int32)
