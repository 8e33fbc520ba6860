"""Plain PyTorch versions of the HSF kernels (paper §4).

``hsf_score_ref`` is the single-query kernel's function (``csrc/
hsf_score.cu``): one f32 matvec plus the containment test.
``hsf_score_topk_ref`` is the fused top-k kernel's (``csrc/
hsf_topk.cu``): full [B, N] scores, then a stable sort — the expensive
way the kernel avoids.  Both mirror the JAX package's ``ref.py``.  CPU
tensors use them, and so do the tests; the wrappers never take them for
a CUDA tensor when the shape fits the kernel.
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


def hsf_score_ref(doc_vecs, doc_sigs, query_vec, query_sig,
                  alpha: float, beta: float) -> torch.Tensor:
    """α·(docs @ q) + β·containment — float32 [N].  Docs and query are
    widened to f32 first, so a bf16 input is summed in f32, as the
    kernel does."""
    cos = torch.mv(doc_vecs.to(torch.float32), query_vec.to(torch.float32))
    ind = containment_matrix(doc_sigs, query_sig[None, :])[0]
    return alpha * cos + beta * ind


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
