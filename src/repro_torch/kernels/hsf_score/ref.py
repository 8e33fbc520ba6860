"""Plain PyTorch versions of the HSF kernels (paper §4).

``hsf_score_ref`` is the single-query kernel's function (``csrc/
hsf_score.cu``): one f32 matvec plus the containment test.
``hsf_score_topk_ref`` is the fused top-k kernel's (``csrc/
hsf_topk.cu``): full [B, N] scores, then a stable sort — the expensive
way the kernel avoids.  Like the kernel (one fixed K order), it gives a
query the same bits at any batch size: each query's scores come from
its own pinned-order reduction (``hsf_score_rows``), not from one
[B, D] × [D, N] gemm, whose bits depend on B.  ``hsf_score_3xtf32``
emulates the kernel's arithmetic for the products: the 3xTF32 split
that puts them on the tensor cores.  Both mirror the JAX package's
``ref.py``.  CPU tensors use them, and so do the tests; the wrappers
never take them for a CUDA tensor when the shape fits the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk.ref import nan_first_order


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


def hsf_score_rows(doc_vecs, doc_sigs, query_vecs, query_sigs,
                   alpha: float, beta: float) -> torch.Tensor:
    """α·cos + β·containment — float32 [B, N], each cosine by the
    pinned-order ``stable_rowdot`` (elementwise products, then a
    pairwise add tree; ``batched_rowdot``): a query's row is a function
    of that query alone, the same bits at any B."""
    from repro_torch.core.hsf import batched_rowdot

    cos = batched_rowdot(doc_vecs, query_vecs)
    return alpha * cos + beta * containment_matrix(doc_sigs, query_sigs)


def hsf_score_topk_ref(doc_vecs, doc_sigs, query_vecs, query_sigs,
                       alpha: float, beta: float, k: int, n_valid=None):
    """(vals [B, k] f32, ids [B, k] int32) ordered (score desc, id asc),
    NaNs first in id order; rows ``>= n_valid`` score -inf.  Ids of
    -inf slots are whatever the sort leaves there — the wrapper maps
    them to the sentinel.  A query's results do not depend on the other
    queries of the batch (``hsf_score_rows``)."""
    scores = hsf_score_rows(doc_vecs, doc_sigs, query_vecs, query_sigs,
                            alpha, beta)
    if n_valid is not None:
        ids = torch.arange(scores.shape[1], device=scores.device)
        scores = scores.masked_fill(ids[None, :] >= n_valid, float("-inf"))
    order = nan_first_order(scores, dim=1)[:, :k]
    return torch.gather(scores, 1, order), order.to(torch.int32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (10 explicit mantissa bits), rounded to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of the 13
    dropped bits to the magnitude, then clear them.  Bit operations on
    the int32 view; the result is f32 with its low 13 bits 0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x − hi): x ≈ hi + lo to
    about 2⁻²² relative."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(torch.float32) - hi)


def hsf_score_3xtf32(doc_vecs, doc_sigs, query_vecs, query_sigs,
                     alpha: float, beta: float) -> torch.Tensor:
    """α·(q @ docsᵀ) + β·containment — float32 [B, N] — with the
    products as the fused kernel forms them: hi·hi + hi_doc·lo_q +
    lo_doc·hi_q of the TF32 halves, each product exact (TF32 × TF32 fits
    f32) and summed in f32; the lo·lo term is dropped.  The kernel sums
    in another (fixed) order, so the two agree to f32 rounding, not to
    the bit."""
    qh, ql = tf32_split(query_vecs)
    dh, dl = tf32_split(doc_vecs)
    cos = qh @ dh.T + ql @ dh.T + qh @ dl.T
    return alpha * cos + beta * containment_matrix(doc_sigs, query_sigs)
