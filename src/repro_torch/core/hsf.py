"""Hybrid Scoring Function (paper §4):

    Score(Q, D) = α · cos(v_Q, v_D) + β · 1_substr(Q, D)

with the containment form of the indicator (signature.py).  This module
is the plain PyTorch implementation plus the dispatchers to the CUDA
kernels (kernels/hsf_score): the fused batched top-k that carries the
serving hot loop, and the single-query score.

Default weights follow the paper's reported top score for the injected
entity (1.5753 with cosine ≈ 0.575 and a unit boost): α = 1.0, β = 1.0.

Every op here is a separate eager PyTorch op: an elementwise multiply
or add rounds once, on the CPU and on the card alike, so the map-path
scores are the same bits on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_ALPHA = 1.0
DEFAULT_BETA = 1.0
ROWDOT_CHUNK_BYTES = 1 << 30


def stable_rowdot(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Deterministic [n, D] · [D] matvec — float32 [n].

    A library ``dot``/``matmul`` leaves the reduction order unspecified
    (it varies with operand height, blocking and threads), so the same
    row could round differently between a full scan and a gathered
    block.  This formulation pins the order: elementwise products, then
    an explicit pairwise-halving add tree over the feature axis
    (zero-padded to a power of two; padding with +0.0 is exact).  Each
    row's dot is a pure function of that row's values — independent of
    how many rows ride along or which device scores them.
    """
    return pairwise_sum(mat.to(torch.float32) * vec.to(torch.float32)[None, :])


def batched_rowdot(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``stable_rowdot(mat, v)`` for every row v of ``vecs``: float32
    [B, n].  The same elementwise products and add tree, broadcast over
    the queries, so each (query, row) dot is the same bits as one query
    at a time (an elementwise op rounds each element alone).  The
    [B, n, D] products are formed ROWDOT_CHUNK_BYTES of them at a time
    (at least one query's)."""
    mat = mat.to(torch.float32)
    vecs = vecs.to(torch.float32)
    step = max(1, ROWDOT_CHUNK_BYTES // max(1, 4 * mat.numel()))
    if vecs.shape[0] <= step:
        return pairwise_sum(mat[None] * vecs[:, None])
    return torch.cat([pairwise_sum(mat[None] * v[:, None])
                      for v in vecs.split(step)])


def pairwise_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by ``stable_rowdot``'s pinned order: the
    axis zero-padded to a power of two, then halved by pairwise adds."""
    d = p.shape[-1]
    width = 1 << max(0, d - 1).bit_length() if d > 1 else 1
    if width != d:
        p = torch.nn.functional.pad(p, (0, width - d))
    while width > 1:
        width //= 2
        p = p[..., :width] + p[..., width:]
    return p[..., 0]


def containment(doc_sigs: torch.Tensor,
                query_sig: torch.Tensor) -> torch.Tensor:
    """Bloom containment indicator, float32 [n_docs].

    doc_sigs int32 [n, W], query_sig int32 [W].  Bitwise ops on int32
    are two's complement; equality of bit patterns is what matters.
    """
    hits = (doc_sigs & query_sig) == query_sig
    return torch.all(hits, dim=-1).to(torch.float32)


def hsf_scores(
    doc_vecs: torch.Tensor,   # float32 [n, D], rows ℓ2-normalized
    doc_sigs: torch.Tensor,   # int32 [n, W]
    query_vec: torch.Tensor,  # [D]
    query_sig: torch.Tensor,  # int32 [W]
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
) -> torch.Tensor:
    """Reference HSF: α·(docs @ q) + β·containment.  float32 [n].

    The cosine rides the pinned-order ``stable_rowdot`` so this is
    bit-identical to the engine's map path row for row."""
    cos = stable_rowdot(doc_vecs, query_vec)
    return alpha * cos + beta * containment(doc_sigs, query_sig)


def hsf_scores_batched(
    doc_vecs: torch.Tensor,    # [n, D]
    doc_sigs: torch.Tensor,    # int32 [n, W]
    query_vecs: torch.Tensor,  # [q, D]
    query_sigs: torch.Tensor,  # int32 [q, W]
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
) -> torch.Tensor:
    """Multi-query HSF (serving batch): float32 [q, n].  A full-f32
    gemm, documented non-bit-stable against the map path."""
    from repro_torch.kernels.hsf_score.ref import hsf_score_matrix

    return hsf_score_matrix(doc_vecs, doc_sigs, query_vecs, query_sigs,
                            alpha, beta)


def hsf_scores_kernel(
    doc_vecs, doc_sigs, query_vec, query_sig,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
):
    """Single-query kernel dispatcher (kernels/hsf_score ``hsf_score``,
    ``csrc/hsf_score.cu`` on the card): float32 [n] scores, docs and
    query in f32 or bf16 summed in f32.  Not bit-stable against
    ``hsf_scores`` (a different summation order)."""
    from repro_torch.kernels.hsf_score import ops as _ops

    return _ops.hsf_score(doc_vecs, doc_sigs, query_vec, query_sig,
                          alpha=alpha, beta=beta)


def hsf_topk_batched_kernel(
    doc_vecs, doc_sigs, query_vecs, query_sigs,
    *,
    k: int,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
    n_valid=None,
):
    """Batched-kernel dispatcher: fused multi-query HSF with top-k
    (kernels/hsf_score).  Returns (vals [B, k'], ids [B, k']),
    k' = min(k, N), ordered (score desc, id asc).  The [B, N] score
    matrix never reaches device memory — the serving-plane hot loop."""
    from repro_torch.kernels.hsf_score import ops as _ops

    return _ops.hsf_score_batched(
        doc_vecs, doc_sigs, query_vecs, query_sigs,
        k=k, alpha=alpha, beta=beta, n_valid=n_valid,
    )


def hsf_kernel_pad_docs(doc_vecs, doc_sigs):
    """Kernel-ready doc operands, prepared once per refresh; see
    `kernels/hsf_score/ops.pad_docs_for_kernel`."""
    from repro_torch.kernels.hsf_score import ops as _ops

    return _ops.pad_docs_for_kernel(doc_vecs, doc_sigs)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k best scores per row, ties broken by
    lower index first (``lax.top_k``'s order).  ``torch.topk`` promises
    no order among ties, so this is a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def numpy_reference(doc_vecs, doc_sigs, query_vec, query_sig, alpha, beta):
    """Pure-numpy oracle for tests (no torch involvement at all)."""
    # analysis: allow[unpinned-reduction] -- float64 test oracle; extra
    #   mantissa absorbs reduction-order error, tests allow an eps band
    cos = doc_vecs.astype(np.float64) @ query_vec.astype(np.float64)
    d = doc_sigs.view(np.uint32)
    q = query_sig.view(np.uint32)
    ind = np.all((d & q) == q, axis=-1).astype(np.float64)
    return alpha * cos + beta * ind
