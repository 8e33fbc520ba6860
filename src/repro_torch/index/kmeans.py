"""Deterministic spherical k-means over the TF-IDF doc matrix, on the
doc matrix's device (PyTorch port of the JAX package's ``index/kmeans.py``).

Document rows are ℓ2-normalized (vectorizer.py), so cosine similarity
is a dot product and the natural cluster geometry is spherical: assign
by max dot against ℓ2-normalized centroids, update as the renormalized
member mean.  This is the training half of the IVF index plane
(ivf.py).

Determinism contract: the fit is a pure function of (doc matrix,
n_clusters, seed, n_iter, device).  The init rows come from a
``torch.Generator(device).manual_seed(seed)`` permutation; the centroid
sums are a one-hot matrix product (no ``index_add_``/``scatter_add_``,
whose CUDA atomics would make the sums change from run to run); and the
empty-cluster reseed is rank-based with a stable argsort.  So a retrain
on the same corpus state reproduces the same centroids bit for bit on
one device.  The JAX package seeds its init with ``jax.random``, which
torch cannot reproduce: after a retrain the two packages' centroids
differ.  Persisted index state is adopted verbatim by either package
(``IVFIndex.from_state``), so a container carries its centroids across.

Empty clusters: a cluster that loses all members seizes the
*worst-served* point (lowest best-similarity to any centroid); with
``e`` empty clusters the ``e`` hardest points are taken in rank order,
one per empty cluster.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def default_n_clusters(n_docs: int) -> int:
    """The k ≈ √N default: balances centroid-scan cost (k·D per query)
    against candidate-scan cost (nprobe·N/k·D per probe)."""
    return max(1, int(round(math.sqrt(max(n_docs, 0)))))


def _kmeans_fit(x: torch.Tensor, init_rows: torch.Tensor, *,
                n_clusters: int, n_iter: int):
    """Lloyd iterations on the sphere → (centroids [k, D], assign [N]).

    x [N, D] float32 (rows ℓ2-normalized); init_rows [k] int64.  The
    products are full f32 (TF32 off on the card); they route training
    geometry only — the exact HSF rerank makes served results
    independent of them.
    """
    n = x.shape[0]
    cent = x.index_select(0, init_rows)                      # [k, D]
    for _ in range(n_iter):
        # analysis: allow[unpinned-reduction] -- training geometry, not
        #   served scores: assignments feed routing only, and the exact
        #   HSF rerank makes results invariant to them
        sims = x @ cent.T                                    # [N, k]
        assign = torch.argmax(sims, dim=1)  # first index among ties
        best = torch.amax(sims, dim=1)                       # [N]
        one_hot = torch.nn.functional.one_hot(
            assign, n_clusters).to(x.dtype)                  # [N, k]
        counts = one_hot.sum(dim=0)                          # [k]
        # analysis: allow[unpinned-reduction] -- centroid accumulation
        #   during training; the same routing-only argument as above
        sums = one_hot.T @ x                                 # [k, D]
        mean = sums / torch.clamp(counts, min=1.0)[:, None]
        # empty clusters seize the hardest points, one per cluster in
        # rank order (worst-served first) — deterministic, shape-static
        empty = counts == 0
        hardest = torch.argsort(best, stable=True)           # ascending sim
        erank = torch.clamp(torch.cumsum(empty.to(torch.int64), 0) - 1,
                            0, n - 1)
        seize = x.index_select(0, hardest.index_select(0, erank))
        cent = torch.where(empty[:, None], seize, mean)
        norm = torch.linalg.vector_norm(cent, dim=1, keepdim=True)
        cent = cent / torch.clamp(norm, min=1e-12)           # spherical
    # analysis: allow[unpinned-reduction] -- final training assignment;
    #   routing-only, results invariant under the exact rerank
    assign = torch.argmax(x @ cent.T, dim=1).to(torch.int32)
    return cent, assign


def spherical_kmeans(
    doc_vecs,
    n_clusters: int | None = None,
    *,
    seed: int = 0,
    n_iter: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Fit spherical k-means → (centroids [k, D] f32, assign [N] i32),
    both host numpy.

    ``doc_vecs`` is a torch tensor (the fit runs on its device) or a
    numpy array (the fit runs on the CPU).  ``n_clusters=None`` uses the
    √N default, clamped to N.  Deterministic from (doc_vecs, n_clusters,
    seed, n_iter) on one device.
    """
    x = torch.as_tensor(doc_vecs).to(torch.float32)
    n = int(x.shape[0])
    if n == 0:
        return (np.zeros((0, int(x.shape[1]) if x.dim() == 2 else 0),
                         np.float32),
                np.zeros((0,), np.int32))
    k = min(n_clusters or default_n_clusters(n), n)
    gen = torch.Generator(x.device).manual_seed(seed)
    init = torch.randperm(n, generator=gen, device=x.device)[:k]
    if x.device.type == "cuda":
        # full f32: a TF32 product would keep ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
    cent, assign = _kmeans_fit(x, init, n_clusters=k, n_iter=n_iter)
    return cent.cpu().numpy(), assign.cpu().numpy()
