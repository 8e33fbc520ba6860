"""Batched query engine with incremental materialization (serving plane).

The PyTorch port of the JAX package's ``core/engine.py``: the single
entry point for retrieval at serving time.  It owns the device-resident
copies of the ⟨V⟩/⟨I⟩ regions (torch tensors on the engine's device)
and adds three things a multi-user deployment needs:

1. **Batched queries** — ``query_batch(texts, k)`` builds query vectors
   and signatures on the host, pads the batch to a power-of-two bucket
   and scores all queries in one dispatch.

   Scoring paths (``resolve_scoring_path``):

   - ``"map"`` scores each query with the pinned-order
     ``hsf.stable_rowdot``, so every query's scores are bit-identical
     whatever the batch size, and identical on the CPU and the card;
   - ``"gemm"`` is one full-f32 ``[B, D] × [D, N]`` product (TF32 off),
     equal in value but not bit-stable across batch sizes;
   - ``"kernel"`` dispatches the hand-written CUDA kernel
     (kernels/hsf_score): one pass over the doc matrix with the top-k
     fused, no [B, N] score intermediate.

   Every path returns the same ranking with doc-index tie-breaking
   (score desc, id asc).  ``"auto"`` picks the kernel when the engine's
   device is CUDA and the bit-stable map path on the CPU.

2. **Incremental materialization** — ``refresh()`` re-vectorizes only
   the documents the KB logged as dirty and patches the device tensors
   copy-on-write (a patched clone is rebound; the old tensor is never
   written), so snapshots that pinned it stay whole.  The refreshed
   tensors are bit-identical to a cold ``materialize()`` rebuild.

3. **Query-vector LRU cache** — keyed on the canonicalized query text,
   invalidated only when the idf statistics change.

4. **Clustered index plane** — ``index="ivf"`` (default ``"flat"``)
   routes queries through the IVF probe/rerank subsystem
   (src/repro_torch/index/): score √N centroids on the host, gather the
   top-``nprobe`` clusters' rows on the device, rerank with the exact
   HSF through the same ``score_batch_arrays`` dispatch — sublinear scan
   cost, exact scores within the probed set, and ``guarantee="exact"``
   widens probes until the top-k is provably identical to the flat
   scan.  The index rides the same dirty-row log as the tensors
   (reassign-on-refresh, drift-triggered retrain) and persists via
   ``kb.index_state`` in the JAX package's format, so either package
   adopts the other's trained index without a retrain.
   ``index="ivf-sharded"`` partitions the clusters over a shard mesh
   (index/sharded.py; ``n_shards``, by default the CUDA device count on
   the card and 1 on the CPU): each shard reranks its own clusters'
   rows with the bit-stable map formulation on its device, and the
   per-shard top-k lists merge stably on the host — the same guarantees
   as ``"ivf"``, applied per shard.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no card present it raises (no silent CPU
fallback).
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis import sanitizers
from repro_torch.core import hsf, signature as sigmod
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.tokenizer import normalize
from repro_torch.launch.mesh import default_shards
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import global_registry

# shared reentrant no-op scope for the explain=False query path
_NULL_CTX = contextlib.nullcontext()


@dataclass
class RetrievalResult:
    """One retrieved document."""

    doc_id: str
    score: float
    cosine: float
    boosted: bool


@dataclass
class RefreshStats:
    """What one ``refresh()`` actually did."""

    changed: int = 0        # docs re-vectorized (the O(U) part)
    removed: int = 0        # docs dropped
    rows_patched: int = 0   # device rows updated (patched clone)
    restacked: bool = False  # row layout changed (add/remove) → host restack
    reweighted: bool = False  # idf changed → global reweight pass
    index_reassigned: int = 0  # dirty rows re-clustered (index plane)
    index_retrained: bool = False  # drift threshold hit → k-means retrain
    n_docs: int = 0
    seconds: float = 0.0

    @property
    def no_op(self) -> bool:
        return self.changed == 0 and self.removed == 0


# --------------------------------------------------------------------------
# devices and host → device transfer
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  No device and no card raises — a CPU run is
    always asked for explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                           "device is available")
    return dev


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A fresh tensor on ``device`` — never a view of the numpy buffer,
    so nothing the host does later can write into a live or pinned
    tensor."""
    return torch.tensor(np.asarray(arr, dtype), device=torch.device(device))


def arrays_from_numpy(doc_vecs: np.ndarray, doc_sigs: np.ndarray,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host doc arrays (float32 [N, D], int32 [N, W]) as fresh tensors
    on ``device`` — how a test hands both packages the same matrices."""
    return (_tensor(doc_vecs, np.float32, device),
            _tensor(doc_sigs, np.int32, device))


# --------------------------------------------------------------------------
# scoring core
# --------------------------------------------------------------------------

def _score_topk(doc_vecs, doc_sigs, q_vecs, q_sigs, n_valid,
                *, k, alpha, beta, gemm):
    """HSF scores + top-k for a padded query batch (map / gemm paths).

    Returns (vals [B,k], idx [B,k] int32, cos [B,k], ind [B,k]) — ``ind``
    is the exact containment indicator of each selected doc (0.0/1.0),
    the ground truth for the ``boosted`` flag.  The map path scores with
    ``hsf.stable_rowdot``, one query at a time, so each row's cosine is
    the same bits whatever else is in the batch.  Doc rows ``>= n_valid``
    score -inf before the top-k (for full-matrix callers the mask is the
    identity).
    """
    dv = doc_vecs.to(torch.float32)
    if gemm:
        # full f32 on the card: a TF32 product would keep ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
        # analysis: allow[unpinned-reduction] -- opt-in gemm branch
        #   (scoring_path="gemm"), documented non-bit-stable
        cos = q_vecs.to(torch.float32) @ dv.T
    else:
        cos = torch.stack([hsf.stable_rowdot(dv, q) for q in q_vecs])
    ind = torch.stack([hsf.containment(doc_sigs, s) for s in q_sigs])
    scores = alpha * cos + beta * ind
    rows = torch.arange(scores.shape[1], device=scores.device)
    scores = scores.masked_fill(rows[None, :] >= n_valid, float("-inf"))
    vals, idx = hsf.top_k(scores, k)
    return (vals, idx.to(torch.int32), torch.gather(cos, 1, idx),
            torch.gather(ind, 1, idx))


def _selected_cos_ind(doc_vecs, doc_sigs, q_vecs, q_sigs, idx):
    """Per-result cosine + exact containment for the selected docs only
    — O(B·k·D) instead of the O(B·N·D) full recompute.  The cosine is
    ``stable_rowdot``'s pinned-order sum, so a query's cosines do not
    depend on the batch it came in.  Sentinel ids of unfillable slots
    are clamped for the gather; their scores are -inf and results never
    read them."""
    sel = idx.clamp(max=doc_vecs.shape[0] - 1).long()
    sel_vecs = doc_vecs[sel].to(torch.float32)                  # [B,k,D]
    cos = hsf.pairwise_sum(sel_vecs * q_vecs.to(torch.float32)[:, None, :])
    sel_sigs = doc_sigs[sel]                                    # [B,k,W]
    qs = q_sigs[:, None, :]
    ind = torch.all((sel_sigs & qs) == qs, dim=-1).to(torch.float32)
    return cos, ind


def _score_topk_kernel(doc_vecs, doc_sigs, q_vecs, q_sigs, n_valid,
                       *, k, alpha, beta):
    """Fused kernel path (kernels/hsf_score.hsf_score_batched): one
    dispatch scores the whole query batch and reduces it to top-k on the
    card; only the selected rows' cosine/indicator are recomputed
    after.  Not bit-stable against the map path (a different reduction
    order); the ranking rule is the same."""
    vals, idx = hsf.hsf_topk_batched_kernel(
        doc_vecs, doc_sigs, q_vecs, q_sigs, k=k, alpha=alpha, beta=beta,
        n_valid=n_valid,
    )
    cos, ind = _selected_cos_ind(doc_vecs, doc_sigs, q_vecs, q_sigs, idx)
    return vals, idx, cos, ind


def _bucket(b: int) -> int:
    """Next power of two ≥ b (query-batch shape bucket)."""
    return 1 << max(b - 1, 0).bit_length() if b > 1 else 1


# --------------------------------------------------------------------------
# scoring-path selection
# --------------------------------------------------------------------------

SCORING_PATHS = ("map", "gemm", "kernel")


def resolve_scoring_path(
    scoring_path: str = "auto",
    use_kernel: bool = False,
    gemm_batch: bool = False,
    device="cpu",
) -> str:
    """Resolve the effective scoring path: "map" | "gemm" | "kernel".

    The boolean flags are explicit overrides and win over
    ``scoring_path``.  ``"auto"`` picks the fused CUDA kernel when
    ``device`` is a CUDA device and the bit-stable map path otherwise.
    ``"kernel"`` on a CPU device runs the kernel's plain version.
    """
    if use_kernel and gemm_batch:
        raise ValueError("use_kernel and gemm_batch are mutually exclusive")
    if use_kernel:
        return "kernel"
    if gemm_batch:
        return "gemm"
    if scoring_path == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "map"
    if scoring_path not in SCORING_PATHS:
        raise ValueError(
            f"scoring_path must be 'auto' or one of {SCORING_PATHS}, "
            f"got {scoring_path!r}"
        )
    return scoring_path


def score_batch_arrays(
    doc_vecs, doc_sigs, qv: np.ndarray, qs: np.ndarray, *,
    scoring_path: str, k: int, alpha: float, beta: float, n_docs: int,
    kernel_operands=None,
):
    """One padded-batch scoring dispatch → numpy (vals, idx, cos, ind).

    Pure function of its operands (no engine state): the serving-plane
    snapshot calls this against frozen tensors, the engine against its
    live ones.  ``n_docs`` < doc rows masks a padded suffix; full-matrix
    callers pass n_docs == rows.  ``kernel_operands`` is the optional
    prepared doc operand pair for the kernel path.  ``n_docs == 0``
    short-circuits to empty [B, 0] results on every path.
    """
    if n_docs <= 0:
        b = int(np.asarray(qv).shape[0])
        empty_f = np.zeros((b, 0), dtype=np.float32)
        empty_i = np.zeros((b, 0), dtype=np.int32)
        return empty_f, empty_i, empty_f.copy(), empty_f.copy()
    dev = doc_vecs.device
    with obs_trace.span("device_dispatch", path=scoring_path,
                        rows=int(n_docs), k=k):
        q_vecs = torch.from_numpy(np.ascontiguousarray(qv)).to(dev)
        q_sigs = torch.from_numpy(np.ascontiguousarray(qs)).to(dev)
        if scoring_path == "kernel":
            if kernel_operands is None:
                kernel_operands = hsf.hsf_kernel_pad_docs(doc_vecs, doc_sigs)
            dv, ds = kernel_operands
            vals, idx, cos, ind = _score_topk_kernel(
                dv, ds, q_vecs, q_sigs, n_docs, k=k, alpha=alpha, beta=beta,
            )
        else:
            vals, idx, cos, ind = _score_topk(
                doc_vecs, doc_sigs, q_vecs, q_sigs, n_docs,
                k=k, alpha=alpha, beta=beta, gemm=scoring_path == "gemm",
            )
        if obs_trace.active() and dev.type == "cuda":
            # analysis: allow[host-sync] -- tracing/explain-only sync:
            #   without it the asynchronous launch returns at once and
            #   all device time would be charged to the host_transfer
            #   span below; never runs when neither a trace nor an
            #   EXPLAIN collector is active
            torch.cuda.current_stream(dev).synchronize()
    with obs_trace.span("host_transfer", k=k):
        return (vals.cpu().numpy(), idx.cpu().numpy(),
                cos.cpu().numpy(), ind.cpu().numpy())


def results_from_topk(
    doc_ids, b: int, vals, idx, cos, ind
) -> list[list[RetrievalResult]]:
    """Materialize RetrievalResult rows for the first ``b`` queries of a
    padded batch (the ``boosted`` flag is the exact containment
    indicator returned by the scoring path).  The one audited
    device→host boundary every scoring path funnels through, so the
    opt-in NaN/Inf sanitizer hooks here (first ``b`` rows only)."""
    sanitizers.check_finite_scores(vals, b, "engine.results_from_topk")
    with obs_trace.span("materialize", rows=b):
        out = _materialize_rows(doc_ids, b, vals, idx, cos, ind)
    return out


def _materialize_rows(doc_ids, b, vals, idx, cos, ind):
    out = []
    for i in range(b):
        row = []
        for v, j, c, bi in zip(vals[i], idx[i], cos[i], ind[i]):
            row.append(
                RetrievalResult(
                    doc_id=doc_ids[int(j)],
                    score=float(v),
                    cosine=float(c),
                    boosted=bool(bi > 0.5),
                )
            )
        out.append(row)
    return out


def pack_query_arrays(
    pairs: list[tuple[np.ndarray, np.ndarray]], dim: int, sig_words: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-query (vector, signature) pairs into a padded
    power-of-two bucket (zero rows beyond len(pairs))."""
    bucket = _bucket(len(pairs))
    qv = np.zeros((bucket, dim), np.float32)
    qs = np.zeros((bucket, sig_words), np.int32)
    for i, (v, s) in enumerate(pairs):
        qv[i] = v
        qs[i] = s
    return qv, qs


def _record_ivf_stats(s) -> None:
    """Surface the per-dispatch ``IVFSearchStats`` as metrics in the obs
    global registry (the JAX engine's names)."""
    if s is None:
        return
    reg = global_registry()
    reg.histogram("ragdb_ivf_probed_fraction",
                  "fraction of clusters probed per dispatch").record(
        float(s.probed_fraction))
    reg.histogram("ragdb_ivf_widen_rounds",
                  "probe/widen rounds per dispatch").record(float(s.rounds))
    reg.counter("ragdb_ivf_candidate_rows_total",
                "candidate rows gathered for rerank").inc(
        int(s.candidate_rows))
    reg.counter("ragdb_ivf_searches_total", "ivf dispatches").inc()
    merge_s = getattr(s, "merge_seconds", None)
    if merge_s is not None:
        reg.histogram("ragdb_ivf_merge_seconds",
                      "sharded local-top-k merge per dispatch").record(
            float(merge_s))


def _pad_row_update(rows: np.ndarray, block: np.ndarray):
    """Pad a row-scatter update to a power-of-two row count.  Padding
    duplicates row 0 — a scatter writing identical content twice is
    deterministic."""
    pad = _bucket(len(rows)) - len(rows)
    if pad:
        rows = np.concatenate([rows, np.repeat(rows[:1], pad)])
        block = np.concatenate([block, np.repeat(block[:1], pad, axis=0)])
    return rows, block


def _patched(t: torch.Tensor, rows: np.ndarray,
             block: np.ndarray) -> torch.Tensor:
    """Copy-on-write row patch: a clone with ``rows`` set to ``block``.
    The live tensor is never written — snapshots pin it."""
    out = t.clone()
    out[torch.from_numpy(rows.astype(np.int64)).to(t.device)] = \
        torch.from_numpy(np.ascontiguousarray(block)).to(t.device, t.dtype)
    return out


class QueryEngine:
    """Batched retrieval over a live KnowledgeBase.

    ``query_batch`` auto-refreshes from the KB's dirty log first, so an
    engine constructed once keeps serving correct results across
    ``add_text``/``sync``/removal; refresh cost is O(changed docs).
    """

    INDEX_KINDS = ("flat", "ivf", "ivf-sharded")
    GUARANTEES = ("probe", "exact")

    def __init__(
        self,
        kb: KnowledgeBase,
        alpha: float = hsf.DEFAULT_ALPHA,
        beta: float = hsf.DEFAULT_BETA,
        use_kernel: bool = False,
        gemm_batch: bool = False,
        scoring_path: str = "auto",
        cache_size: int = 256,
        max_batch: int = 256,
        index: str = "flat",
        nprobe: int = 8,
        guarantee: str = "probe",
        n_clusters: int | None = None,
        retrain_drift: float = 0.3,
        ivf_seed: int = 0,
        n_shards: int | None = None,
        device=None,
    ):
        if index not in self.INDEX_KINDS:
            raise ValueError(
                f"index must be one of {self.INDEX_KINDS}, got {index!r}")
        if guarantee not in self.GUARANTEES:
            raise ValueError(
                f"guarantee must be one of {self.GUARANTEES}, "
                f"got {guarantee!r}")
        if index != "flat" and (alpha < 0 or beta < 0):
            # the cluster pruning bound assumes non-negative HSF weights
            raise ValueError(
                f"index={index!r} requires alpha >= 0 and beta >= 0")
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        self.kb = kb
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.device = resolve_device(device)
        # ---- index plane (docs/ARCHITECTURE.md §9) ----------------------
        # "flat" (default) scans all N docs — the bit-stability baseline.
        # "ivf" probes the top-`nprobe` clusters and reranks candidates
        # with the exact HSF; `guarantee="exact"` widens probes until the
        # top-k provably equals the flat scan (bit-identical).
        # "ivf-sharded" partitions the clusters over a shard mesh
        # (`n_shards`): each shard reranks its own cluster subset on its
        # device and only [B, k] candidates merge — the same guarantees,
        # applied per shard.
        self.index = index
        self.nprobe = int(nprobe)
        self.guarantee = guarantee
        self.n_clusters = n_clusters
        self.retrain_drift = float(retrain_drift)
        self.ivf_seed = int(ivf_seed)
        self.ivf = None  # IVFIndex | ShardedIVFIndex | None (see refresh)
        self._last_index_stats = None
        self.retrains = 0  # cumulative k-means (re)trains this engine ran
        self.scoring_path = resolve_scoring_path(
            scoring_path, use_kernel=use_kernel, gemm_batch=gemm_batch,
            device=self.device,
        )
        if index == "ivf-sharded":
            if n_shards is not None and n_shards < 1:
                raise ValueError(f"n_shards must be >= 1, got {n_shards}")
            # the per-shard local rerank always scores with the
            # bit-stable map formulation ("auto" coerces; an explicit
            # gemm/kernel request would silently change numerics, so it
            # is rejected rather than ignored)
            if self.scoring_path != "map":
                if scoring_path == "auto" and not use_kernel \
                        and not gemm_batch:
                    self.scoring_path = "map"
                else:
                    raise ValueError(
                        "index='ivf-sharded' reranks with the bit-stable "
                        "map formulation; scoring_path must be 'map' or "
                        f"'auto', got {self.scoring_path!r}"
                    )
            self.n_shards = int(n_shards) if n_shards is not None \
                else default_shards(self.device)
        else:
            if n_shards is not None:
                raise ValueError(
                    "n_shards is only meaningful with index='ivf-sharded'"
                )
            self.n_shards = None
        self.use_kernel = self.scoring_path == "kernel"
        self.gemm_batch = self.scoring_path == "gemm"
        self.cache_size = cache_size
        self.max_batch = max_batch

        self.doc_ids: list[str] = []
        self.doc_vecs, self.doc_sigs = arrays_from_numpy(
            np.zeros((0, kb.dim), np.float32),
            np.zeros((0, kb.sig_words), np.int32), self.device)
        self._row_of: dict[str, int] = {}
        self._u = np.zeros((0, kb.dim), np.float32)  # cached tf·sign rows
        self._idf = np.zeros((0,), np.float32)
        self._synced = -1  # KB version the device tensors reflect

        # kernel-path operand cache: (src_vecs, src_sigs, kernel_vecs,
        # kernel_sigs) — holding the source refs both keys the cache and
        # pins them against id reuse
        self._kernel_cache: tuple | None = None

        self._qcache: OrderedDict[str, tuple[np.ndarray, np.ndarray]] = (
            OrderedDict()
        )
        self.cache_hits = 0
        self.cache_misses = 0

        self.refresh()

    # ---- incremental materialization -----------------------------------

    def refresh(self) -> RefreshStats:
        """Bring device tensors up to date with the KB (O(changed docs)).

        When ``index`` is ``"ivf"`` or ``"ivf-sharded"`` the cluster
        index rides the same dirty-row delta: changed docs reassign to
        their nearest centroid (O(U)), layout restacks remap assignments
        by doc id, and the drift counter triggers a full k-means retrain
        past ``retrain_drift`` (see ``_sync_ivf``).
        """
        t0 = time.perf_counter()
        kb = self.kb
        stats = RefreshStats()
        target = kb.version
        changed_ids: list[str] | None = None
        old_row_of: dict[str, int] = {}
        if self._synced < 0:
            stats.changed = kb.n_docs
            stats.restacked = True
            self._cold_build()
            stats.reweighted = True
        elif target != self._synced:
            changed, removed = kb.changes_since(self._synced)
            stats.changed, stats.removed = len(changed), len(removed)
            changed_ids = changed
            old_row_of = self._row_of  # pre-delta layout (for ivf remap)
            self._apply_delta(changed, stats)
        if self.index != "flat" and (self.ivf is None
                                     or changed_ids is not None):
            self._sync_ivf(changed_ids, old_row_of, stats)
        self._synced = target
        stats.n_docs = len(self.doc_ids)
        stats.seconds = time.perf_counter() - t0
        return stats

    def _cold_build(self) -> None:
        kb = self.kb
        if not kb._dirty and kb._matrix is not None:
            # a clean materialized matrix exists (e.g. a container loaded
            # with include_matrix=True): adopt it instead of re-vectorizing
            # — that skip is the whole point of persisting ⟨V⟩ (RQ3).
            # The u-row cache is built lazily on the first delta.
            matrix, sigs, ids = kb.materialize()
            self._u = None
            self._idf = kb.vectorizer.idf()
        else:
            ids = sorted(kb.records)
            tcs = [kb.term_counts[i] for i in ids]
            self._u = kb.vectorizer.build_unweighted_matrix(tcs)
            self._idf = kb.vectorizer.idf()
            matrix = kb.vectorizer.finalize_matrix(self._u)
            sigs = (np.stack([kb.signatures[i] for i in ids]) if ids
                    else np.zeros((0, kb.sig_words), np.int32))
        self.doc_vecs, self.doc_sigs = arrays_from_numpy(
            matrix, sigs, self.device)
        self.doc_ids = ids
        self._row_of = {i: r for r, i in enumerate(ids)}

    def _ensure_u(self) -> None:
        """Materialize the u-row cache for the engine's current layout.

        Deferred when the cold build adopted a persisted matrix; rows for
        docs since removed from the KB are left zero (never read — the
        restack path only copies rows for surviving ids), and rows for
        since-changed docs are recomputed from the new term counts,
        identical to the values the delta is about to write anyway.
        """
        if self._u is not None:
            return
        kb = self.kb
        rows = np.zeros((len(self.doc_ids), kb.dim), np.float32)
        for r, i in enumerate(self.doc_ids):
            tc = kb.term_counts.get(i)
            if tc is not None:
                rows[r] = kb.vectorizer.unweighted_row(tc)
        self._u = rows

    def _apply_delta(self, changed: list[str], stats: RefreshStats) -> None:
        kb = self.kb
        if not changed and sorted(kb.records) == self.doc_ids:
            # metadata-only mutation: no rows to patch and df cannot
            # have moved — skip the u-cache materialization
            return
        self._ensure_u()
        # the O(U) part: re-vectorize only the dirty docs
        new_u = {
            i: kb.vectorizer.unweighted_row(kb.term_counts[i])
            for i in changed
        }
        new_ids = sorted(kb.records)
        if new_ids == self.doc_ids:
            if changed:
                rows = np.array(
                    [self._row_of[i] for i in changed], np.int32
                )
                for r, i in zip(rows, changed):
                    self._u[r] = new_u[i]
                sig_block = np.stack([kb.signatures[i] for i in changed])
                rows_p, sig_p = _pad_row_update(rows, sig_block)
                self.doc_sigs = _patched(self.doc_sigs, rows_p, sig_p)
        else:
            # layout changed: restack cached rows on the host (pure
            # memcpy for unchanged docs — no re-vectorization)
            u = np.zeros((len(new_ids), kb.dim), np.float32)
            sig = np.zeros((len(new_ids), kb.sig_words), np.int32)
            old_sig = self.doc_sigs.cpu().numpy()
            for r, i in enumerate(new_ids):
                if i in new_u:
                    u[r] = new_u[i]
                    sig[r] = kb.signatures[i]
                else:
                    old_r = self._row_of[i]
                    u[r] = self._u[old_r]
                    sig[r] = old_sig[old_r]
            self._u = u
            self.doc_sigs = _tensor(sig, np.int32, self.device)
            self.doc_ids = new_ids
            self._row_of = {i: r for r, i in enumerate(new_ids)}
            stats.restacked = True

        idf = kb.vectorizer.idf()
        if stats.restacked or not np.array_equal(idf, self._idf):
            # idf moved: the cheap global stage — elementwise reweight +
            # renormalize of the cached U, nothing re-vectorized
            self._idf = idf
            self.doc_vecs = _tensor(kb.vectorizer.finalize_matrix(self._u),
                                    np.float32, self.device)
            stats.reweighted = True
            self._qcache.clear()  # query vectors depend on idf
        elif changed:
            # idf stable: patch only the dirty rows
            rows = np.array([self._row_of[i] for i in changed], np.int32)
            block = kb.vectorizer.finalize_matrix(self._u[rows])
            rows_p, block_p = _pad_row_update(rows, block)
            self.doc_vecs = _patched(self.doc_vecs, rows_p, block_p)
            stats.rows_patched = len(rows)

    # ---- index plane maintenance (index="ivf") --------------------------

    def _sync_ivf(self, changed_ids: list[str] | None,
                  old_row_of: dict[str, int], stats: RefreshStats) -> None:
        """Keep the cluster index aligned with the device tensors.

        Cold: adopt the KB's persisted index state when it matches the
        current doc layout and content (no cold retrain on load — the
        state may come from either package), else train on the device.
        Delta: changed rows reassign (O(U)); restacks remap assignments
        by doc id; the drift counter triggers a retrain past
        ``retrain_drift``.  Every state change is written back to
        ``kb.index_state`` so ``save``/``save_delta`` persist it.
        """
        from repro_torch.index.ivf import IVFIndex, ids_digest
        from repro_torch.index.sharded import ShardedIVFIndex

        sharded = self.index == "ivf-sharded"

        def _train():
            if sharded:
                return ShardedIVFIndex.train(
                    self.doc_vecs, self.doc_sigs,
                    n_clusters=self.n_clusters, seed=self.ivf_seed,
                    n_shards=self.n_shards,
                )
            return IVFIndex.train(
                self.doc_vecs, self.doc_sigs,
                n_clusters=self.n_clusters, seed=self.ivf_seed,
            )

        n = len(self.doc_ids)
        if n == 0:
            self.ivf = None
            return
        if self.ivf is None:
            st = self.kb.index_state
            if (st is not None and st.get("kind") == "ivf"
                    and len(st["assign"]) == n
                    and st.get("ids_sha") == ids_digest(self._ivf_state_key())):
                # the key covers doc ids AND content hashes: a stale
                # state (doc rewritten in place with no live index
                # maintenance) must never adopt — its sig_union/radius
                # could underestimate a cluster and break exactness.
                # Both kinds persist kind="ivf": a sharded engine adopts
                # flat-written state (deriving its deterministic
                # partition) and vice versa — bit-identical, no retrain
                if sharded:
                    self.ivf = ShardedIVFIndex.from_state(
                        st, self.doc_vecs, self.doc_sigs,
                        n_shards=self.n_shards,
                    )
                else:
                    self.ivf = IVFIndex.from_state(st)
                return
            self.ivf = _train()
            stats.index_retrained = True
            self._note_retrain()
            self._write_index_state()
            return
        if stats.restacked:
            # layout changed: carry surviving rows' clusters by doc id;
            # new/changed rows (−1) assign to their nearest centroid
            old_assign = self.ivf.assign
            changed_set = set(changed_ids or ())
            carried = np.full((n,), -1, np.int32)
            for r, i in enumerate(self.doc_ids):
                old_r = old_row_of.get(i)
                if old_r is not None and i not in changed_set:
                    carried[r] = old_assign[old_r]
            self.ivf = self.ivf.remap(carried, self.doc_vecs, self.doc_sigs)
            stats.index_reassigned = int(np.sum(carried < 0))
        elif changed_ids:
            # O(U) path: gather only the dirty rows on the device before
            # the host copy — never a full [N, ·] device→host copy.
            # The sharded plane additionally routes each dirty row to
            # its owning shard's resident block (index/sharded.py), so
            # it takes the live doc tensors for cross-shard regathers
            rows = np.array([self._row_of[i] for i in changed_ids], np.int32)
            rows_t = torch.from_numpy(rows.astype(np.int64)).to(self.device)
            row_vecs = self.doc_vecs.index_select(0, rows_t)
            row_sigs = self.doc_sigs.index_select(0, rows_t)
            if sharded:
                # reweighted => the refresh rebuilt every doc vector
                # (idf moved), so the resident blocks regather in full;
                # otherwise only the dirty rows patch (O(U))
                self.ivf = self.ivf.reassign(
                    rows, row_vecs, row_sigs, self.doc_vecs, self.doc_sigs,
                    reweighted=stats.reweighted)
            else:
                self.ivf = self.ivf.reassign(rows, row_vecs, row_sigs)
            stats.index_reassigned = len(rows)
        else:
            return  # metadata-only mutation: index untouched
        if self.ivf.needs_retrain(self.retrain_drift):
            self.ivf = _train()
            stats.index_retrained = True
            self._note_retrain()
        self._write_index_state()

    def _note_retrain(self) -> None:
        self.retrains += 1
        global_registry().counter(
            "ragdb_ivf_retrains_total",
            "k-means (re)trains across all engines").inc()

    def _ivf_state_key(self) -> list[str]:
        """Layout **and content** key the persisted index is pinned to:
        one ``"id\\x01sha256"`` token per doc in engine row order."""
        recs = self.kb.records
        return [f"{i}\x01{recs[i].sha256}" for i in self.doc_ids]

    def _write_index_state(self) -> None:
        """Publish the index state into the KB so the persistence plane
        journals it alongside the doc segments (core/ingest.py)."""
        self.kb.set_index_state(self.ivf.state_dict(self._ivf_state_key()))

    def index_stats(self) -> dict:
        """Probe accounting of the most recent ivf dispatch (None fields
        when the engine is flat or hasn't served an ivf query yet)."""
        s = self._last_index_stats
        return {
            "index": self.index,
            "n_clusters": self.ivf.n_clusters if self.ivf else 0,
            "drift": self.ivf.drift if self.ivf else 0,
            "retrains": self.retrains,
            "probed_fraction": s.probed_fraction if s else None,
            "clusters_probed": s.clusters_probed if s else None,
            "candidate_rows": s.candidate_rows if s else None,
            "rounds": s.rounds if s else None,
            # distribution terms (None unless the sharded plane served)
            "n_shards": getattr(s, "n_shards", None) if s else None,
            "merge_seconds": getattr(s, "merge_seconds", None) if s else None,
        }

    # ---- query-vector cache --------------------------------------------

    def _query_arrays(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        key = normalize(text)
        hit = self._qcache.get(key)
        if hit is not None:
            self._qcache.move_to_end(key)
            self.cache_hits += 1
            return hit
        self.cache_misses += 1
        out = (
            self.kb.vectorizer.query_vector(text),
            sigmod.query_signature(text, width_words=self.kb.sig_words),
        )
        self._qcache[key] = out
        if len(self._qcache) > self.cache_size:
            self._qcache.popitem(last=False)
        return out

    # ---- batched queries ------------------------------------------------

    def query_batch(
        self, texts: list[str], k: int = 5, *, explain: bool = False
    ):
        """Retrieve top-k for every query; one device dispatch per chunk.

        ``k`` must be ≥ 1; ``k`` > corpus size clamps to the corpus
        size.  ``explain=True`` returns ``(results, plans)`` with one
        :class:`repro_torch.obs.explain.QueryPlan` per query.
        """
        if k <= 0:
            raise ValueError(f"k must be a positive integer, got {k}")
        self.refresh()
        if not self.doc_ids or not texts:
            empty = [[] for _ in texts]
            if explain:
                from repro_torch.obs import explain as explain_mod
                plans = explain_mod.plans_from_dispatch(
                    texts, k, index=self.index,
                    scoring_path=self.scoring_path, guarantee=self.guarantee,
                    n_docs=0)
                return empty, plans
            return empty
        out: list[list[RetrievalResult]] = []
        batches = []
        for start in range(0, len(texts), self.max_batch):
            chunk = texts[start: start + self.max_batch]
            if explain:
                res, ps = self._query_chunk(chunk, k, explain=True)
                out.extend(res)
                batches.append(ps)
            else:
                out.extend(self._query_chunk(chunk, k))
        if explain:
            from repro_torch.obs.explain import PlanBatch
            return out, PlanBatch.concat(batches)
        return out

    def query(self, text: str, k: int = 5) -> list[RetrievalResult]:
        """Single-query convenience wrapper (batch of one)."""
        return self.query_batch([text], k)[0]

    def _query_chunk(self, texts: list[str], k: int, *,
                     explain: bool = False):
        b = len(texts)
        if explain:
            from repro_torch.obs import explain as explain_mod
            col = obs_trace.StageCollector()
            scope = obs_trace.get().collect(col)
            vec_hits = tuple(normalize(t) in self._qcache for t in texts)
            t0 = time.perf_counter()
        else:
            scope = _NULL_CTX
        with scope:
            with obs_trace.span("query_embed", queries=b):
                pairs = [self._query_arrays(t) for t in texts]
                qv, qs = pack_query_arrays(
                    pairs, self.kb.dim, self.kb.sig_words)
            n = len(self.doc_ids)
            stats = None
            if self.index != "flat" and self.ivf is not None:
                vals, idx, cos, ind, stats = self.ivf.search(
                    self.doc_vecs, self.doc_sigs, qv, qs,
                    b=b, k=min(k, n), nprobe=self.nprobe,
                    guarantee=self.guarantee,
                    scoring_path=self.scoring_path,
                    alpha=self.alpha, beta=self.beta, explain=explain,
                )
                self._last_index_stats = stats
                _record_ivf_stats(stats)
            else:
                vals, idx, cos, ind = score_batch_arrays(
                    self.doc_vecs, self.doc_sigs, qv, qs,
                    scoring_path=self.scoring_path, k=min(k, n),
                    alpha=self.alpha, beta=self.beta, n_docs=n,
                    kernel_operands=(
                        self._kernel_operands() if self.use_kernel else None
                    ),
                )
            results = results_from_topk(self.doc_ids, b, vals, idx, cos, ind)
        if not explain:
            return results
        stages = tuple(col.stages)
        total_s = time.perf_counter() - t0
        index, path, guar = self.index, self.scoring_path, self.guarantee
        return results, explain_mod.PlanBatch(
            lambda: explain_mod.plans_from_dispatch(
                texts, k, index=index, scoring_path=path, guarantee=guar,
                n_docs=n, stats=stats, stages=stages,
                vector_cache_hits=vec_hits, total_s=total_s))

    def _kernel_operands(self):
        """Kernel-ready doc operands, prepared only when refresh()
        rebound the device tensors."""
        cache = self._kernel_cache
        if (cache is None or cache[0] is not self.doc_vecs
                or cache[1] is not self.doc_sigs):
            dv, ds = hsf.hsf_kernel_pad_docs(self.doc_vecs, self.doc_sigs)
            cache = (self.doc_vecs, self.doc_sigs, dv, ds)
            self._kernel_cache = cache
        return cache[2], cache[3]

    # ---- introspection ---------------------------------------------------

    @property
    def synced_version(self) -> int:
        """The KB mutation version the device tensors reflect — the
        generation a snapshot captured from this engine is pinned at.
        -1 until the first ``refresh()``."""
        return self._synced

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    def cache_stats(self) -> dict:
        return {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "entries": len(self._qcache),
            "capacity": self.cache_size,
        }
