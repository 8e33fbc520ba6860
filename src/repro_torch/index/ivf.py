"""IVF-style clustered retrieval: probe top-``nprobe`` clusters, rerank
with the exact HSF (PyTorch port of the JAX package's ``index/ivf.py``).

Two-stage query (docs/ARCHITECTURE.md §9):

1. **Probe.**  Score the [k_clusters, D] centroid matrix (host numpy —
   k_clusters ≈ √N, this is the cheap plane).  The probe order
   interleaves the *optimistic HSF* ranking
   ``α·(q·μ_c) + β·contain(∪sig_c, q_sig)`` — ``∪sig_c`` is the
   bitwise OR of the cluster members' Bloom signatures, so a cluster
   whose union cannot contain the query substring provably holds no
   boosted doc — with the pure centroid-cosine ranking (on big
   clusters the union saturates and ``contain`` fires broadly; cosine
   keeps the semantic neighborhoods ranked).

2. **Rerank.**  Gather the probed clusters' member rows — per query in
   probe mode, the batch union in exact mode — in ascending global row
   order (so tie-breaking matches the flat scan), with one
   ``index_select`` on the device, and score them through the *same*
   ``score_batch_arrays`` machinery the flat paths use (map / gemm /
   the fused CUDA kernel).  A gathered row is scored by the same
   arithmetic as in the flat scan — the pinned ``stable_rowdot`` on the
   map path, one in-order FMA chain over D per (query, doc) in the
   kernel — so results within the probed set equal the brute-force
   results bit for bit (ids, scores, tie order): tests/test_torch_index.py
   on the CPU, ``chip_smoke.py`` phase 7 on the card.

Exactness guarantee (``guarantee="exact"``): every doc d in cluster c
satisfies ``score(q, d) ≤ α·cos_ub(q, c) + β·contain(∪sig_c, q_sig)``
where ``cos_ub`` is the spherical-cap bound ``cos(max(0, θ_q − θ_c))``
computed from the stored per-cluster radius (min member·centroid dot —
kept as a *lower* bound under incremental maintenance, which only ever
widens the cap: stale radius/union bits make probing conservative,
never unsafe).  The search widens the probe set until the k-th best
exact score strictly exceeds every unprobed cluster's bound (ties
force further probing), at which point the top-k — ids, scores, tie
order — is provably identical to the flat scan.  The bound is
evaluated in float64 with a +1e-6 margin so float rounding can only
over-probe.  Requires ``α ≥ 0`` and ``β ≥ 0`` (enforced by the engine).

Incremental maintenance: ``reassign`` moves changed rows to their
nearest centroid in O(U·k_clusters·D) and widens the affected
clusters' bounds; ``remap`` handles layout restacks; a drift counter
(rows that changed cluster since the last train) triggers retraining
once it exceeds a configurable fraction of the corpus
(``needs_retrain``).  All updates return a **new** ``IVFIndex`` —
instances are immutable after construction, which is what lets the
serving snapshots pin a frozen index per generation with one reference
capture (serving/snapshot.py).

The probe plane is the JAX package's host numpy code, verbatim, so the
probe order is the same bits in both packages for the same state.
Index state is host numpy (centroids, bounds, assignments, member
lists), so ``state_dict``/``from_state`` carry the JAX package's state
as it is, in both directions.  The member-radius dots of
``from_assignments`` run on the doc matrix's device: the doc matrix
(1.07 GB at the serving shape) is never copied to the host; only the
signatures (33.5 MB) are, for the per-cluster signature unions.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.engine import score_batch_arrays
from repro_torch.index.kmeans import spherical_kmeans
from repro_torch.obs import trace as obs_trace

# float64 safety margin on the spherical-cap bound: rounding can only
# widen the probe set, never exclude a true top-k doc
_UB_EPS = 1e-6
# rows per device chunk of the member-radius dots (bounds the gathered
# centroid block to 64 MB at D = 4,096)
_DOT_ROWS = 4_096


def _host(arr) -> np.ndarray:
    """A host numpy view of a torch tensor or array-like."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _member_dots(doc_vecs, centroids: np.ndarray,
                 assign: np.ndarray) -> np.ndarray:
    """Each row's dot with its own centroid, float32 [N], computed on
    the doc matrix's device in row chunks; only the [N] result crosses
    to the host."""
    dv = torch.as_tensor(doc_vecs)
    cent = torch.from_numpy(np.ascontiguousarray(centroids)).to(dv.device)
    rows = torch.from_numpy(assign.astype(np.int64)).to(dv.device)
    out = torch.empty((dv.shape[0],), dtype=torch.float32, device=dv.device)
    for s in range(0, dv.shape[0], _DOT_ROWS):
        e = s + _DOT_ROWS
        out[s:e] = (dv[s:e].to(torch.float32)
                    * cent.index_select(0, rows[s:e])).sum(dim=1)
    return out.cpu().numpy()


def exact_cos_upper_bound(a: np.ndarray, radius: np.ndarray) -> np.ndarray:
    """Spherical-cap cosine bound ``cos(max(0, θ_q − θ_c))`` per
    (query, cluster), in float64 with the over-probe cushions.

    ``a`` [b, kc] are clipped query·centroid cosines; ``radius`` [kc] is
    the stored min member·centroid dot.  The stored radius is an f32
    dot; its rounding error is amplified by the cap's curvature near
    rb → 1 (d cap/d rb ~ 1/√(1−rb²)), so cushion rb by 1e-4 — widening
    the cap can only over-probe, never exclude a true top-k doc.  Shared
    by the flat IVF search and the per-shard bound of the sharded plane
    (index/sharded.py) — one bound, one proof.
    """
    rb = np.clip(radius.astype(np.float64) - 1e-4, -1.0, 1.0)[None, :]
    cap = a * rb + np.sqrt(np.maximum(1 - a * a, 0.0)) \
        * np.sqrt(np.maximum(1 - rb * rb, 0.0))
    return np.where(a >= rb, 1.0, cap) + _UB_EPS


def interleave_probe_order(boosted_rank: np.ndarray,
                           a: np.ndarray) -> np.ndarray:
    """Per-query cluster probe order [b, kc]: the boost-aware ranking
    interleaved with pure centroid cosine (see ``IVFIndex.search`` for
    why both are needed), duplicates dropped at first occurrence."""
    b, kc = boosted_rank.shape
    order = np.empty((b, kc), np.int64)
    o_boost = np.argsort(-boosted_rank, axis=1, kind="stable")
    o_cos = np.argsort(-a, axis=1, kind="stable")
    for i in range(b):
        merged = np.ravel(np.column_stack((o_boost[i], o_cos[i])))
        _, first = np.unique(merged, return_index=True)
        order[i] = merged[np.sort(first)]
    return order


def ids_digest(keys) -> str:
    """Digest of the corpus layout the index state was computed against.

    ``keys`` must identify both the doc-id *ordering* and each doc's
    *content* (the engine passes ``"id\\x01sha256"`` strings —
    ``QueryEngine._ivf_state_key``): an in-place rewrite with no live
    index maintenance must invalidate adoption, because stale
    sig_union/radius bounds for the rewritten doc could *underestimate*
    its cluster and silently break the exactness guarantee.
    """
    h = hashlib.sha256()
    for k in keys:
        h.update(k.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


@dataclass(frozen=True)
class IVFSearchStats:
    """What one ``search`` actually scanned.

    The per-query EXPLAIN fields (``probe_order`` / ``kth_scores`` /
    ``unprobed_bounds``) are populated only under ``explain=True`` —
    empty tuples on the hot path, so steady-state search allocates
    nothing extra."""

    n_docs: int
    candidate_rows: int     # doc rows gathered + exactly scored
    clusters_probed: int
    n_clusters: int
    rounds: int             # probe-widening rounds (1 unless exact mode)
    probe_order: tuple = ()      # per-query tuples of probed cluster ids
    kth_scores: tuple = ()       # per-query final kth candidate score
    unprobed_bounds: tuple = ()  # per-query max unprobed bound (or None)

    @property
    def probed_fraction(self) -> float:
        return self.candidate_rows / max(self.n_docs, 1)


def _members_from_assign(assign: np.ndarray, n_clusters: int) -> tuple:
    """Per-cluster member rows, ascending (stable sort of 0..N-1 by
    cluster keeps row order — tie-breaking stays global)."""
    order = np.argsort(assign, kind="stable").astype(np.int32)
    sa = assign[order]
    starts = np.searchsorted(sa, np.arange(n_clusters))
    ends = np.searchsorted(sa, np.arange(n_clusters), side="right")
    return tuple(order[starts[c]: ends[c]] for c in range(n_clusters))


@dataclass(frozen=True)
class IVFIndex:
    """Immutable clustered-index state (see module docstring).

    ``sig_union``/``radius`` are safe upper/lower bounds under
    incremental maintenance: reassignment ORs bits into and lowers the
    radius of the *receiving* cluster; the vacated cluster keeps stale
    (superset/too-low) values until the next train or remap, which only
    makes the exactness bound conservative.
    """

    centroids: np.ndarray   # [kc, D] float32, ℓ2-normalized
    sig_union: np.ndarray   # [kc, W] int32 — OR of member signatures
    radius: np.ndarray      # [kc] float32 — min member·centroid dot
    assign: np.ndarray      # [N] int32 — row → cluster
    members: tuple          # kc × int32 arrays, ascending row indices
    drift: int              # rows that changed cluster since last train
    trained_n: int          # corpus size at last train
    seed: int

    # ---- construction ---------------------------------------------------

    @staticmethod
    def train(doc_vecs, doc_sigs, *, n_clusters: int | None = None,
              seed: int = 0, n_iter: int = 8) -> "IVFIndex":
        """Fit spherical k-means and derive the full index state."""
        cent, assign = spherical_kmeans(doc_vecs, n_clusters,
                                        seed=seed, n_iter=n_iter)
        return IVFIndex.from_assignments(
            cent, assign, doc_vecs, doc_sigs,
            drift=0, trained_n=len(assign), seed=seed,
        )

    @staticmethod
    def from_assignments(centroids, assign, doc_vecs, doc_sigs, *,
                         drift: int, trained_n: int,
                         seed: int) -> "IVFIndex":
        """Exact member/bound recomputation for a given assignment —
        O(N·D); used at train time and on layout restacks (which are
        already O(N) in the engine)."""
        centroids = np.asarray(centroids, np.float32)
        assign = np.asarray(assign, np.int32)
        kc = centroids.shape[0]
        sigs = _host(doc_sigs)
        sig_union = np.zeros((kc, sigs.shape[1] if sigs.ndim == 2 else 0),
                             np.int32)
        radius = np.ones((kc,), np.float32)
        if assign.size:
            np.bitwise_or.at(sig_union, assign, sigs.astype(np.int32))
            # cluster radius bound for pruning: the f64 probe margin
            # absorbs f32 rounding, and the exact rerank guards
            # correctness (the summation order differs from the JAX
            # package's host einsum)
            dots = _member_dots(doc_vecs, centroids, assign)
            np.minimum.at(radius, assign, dots.astype(np.float32))
        return IVFIndex(
            centroids=centroids, sig_union=sig_union, radius=radius,
            assign=assign, members=_members_from_assign(assign, kc),
            drift=int(drift), trained_n=int(trained_n), seed=int(seed),
        )

    # ---- persistence (KnowledgeBase.index_state dict) -------------------

    def state_dict(self, layout_keys) -> dict:
        """The container-facing state: raw arrays + scalars, pinned to
        the doc layout **and content** via ``ids_sha`` (see
        ``ids_digest``; core/ingest.py persists this as ``ivf_*``
        segments + ``meta["index"]``).  ``centroid_sha`` lets the
        persistence plane omit the centroid segment from delta records
        whose chain already carries it (centroids only change on
        retrain — the dominant byte term of an index delta)."""
        return {
            "kind": "ivf",
            "centroids": self.centroids,
            "sig_union": self.sig_union,
            "radius": self.radius,
            "assign": self.assign,
            "drift": int(self.drift),
            "trained_n": int(self.trained_n),
            "seed": int(self.seed),
            "ids_sha": ids_digest(layout_keys),
            "centroid_sha": hashlib.sha256(
                np.ascontiguousarray(self.centroids).tobytes()
            ).hexdigest(),
        }

    @staticmethod
    def from_state(state: dict) -> "IVFIndex":
        """Adopt persisted state verbatim — centroids, assignments and
        bounds are restored bit-identically (no retrain, no bound
        recomputation); only the member lists are rebuilt from the
        assignment array."""
        assign = np.asarray(state["assign"], np.int32)
        centroids = np.asarray(state["centroids"], np.float32)
        return IVFIndex(
            centroids=centroids,
            sig_union=np.asarray(state["sig_union"], np.int32),
            radius=np.asarray(state["radius"], np.float32),
            assign=assign,
            members=_members_from_assign(assign, centroids.shape[0]),
            drift=int(state["drift"]),
            trained_n=int(state["trained_n"]),
            seed=int(state["seed"]),
        )

    # ---- introspection --------------------------------------------------

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_docs(self) -> int:
        return len(self.assign)

    def needs_retrain(self, retrain_drift: float) -> bool:
        """Retrain once membership churn or corpus growth exceeds
        ``retrain_drift`` × the corpus size at the last train."""
        thresh = max(1.0, retrain_drift * max(self.trained_n, 1))
        return (self.drift >= thresh
                or abs(self.n_docs - self.trained_n) >= thresh)

    # ---- incremental maintenance (engine dirty-row log) -----------------

    def reassign(self, rows, row_vecs, row_sigs) -> "IVFIndex":
        """Move changed rows to their nearest centroid — O(U·kc·D).

        ``rows`` index docs whose *content* changed in place (engine
        layout unchanged); ``row_vecs``/``row_sigs`` are those rows
        *already gathered* ([U, D] / [U, W]) so an O(U) refresh never
        pays a full [N, ·] device→host transfer.  The receiving
        cluster's bounds widen (OR the signature, lower the radius);
        the vacated cluster keeps conservative stale bounds.  Returns a
        new index; ``drift`` grows by the number of rows that changed
        cluster.
        """
        rows = np.asarray(rows, np.int32)
        if rows.size == 0:
            return self
        sub = _host(row_vecs).astype(np.float32)
        # analysis: allow[unpinned-reduction] -- incremental reassign
        #   routing; the assignment never affects served scores
        sims = sub @ self.centroids.T                       # [U, kc]
        new = np.argmax(sims, axis=1).astype(np.int32)
        dots = sims[np.arange(rows.size), new]
        sigs = _host(row_sigs).astype(np.int32)

        assign = self.assign.copy()
        members = list(self.members)
        sig_union = self.sig_union.copy()
        radius = self.radius.copy()
        moved = 0
        for r, c, dot, sg in zip(rows, new, dots, sigs):
            old = assign[r]
            if old != c:
                m = members[old]
                members[old] = m[m != r]
                m = members[c]
                members[c] = np.insert(m, np.searchsorted(m, r), r)
                assign[r] = c
                moved += 1
            sig_union[c] |= sg
            radius[c] = min(radius[c], np.float32(dot))
        return replace(
            self, assign=assign, members=tuple(members),
            sig_union=sig_union, radius=radius, drift=self.drift + moved,
        )

    def remap(self, carried_assign: np.ndarray,
              doc_vecs, doc_sigs) -> "IVFIndex":
        """Rebuild after an engine layout restack (add/remove).

        ``carried_assign`` [new_N] carries each surviving row's old
        cluster; new/changed rows hold −1 and are assigned to their
        nearest centroid here.  Bounds and members are recomputed
        exactly (the restack is already O(N)); drift grows by the
        number of filled rows.
        """
        carried = np.asarray(carried_assign, np.int32).copy()
        fill = np.nonzero(carried < 0)[0]
        if fill.size:
            # gather only the filled rows before the host copy
            dv = torch.as_tensor(doc_vecs)
            sub = _host(dv.index_select(0, torch.from_numpy(
                fill.astype(np.int64)).to(dv.device))).astype(np.float32)
            # analysis: allow[unpinned-reduction] -- remap routing for the
            #   filled rows; routing only, the same argument as reassign
            carried[fill] = np.argmax(
                sub @ self.centroids.T, axis=1
            ).astype(np.int32)
        return IVFIndex.from_assignments(
            self.centroids, carried, doc_vecs, doc_sigs,
            drift=self.drift + int(fill.size),
            trained_n=self.trained_n, seed=self.seed,
        )

    # ---- the two-stage search -------------------------------------------

    def search(self, doc_vecs, doc_sigs, qv: np.ndarray, qs: np.ndarray, *,
               b: int, k: int, nprobe: int, guarantee: str,
               scoring_path: str, alpha: float, beta: float,
               explain: bool = False):
        """Probe + exact rerank → (vals, idx, cos, ind, stats), shaped
        like ``score_batch_arrays`` (idx are *global* doc rows).

        ``qv``/``qs`` may be padded past ``b`` (the engine's
        power-of-two query bucket); only the first ``b`` queries drive
        probing, but all padded rows are scored (their output is
        ignored by ``results_from_topk``).  ``explain=True``
        additionally materializes per-query probe tuples on the stats.
        """
        n, kc = self.n_docs, self.n_clusters
        kk = min(k, n)
        sizes = np.array([m.size for m in self.members], np.int64)
        _t = time.perf_counter() if obs_trace.active() else 0.0

        # -- probe plane (host, float64 for the exactness bound) ----------
        # analysis: allow[unpinned-reduction] -- f64 probe bound, clipped
        #   to [-1, 1]; prunes candidates only, the exact rerank follows
        a = np.clip(
            qv[:b].astype(np.float64) @ self.centroids.T.astype(np.float64),
            -1.0, 1.0,
        )                                                   # [b, kc]
        qsig = qs[:b].astype(np.int32)
        contain = np.all(
            (self.sig_union[None, :, :] & qsig[:, None, :])
            == qsig[:, None, :], axis=2,
        )                                                   # [b, kc] bool
        if guarantee == "exact":
            cos_ub = exact_cos_upper_bound(a, self.radius)
            ub = alpha * cos_ub + beta * contain            # score bound
            boosted_rank = ub
        else:
            ub = None
            boosted_rank = alpha * a + beta * contain       # optimistic HSF
        # probe order interleaves two rankings: boost-aware (an entity
        # query's target cluster has a tiny centroid cosine but a
        # discriminative signature-union hit) and pure centroid cosine
        # (on big clusters the Bloom union saturates, making `contain`
        # fire broadly — rank-by-boost alone would drown the semantic
        # neighborhoods a topical query needs).  With β = 0 the two
        # rankings coincide.
        order = interleave_probe_order(boosted_rank, a)

        # initial probe width: nprobe, widened until each query's own
        # probed clusters cover ≥ kk docs (so top-k is always full)
        p = np.full((b,), min(max(nprobe, 1), kc), np.int64)
        for i in range(b):
            csum = np.cumsum(sizes[order[i]])
            need = int(np.searchsorted(csum, kk)) + 1
            p[i] = min(max(p[i], need), kc)
        if _t:
            obs_trace.record("ivf_probe", _t, time.perf_counter() - _t,
                             clusters=kc, queries=b,
                             guarantee=guarantee)

        if guarantee == "exact":
            return self._search_exact(doc_vecs, doc_sigs, qv, qs, b=b,
                                      kk=kk, p=p, order=order, ub=ub,
                                      scoring_path=scoring_path,
                                      alpha=alpha, beta=beta,
                                      explain=explain)
        # probe mode: each query scores ONLY its own top-p clusters'
        # rows (one small dispatch per query through the shared gather
        # helper) — a batch of topically diverse queries doesn't
        # inflate each member's scan the way a batch-union gather would
        bp = qv.shape[0]
        vals = np.full((bp, kk), -np.inf, np.float32)
        idx = np.zeros((bp, kk), np.int32)
        cos = np.zeros((bp, kk), np.float32)
        ind = np.zeros((bp, kk), np.float32)
        tot_rows = tot_clusters = 0
        probe_orders, kth = [], []
        _t = time.perf_counter() if obs_trace.active() else 0.0
        for i in range(b):
            probe_c = order[i, : p[i]]
            if p[i] >= kc:
                cand = None  # everything probed: flat row range
                v, gi, cv, iv = score_batch_arrays(
                    doc_vecs, doc_sigs, qv[i: i + 1], qs[i: i + 1],
                    scoring_path=scoring_path, k=kk,
                    alpha=alpha, beta=beta, n_docs=n,
                )
            else:
                cand = np.sort(np.concatenate(
                    [self.members[c] for c in probe_c]
                ))
                v, gi, cv, iv = score_candidate_rows(
                    doc_vecs, doc_sigs, cand, qv[i: i + 1], qs[i: i + 1],
                    scoring_path=scoring_path, k=kk,
                    alpha=alpha, beta=beta,
                )
            vals[i], idx[i], cos[i], ind[i] = v[0], gi[0], cv[0], iv[0]
            tot_rows += n if cand is None else int(cand.size)
            tot_clusters += min(int(p[i]), kc)
            if explain:
                probe_orders.append(
                    tuple(int(c) for c in probe_c[: min(int(p[i]), kc)]))
                kth.append(float(vals[i, kk - 1]))
        if _t:
            obs_trace.record("ivf_rerank", _t, time.perf_counter() - _t,
                             mode="probe", rows=tot_rows, queries=b)
        stats = IVFSearchStats(
            n_docs=n,
            candidate_rows=tot_rows // max(b, 1),   # mean rows scanned
            clusters_probed=tot_clusters // max(b, 1),
            n_clusters=kc,
            rounds=1,
            probe_order=tuple(probe_orders),
            kth_scores=tuple(kth),
            unprobed_bounds=(None,) * b if explain else (),
        )
        return vals, idx, cos, ind, stats

    def _search_exact(self, doc_vecs, doc_sigs, qv, qs, *, b, kk, p,
                      order, ub, scoring_path, alpha, beta,
                      explain=False):
        """Probe-widening rounds over the batch-union candidate set.

        The union gather uses the 2D subset formulation verified
        bit-identical to the flat scan; scoring every query against the
        whole union is a superset per query (recall can only improve)
        and the stop test treats the union as probed for everyone.
        """
        n, kc = self.n_docs, self.n_clusters
        sizes = np.array([m.size for m in self.members], np.int64)
        rounds = 0
        while True:
            rounds += 1
            _tr = time.perf_counter() if obs_trace.active() else 0.0
            probed = np.unique(np.concatenate(
                [order[i, : p[i]] for i in range(b)]
            )) if b else np.arange(kc)
            if probed.size >= kc or sizes[probed].sum() * 2 > n:
                # probe set collapsed to (most of) everything: flat scan
                # — trivially exact, and past ~50% of the rows the full
                # contiguous dispatch beats gathering
                cand = None
                vals, idx, cos, ind = score_batch_arrays(
                    doc_vecs, doc_sigs, qv, qs,
                    scoring_path=scoring_path, k=kk,
                    alpha=alpha, beta=beta, n_docs=n,
                )
            else:
                cand = np.sort(np.concatenate(
                    [self.members[c] for c in probed]
                )) if probed.size else np.zeros((0,), np.int32)
                vals, idx, cos, ind = score_candidate_rows(
                    doc_vecs, doc_sigs, cand, qv, qs,
                    scoring_path=scoring_path, k=kk,
                    alpha=alpha, beta=beta,
                )
            if _tr:
                obs_trace.record(
                    "ivf_widen_round", _tr, time.perf_counter() - _tr,
                    round=rounds,
                    rows=n if cand is None else int(cand.size),
                    clusters=kc if cand is None else int(probed.size))
            if cand is None:
                break
            # stop test: the k-th best exact score must strictly beat
            # every unprobed cluster's bound (ties could displace by
            # doc-index order, so they force another round)
            mask = np.zeros((kc,), bool)
            mask[probed] = True
            done = True
            for i in range(b):
                un = ub[i][~mask]
                if un.size and float(vals[i, kk - 1]) <= un.max():
                    p[i] = min(p[i] * 2, kc)
                    done = False
            if done:
                break
        probe_orders, kth, bounds = [], [], []
        if explain:
            if cand is None:
                mask = np.ones((kc,), bool)   # flat-scan collapse
            else:
                mask = np.zeros((kc,), bool)
                mask[probed] = True
            for i in range(b):
                own = order[i, : min(int(p[i]), kc)]
                probe_orders.append(tuple(int(c) for c in own))
                kth.append(float(vals[i, kk - 1]))
                un = ub[i][~mask]
                bounds.append(float(un.max()) if un.size else None)
        stats = IVFSearchStats(
            n_docs=n,
            candidate_rows=n if cand is None else int(cand.size),
            clusters_probed=kc if cand is None else int(probed.size),
            n_clusters=kc,
            rounds=rounds,
            probe_order=tuple(probe_orders),
            kth_scores=tuple(kth),
            unprobed_bounds=tuple(bounds),
        )
        return vals, idx, cos, ind, stats


# --------------------------------------------------------------------------
# candidate-gather scoring (shared by IVF rerank + the postings prefilter)
# --------------------------------------------------------------------------

def score_candidate_rows(doc_vecs, doc_sigs, cand_rows: np.ndarray,
                         qv: np.ndarray, qs: np.ndarray, *,
                         scoring_path: str, k: int,
                         alpha: float, beta: float):
    """Gather a global candidate-row subset and score it exactly.

    ``cand_rows`` must be ascending global row indices — gathered-row
    order then equals global order, so the (score desc, id asc) tie
    rule matches the flat scan, and the returned ``idx`` are mapped back
    to *global* rows.  The rows are gathered on the doc tensors' device
    with one ``index_select`` each (the index list crosses once) and
    scored through ``score_batch_arrays`` — the same machinery (map /
    gemm / fused CUDA kernel) the flat paths dispatch, which is what
    makes subset scores bit-identical to the corresponding rows of the
    full scan.  Eager PyTorch compiles nothing per shape, so the subset
    is not padded to a power-of-two bucket as the JAX package pads it.
    """
    cand = np.ascontiguousarray(cand_rows, np.int32)
    n = int(cand.size)
    kk = min(k, n)
    rows = torch.from_numpy(cand.astype(np.int64)).to(doc_vecs.device)
    sub_vecs = doc_vecs.index_select(0, rows)
    sub_sigs = doc_sigs.index_select(0, rows)
    vals, idx, cos, ind = score_batch_arrays(
        sub_vecs, sub_sigs, qv, qs, scoring_path=scoring_path, k=kk,
        alpha=alpha, beta=beta, n_docs=n,
    )
    return vals, cand[idx], cos, ind
