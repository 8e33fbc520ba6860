"""Sharded IVF retrieval plane: the cluster index partitioned over a
shard mesh (PyTorch port of the JAX package's ``index/sharded.py``;
docs/ARCHITECTURE.md §10).

Each shard owns a disjoint subset of the IVF *clusters* — centroids
stay global (the probe plane is k_clusters ≈ √N, host-cheap), but every
cluster's member rows live on exactly one shard: the shard holds a
padded block of those rows' vectors and signatures, gathered in
ascending global-row order, on its own device (``launch.mesh``: one
device per shard, or logical shards on one device).  A query then runs:

1. **Global probe (host).**  Score the [k_clusters, D] centroid matrix
   once — the same interleaved probe order and (in exact mode) the same
   spherical-cap bound as the flat IVF path (``ivf.exact_cos_upper_bound``
   / ``ivf.interleave_probe_order``), restricted per shard through the
   cluster→shard ownership map.

2. **Local rerank (per shard).**  Each shard gathers its probed
   clusters' member rows from its resident block and scores them with
   the *bit-stable map formulation* (``hsf.stable_rowdot``'s products
   and add tree, batched over queries in chunks of a fixed byte budget),
   reducing to a local top-k.  Only the per-shard ``[B, k]`` (vals,
   global ids, cos, contain) tuples leave the shard's device.

3. **Stable merge (host).**  The S·k candidates merge by
   (score desc, global id asc) — the flat scan's tie rule, because each
   shard's local candidate order is the global row order restricted to
   that shard.  The merge reads the shards' results to the host after
   every widen round: a sync by design.

Exactness (``guarantee="exact"``): per-shard probe widths double until
the *merged* k-th exact score strictly beats every unprobed cluster's
cap bound in every shard (ties widen).  Per-shard local top-k + stable
merge then reconstruct the flat scan's top-k bit for bit, at any shard
count: the partition decides only *where* a cluster is scored, never
*what* is scored (tests/test_torch_sharded.py, ``chip_smoke.py`` phase
12).

Incremental maintenance routes dirty rows to their owning shard off the
engine's dirty-row log: content-only changes patch the owning shard's
block (a patched clone of that shard's block: the plane a snapshot
pinned is never written) when the idf statistics held still; rows whose
nearest centroid moved to a cluster on another shard regather just the
affected shards' blocks; a shard that outgrows its power-of-two row
bucket, an idf move and a layout restack rebuild the plane.  All updates
return a **new** ``ShardedIVFIndex``, so a serving snapshot pins one
generation's every shard block with one reference.  Every block is
gathered on the device (``index_select``): the doc matrix never goes to
the host.

Persistence: ``state_dict`` extends the flat IVF state with the
cluster→shard map (segment ``ivf_shard_of_cluster``) and ``n_shards``,
under the same ``kind="ivf"`` — a sharded engine adopts a flat-written
state (deriving a deterministic partition) and vice versa, in either
package, and the same ``ids_sha`` content digest rejects stale state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import hsf
from repro_torch.core.hsf import batched_rowdot
from repro_torch.core.engine import _bucket
from repro_torch.index.ivf import (
    IVFIndex,
    IVFSearchStats,
    exact_cos_upper_bound,
    interleave_probe_order,
)
from repro_torch.launch.mesh import make_shard_mesh, placement
from repro_torch.obs import trace as obs_trace

# pad sentinel for invalid rows in a shard's local top-k — loses every
# (score desc, id asc) merge (the sentinel of the fused kernel too)
_SENTINEL = np.int32(2**31 - 1)
# bytes of the [queries, candidates, D] f32 products one rerank chunk
# holds (the add tree's temporaries are half of it, then a quarter, ...)
RERANK_CHUNK_BYTES = 1 << 30


@dataclass(frozen=True)
class ShardedIVFSearchStats(IVFSearchStats):
    """Flat-IVF probe accounting plus the distribution terms."""

    n_shards: int = 1
    merge_seconds: float = 0.0   # host-side stable-merge time (all rounds)


def partition_clusters(sizes, n_shards: int) -> np.ndarray:
    """Deterministic balanced partition: cluster → shard.

    Greedy longest-processing-time: clusters sorted by (size desc,
    id asc) each go to the least-loaded shard (ties → lowest shard id).
    Pure function of (sizes, n_shards), so every engine that derives a
    partition for the same index state derives the *same* one — which
    is what lets a flat-written container adopt into a sharded engine
    reproducibly.
    """
    sizes = np.asarray(sizes, np.int64)
    out = np.zeros((sizes.size,), np.int32)
    load = np.zeros((n_shards,), np.int64)
    for c in np.lexsort((np.arange(sizes.size), -sizes)):
        s = int(np.argmin(load))        # argmin takes the lowest index on ties
        out[c] = s
        load[s] += sizes[c]
    return out


# --------------------------------------------------------------------------
# per-shard local scorer (the map formulation, over a resident block)
# --------------------------------------------------------------------------

def _containment_rows(sigs: torch.Tensor, q_sigs: torch.Tensor):
    """``hsf.containment(sigs, q)`` for every row q of ``q_sigs``:
    float32 [B, n]."""
    qs = q_sigs[:, None, :]
    return torch.all((sigs[None, :, :] & qs) == qs, dim=-1).to(torch.float32)


def _shard_topk_core(sub_v, sub_s, sub_g, qv, qs, *, kk, alpha, beta):
    """Local top-k over one shard's gathered candidates.

    ``sub_v``/``sub_s``/``sub_g`` are the candidate rows [C, D]/[C, W]/[C]
    in ascending global-row order (so the stable top-k's index-ascending
    tie rule matches the flat scan).  The cosine is ``batched_rowdot`` in
    query chunks of ``RERANK_CHUNK_BYTES`` — each candidate's score is
    bit-identical to its row in the full scan, whatever the block height,
    chunk or device.  Returns (vals, gids, cos, ind), each [B, kk'],
    kk' = min(kk, C).
    """
    c, d = sub_v.shape
    b = qv.shape[0]
    step = max(1, RERANK_CHUNK_BYTES // max(1, 4 * c * max(d, 1)))
    cos = torch.empty((b, c), dtype=torch.float32, device=sub_v.device)
    ind = torch.empty((b, c), dtype=torch.float32, device=sub_v.device)
    for q0 in range(0, b, step):
        cos[q0:q0 + step] = batched_rowdot(sub_v, qv[q0:q0 + step])
        ind[q0:q0 + step] = _containment_rows(sub_s, qs[q0:q0 + step])
    scores = alpha * cos + beta * ind
    vals, li = hsf.top_k(scores, min(kk, c))
    gi = torch.where(vals > float("-inf"), sub_g[li],
                     torch.full_like(li, int(_SENTINEL), dtype=torch.int32))
    return (vals, gi, torch.gather(cos, 1, li),
            torch.gather(ind, 1, li))


def _gather_shard_block(doc_vecs, doc_sigs, rows: np.ndarray, block_len: int,
                        device):
    """One shard's padded resident block, gathered on the doc tensors'
    device and placed on ``device``: (vecs [L, D] f32, sigs [L, W] int32,
    gids [L] int32); rows past ``rows.size`` are zero with sentinel ids."""
    dim, w = doc_vecs.shape[1], doc_sigs.shape[1]
    dv = torch.zeros((block_len, dim), dtype=torch.float32, device=device)
    ds = torch.zeros((block_len, w), dtype=torch.int32, device=device)
    gid = np.full((block_len,), _SENTINEL, np.int32)
    if rows.size:
        idx = torch.from_numpy(rows.astype(np.int64)).to(doc_vecs.device)
        dv[: rows.size] = doc_vecs.index_select(0, idx).to(device,
                                                            torch.float32)
        ds[: rows.size] = doc_sigs.index_select(0, idx).to(device,
                                                           torch.int32)
        gid[: rows.size] = rows
    return dv, ds, torch.from_numpy(gid).to(device)


@dataclass(frozen=True)
class ShardedIVFIndex:
    """Immutable cluster-sharded index plane (see module docstring).

    ``base`` carries the global IVF state (centroids, bounds, assign,
    members) — probing, maintenance bookkeeping and persistence all
    delegate to it, so the sharded plane prunes with the same bound the
    flat IVF search uses.  The fields below it are the distribution
    plane: ownership, per-shard row sets, and the padded resident blocks
    the local reranks score, one per shard on that shard's device.
    """

    base: IVFIndex
    n_shards: int
    shard_of_cluster: np.ndarray  # [kc] int32 — cluster → owning shard
    shard_rows: tuple             # S × int32 [n_s] ascending global rows
    block_len: int                # L — power-of-two row pad per shard
    dv_blocks: tuple              # S × torch [L, D] f32, on devices[s]
    ds_blocks: tuple              # S × torch [L, W] int32
    gid_blocks: tuple             # S × torch [L] int32 (pad = sentinel)
    devices: tuple                # S × torch.device (launch.mesh)

    # ---- construction ---------------------------------------------------

    @staticmethod
    def train(doc_vecs, doc_sigs, *, n_clusters: int | None = None,
              seed: int = 0, n_iter: int = 8,
              n_shards: int = 1) -> "ShardedIVFIndex":
        """Fit the (partition-independent) k-means, then shard it."""
        base = IVFIndex.train(doc_vecs, doc_sigs, n_clusters=n_clusters,
                              seed=seed, n_iter=n_iter)
        return ShardedIVFIndex.from_base(base, doc_vecs, doc_sigs,
                                         n_shards=n_shards)

    @staticmethod
    def from_base(base: IVFIndex, doc_vecs, doc_sigs, *, n_shards: int,
                  shard_of_cluster=None) -> "ShardedIVFIndex":
        """Build the distribution plane over an existing IVF state.

        ``shard_of_cluster`` overrides the deterministic balanced
        partition (tests use it for degenerate all-in-one-shard
        ownership); it must map every cluster to [0, n_shards).
        """
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if shard_of_cluster is None:
            sizes = [m.size for m in base.members]
            shard_of_cluster = partition_clusters(sizes, n_shards)
        else:
            shard_of_cluster = np.asarray(shard_of_cluster, np.int32)
            if shard_of_cluster.shape != (base.n_clusters,):
                raise ValueError(
                    f"shard_of_cluster must have shape ({base.n_clusters},), "
                    f"got {shard_of_cluster.shape}"
                )
            if shard_of_cluster.size and (
                    shard_of_cluster.min() < 0
                    or shard_of_cluster.max() >= n_shards):
                raise ValueError("shard_of_cluster entries must lie in "
                                 f"[0, {n_shards})")
        shard_rows = _shard_rows_from(base, shard_of_cluster, n_shards)
        return _build_plane(base, n_shards, shard_of_cluster, shard_rows,
                            doc_vecs, doc_sigs)

    @staticmethod
    def from_state(state: dict, doc_vecs, doc_sigs, *,
                   n_shards: int) -> "ShardedIVFIndex":
        """Adopt persisted IVF state (flat- or sharded-written, by either
        package) — bit-identical bounds/assignments, no retrain; the
        persisted partition is reused when it was written for the same
        shard count, else a deterministic one is derived."""
        base = IVFIndex.from_state(state)
        soc = state.get("shard_of_cluster")
        if soc is not None and int(state.get("n_shards", -1)) == n_shards:
            soc = np.asarray(soc, np.int32)
        else:
            soc = None
        return ShardedIVFIndex.from_base(base, doc_vecs, doc_sigs,
                                         n_shards=n_shards,
                                         shard_of_cluster=soc)

    def state_dict(self, layout_keys) -> dict:
        """The flat IVF state plus the ownership map — still
        ``kind="ivf"`` so flat and sharded engines adopt each other's
        containers (core/ingest.py journals ``ivf_shard_of_cluster`` as
        one more index segment)."""
        st = self.base.state_dict(layout_keys)
        st["n_shards"] = int(self.n_shards)
        st["shard_of_cluster"] = self.shard_of_cluster
        return st

    # ---- delegation (engine/serving introspection + tests) --------------

    @property
    def mesh(self) -> tuple | None:
        """The shard devices when every shard has a device of its own,
        else None (logical shards), as the JAX package's ``mesh``."""
        return self.devices if placement(self.devices) == "mesh" else None

    @property
    def placement(self) -> str:
        return placement(self.devices)

    @property
    def n_clusters(self) -> int:
        return self.base.n_clusters

    @property
    def n_docs(self) -> int:
        return self.base.n_docs

    @property
    def centroids(self) -> np.ndarray:
        return self.base.centroids

    @property
    def assign(self) -> np.ndarray:
        return self.base.assign

    @property
    def members(self) -> tuple:
        return self.base.members

    @property
    def sig_union(self) -> np.ndarray:
        return self.base.sig_union

    @property
    def radius(self) -> np.ndarray:
        return self.base.radius

    @property
    def drift(self) -> int:
        return self.base.drift

    @property
    def trained_n(self) -> int:
        return self.base.trained_n

    @property
    def seed(self) -> int:
        return self.base.seed

    def needs_retrain(self, retrain_drift: float) -> bool:
        return self.base.needs_retrain(retrain_drift)

    def shard_sizes(self) -> list[int]:
        return [int(r.size) for r in self.shard_rows]

    # ---- incremental maintenance (engine dirty-row log) -----------------

    def reassign(self, rows, row_vecs, row_sigs, doc_vecs, doc_sigs, *,
                 reweighted: bool = False) -> "ShardedIVFIndex":
        """Route dirty rows to their owning shard.

        Delegates the cluster moves and bound widening to
        ``base.reassign`` (same drift accounting as the flat index),
        then repairs the plane: rows whose old and new clusters live on
        the same shard only need their block content patched (O(U) rows
        written into a clone of that shard's block — the shard's row set
        didn't change); rows that crossed shards invalidate both shards'
        row sets, so those shards' blocks regather from the live doc
        tensors on the device (never O(N) unless a shard outgrew its pad
        bucket, which rebuilds the plane like a restack).

        ``reweighted=True`` signals that the engine's refresh moved the
        idf statistics, i.e. *every* doc vector was rebuilt, not just
        the dirty rows — the resident blocks then regather in full (the
        refresh already paid O(N·D) for the reweight).
        """
        rows = np.asarray(rows, np.int32)
        if rows.size == 0:
            return self
        new_base = self.base.reassign(rows, row_vecs, row_sigs)
        if reweighted:
            return ShardedIVFIndex.from_base(
                new_base, doc_vecs, doc_sigs, n_shards=self.n_shards,
                shard_of_cluster=self.shard_of_cluster,
            )
        old_shard = self.shard_of_cluster[self.base.assign[rows]]
        new_shard = self.shard_of_cluster[new_base.assign[rows]]
        crossed = np.unique(np.concatenate(
            [old_shard[old_shard != new_shard],
             new_shard[old_shard != new_shard]]
        ))
        if crossed.size:
            new_rows = _shard_rows_from(new_base, self.shard_of_cluster,
                                        self.n_shards)
            if max(r.size for r in new_rows) > self.block_len:
                # a shard outgrew the row bucket: rebuild (rare — the
                # bucket doubles, so this amortizes like the restack)
                return _build_plane(new_base, self.n_shards,
                                    self.shard_of_cluster, new_rows,
                                    doc_vecs, doc_sigs)
        else:
            new_rows = self.shard_rows

        doc_vecs = torch.as_tensor(doc_vecs)
        doc_sigs = torch.as_tensor(doc_sigs)
        dv_b, ds_b, gid_b = (list(self.dv_blocks), list(self.ds_blocks),
                             list(self.gid_blocks))
        # regather the shards whose row sets changed
        for s in crossed:
            s = int(s)
            dv_b[s], ds_b[s], gid_b[s] = _gather_shard_block(
                doc_vecs, doc_sigs, new_rows[s], self.block_len,
                self.devices[s])

        # patch content for rows that stayed on their shard: one clone
        # per touched shard, then one scatter of its rows
        crossed_set = set(int(s) for s in crossed)
        keep = np.array([int(new_shard[j]) not in crossed_set
                         and int(old_shard[j]) not in crossed_set
                         for j in range(rows.size)], bool)
        if keep.any():
            vec_rows = torch.as_tensor(row_vecs)
            sig_rows = torch.as_tensor(row_sigs)
            for s in np.unique(new_shard[keep]):
                s = int(s)
                sel = np.nonzero(keep & (new_shard == s))[0]
                local = np.searchsorted(new_rows[s], rows[sel]).astype(
                    np.int64)
                dev = self.devices[s]
                li = torch.from_numpy(local).to(dev)
                src = torch.from_numpy(sel.astype(np.int64)).to(
                    vec_rows.device)
                dv_b[s] = dv_b[s].clone()
                dv_b[s][li] = vec_rows.index_select(0, src).to(
                    dev, torch.float32)
                ds_b[s] = ds_b[s].clone()
                ds_b[s][li] = sig_rows.index_select(
                    0, src.to(sig_rows.device)).to(dev, torch.int32)
        return replace(self, base=new_base, shard_rows=new_rows,
                       dv_blocks=tuple(dv_b), ds_blocks=tuple(ds_b),
                       gid_blocks=tuple(gid_b))

    def remap(self, carried_assign, doc_vecs, doc_sigs) -> "ShardedIVFIndex":
        """Rebuild after an engine layout restack — the restack is
        already O(N), so the plane regathers in full.  Centroids (and
        therefore the partition) are unchanged."""
        new_base = self.base.remap(carried_assign, doc_vecs, doc_sigs)
        return ShardedIVFIndex.from_base(
            new_base, doc_vecs, doc_sigs, n_shards=self.n_shards,
            shard_of_cluster=self.shard_of_cluster,
        )

    # ---- the sharded two-stage search -----------------------------------

    def search(self, doc_vecs, doc_sigs, qv: np.ndarray, qs: np.ndarray, *,
               b: int, k: int, nprobe: int, guarantee: str,
               scoring_path: str, alpha: float, beta: float,
               explain: bool = False):
        """Probe globally, rerank per shard, merge stably → the same
        (vals, idx, cos, ind, stats) contract as ``IVFIndex.search``
        (idx are global doc rows).

        ``doc_vecs``/``doc_sigs`` and ``scoring_path`` are accepted for
        signature compatibility: the shards score their resident blocks,
        always with the bit-stable map formulation (the engine rejects
        explicit gemm/kernel for this index kind).  In exact mode,
        per-(query, shard) probe widths double until the merged k-th
        exact score strictly beats every unprobed cluster's
        spherical-cap bound in that shard; in probe mode each shard
        scores the batch union of its queries' top-``nprobe`` local
        clusters in a single round (a per-query superset of the flat
        IVF probe — recall can only improve).
        """
        del doc_vecs, doc_sigs, scoring_path
        base = self.base
        n, kc, S = base.n_docs, base.n_clusters, self.n_shards
        kk = min(k, n)
        sizes = np.array([m.size for m in base.members], np.int64)
        _t = time.perf_counter() if obs_trace.active() else 0.0

        # -- global probe plane (host, float64 bound) ---------------------
        # analysis: allow[unpinned-reduction] -- f64 probe bound, clipped
        #   to [-1, 1]; prunes candidates only, the exact rerank follows
        a = np.clip(
            qv[:b].astype(np.float64) @ base.centroids.T.astype(np.float64),
            -1.0, 1.0,
        )
        qsig = qs[:b].astype(np.int32)
        contain = np.all(
            (base.sig_union[None, :, :] & qsig[:, None, :])
            == qsig[:, None, :], axis=2,
        )
        if guarantee == "exact":
            ub = alpha * exact_cos_upper_bound(a, base.radius) \
                + beta * contain
            rank = ub
        else:
            ub = None
            rank = alpha * a + beta * contain
        order = interleave_probe_order(rank, a)             # [b, kc]

        # restrict the global order to each shard's clusters (the
        # restriction of a permutation is a permutation of the subset,
        # so per-shard probing follows the same priority as the flat
        # IVF search would within that shard)
        soc = self.shard_of_cluster
        shard_orders = []
        for s in range(S):
            own = soc[order] == s                           # [b, kc] bool
            kc_s = int((soc == s).sum())
            shard_orders.append(
                order[own].reshape(b, kc_s) if kc_s else
                np.empty((b, 0), np.int64)
            )

        # initial probe width per (shard, query): nprobe clamped to the
        # shard's cluster count, widened until the shard's own probed
        # clusters cover ≥ min(kk, n_s) docs — summed over shards that
        # guarantees ≥ kk real candidates, so the merged top-k is full
        p = np.zeros((S, b), np.int64)
        for s in range(S):
            kc_s = shard_orders[s].shape[1]
            if kc_s == 0:
                continue
            n_s = int(self.shard_rows[s].size)
            need_docs = min(kk, n_s)
            for i in range(b):
                csum = np.cumsum(sizes[shard_orders[s][i]])
                need = int(np.searchsorted(csum, need_docs)) + 1
                p[s, i] = min(max(min(max(nprobe, 1), kc_s), need), kc_s)

        if _t:
            obs_trace.record("shard_probe", _t, time.perf_counter() - _t,
                             clusters=kc, shards=S, queries=b,
                             guarantee=guarantee)
        shard_cluster_ids = [np.nonzero(soc == s)[0] for s in range(S)]
        # the queries cross to each shard's device once per search
        q_dev = {}
        for dev in dict.fromkeys(self.devices):
            q_dev[dev] = (torch.from_numpy(np.ascontiguousarray(qv)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(qs)).to(dev))
        rounds = 0
        merge_seconds = 0.0
        while True:
            rounds += 1
            _tr = time.perf_counter() if obs_trace.active() else 0.0
            cand_local: list[np.ndarray | None] = []
            probed_global: list[np.ndarray] = []
            for s in range(S):
                kc_s = shard_orders[s].shape[1]
                n_s = int(self.shard_rows[s].size)
                if kc_s == 0 or n_s == 0:
                    cand_local.append(np.zeros((0,), np.int32))
                    probed_global.append(shard_cluster_ids[s])
                    continue
                probed = np.unique(np.concatenate(
                    [shard_orders[s][i, : p[s, i]] for i in range(b)]
                ))
                if probed.size >= kc_s or sizes[probed].sum() * 2 > n_s:
                    # ≥50% of the shard probed: score the whole resident
                    # block — the shard-local analogue of the flat-scan
                    # collapse, trivially exact for this shard
                    cand_local.append(None)
                    probed_global.append(shard_cluster_ids[s])
                else:
                    gmem = np.sort(np.concatenate(
                        [base.members[c] for c in probed]
                    ))
                    cand_local.append(np.searchsorted(
                        self.shard_rows[s], gmem).astype(np.int32))
                    probed_global.append(probed)
            n_cand = np.array(
                [self.shard_rows[s].size if c is None else c.size
                 for s, c in enumerate(cand_local)], np.int64)
            svals, sgids, scos, sind = self._dispatch(
                cand_local, q_dev, kk, alpha, beta)
            t0 = time.perf_counter()
            vals, idx, cos, ind = _merge_shard_topk(
                svals, sgids, scos, sind, kk
            )
            t1 = time.perf_counter()
            merge_seconds += t1 - t0
            if _tr:
                obs_trace.record("shard_merge", t0, t1 - t0,
                                 shards=S, round=rounds)
                obs_trace.record("shard_round", _tr, t1 - _tr,
                                 round=rounds,
                                 candidates=int(n_cand.sum()))

            if ub is None:
                break
            # stop test, per (query, shard): the merged k-th exact score
            # must strictly beat every unprobed cluster's bound in every
            # shard (ties could displace by doc-index order → widen)
            done = True
            for s in range(S):
                kc_s = shard_orders[s].shape[1]
                if kc_s == 0 or probed_global[s].size >= kc_s:
                    continue
                mask = np.zeros((kc,), bool)
                mask[probed_global[s]] = True
                un = shard_cluster_ids[s][~mask[shard_cluster_ids[s]]]
                for i in range(b):
                    if float(vals[i, kk - 1]) <= ub[i, un].max():
                        p[s, i] = min(p[s, i] * 2, kc_s)
                        done = False
            if done:
                break

        probe_orders, kth, bounds = [], [], []
        if explain:
            mask = np.zeros((kc,), bool)
            for pg in probed_global:
                mask[pg] = True
            for i in range(b):
                own = np.concatenate([
                    shard_orders[s][i, : min(int(p[s, i]),
                                             shard_orders[s].shape[1])]
                    for s in range(S)
                ]) if S else np.zeros((0,), np.int64)
                probe_orders.append(tuple(int(c) for c in own))
                kth.append(float(vals[i, kk - 1]))
                if ub is None:
                    bounds.append(None)
                else:
                    un = ub[i][~mask]
                    bounds.append(float(un.max()) if un.size else None)
        stats = ShardedIVFSearchStats(
            n_docs=n,
            candidate_rows=int(n_cand.sum()),
            clusters_probed=int(sum(pg.size for pg in probed_global)),
            n_clusters=kc,
            rounds=rounds,
            probe_order=tuple(probe_orders),
            kth_scores=tuple(kth),
            unprobed_bounds=tuple(bounds),
            n_shards=S,
            merge_seconds=merge_seconds,
        )
        return vals, idx, cos, ind, stats

    def _dispatch(self, cand_local, q_dev, kk, alpha, beta):
        """One rerank round → numpy (vals, gids, cos, ind), each
        [S, Bp, kk].  Each shard scores its candidates (``None``: its
        whole block, as a view) on its own device; the launches of all
        shards are queued before the first result is read back, so the
        shards of a mesh run at once.  A shard with fewer than kk
        candidates pads its list with (-inf, sentinel) rows, which lose
        every merge."""
        outs = []
        for s, cand in enumerate(cand_local):
            n_s = int(self.shard_rows[s].size)
            rows = n_s if cand is None else int(cand.size)
            with obs_trace.span("shard_local_topk", shard=s, rows=rows):
                dev = self.devices[s]
                qv, qs = q_dev[dev]
                if rows == 0:
                    outs.append(None)
                    continue
                if cand is None:
                    sub = (self.dv_blocks[s][:n_s], self.ds_blocks[s][:n_s],
                           self.gid_blocks[s][:n_s])
                else:
                    li = torch.from_numpy(cand.astype(np.int64)).to(dev)
                    sub = (self.dv_blocks[s].index_select(0, li),
                           self.ds_blocks[s].index_select(0, li),
                           self.gid_blocks[s].index_select(0, li))
                o = _shard_topk_core(*sub, qv, qs, kk=kk, alpha=float(alpha),
                                     beta=float(beta))
                if obs_trace.active() and dev.type == "cuda":
                    # analysis: allow[host-sync] -- tracing/explain-only
                    #   sync: attributes the shard's device time to its
                    #   span; never runs when neither a trace nor an
                    #   EXPLAIN collector is active
                    torch.cuda.current_stream(dev).synchronize()
                outs.append(o)
        bp = next(iter(q_dev.values()))[0].shape[0]
        v = np.full((self.n_shards, bp, kk), -np.inf, np.float32)
        g = np.full((self.n_shards, bp, kk), _SENTINEL, np.int32)
        c = np.zeros((self.n_shards, bp, kk), np.float32)
        d = np.zeros((self.n_shards, bp, kk), np.float32)
        for s, o in enumerate(outs):
            if o is None:
                continue
            w = o[0].shape[1]
            v[s, :, :w] = o[0].cpu().numpy()
            g[s, :, :w] = o[1].cpu().numpy()
            c[s, :, :w] = o[2].cpu().numpy()
            d[s, :, :w] = o[3].cpu().numpy()
        return v, g, c, d


# --------------------------------------------------------------------------
# plane construction + merge
# --------------------------------------------------------------------------

def _shard_rows_from(base: IVFIndex, shard_of_cluster: np.ndarray,
                     n_shards: int) -> tuple:
    """Ascending global member rows per shard (union of owned clusters)."""
    out = []
    for s in range(n_shards):
        own = np.nonzero(shard_of_cluster == s)[0]
        if own.size:
            rows = np.sort(np.concatenate(
                [base.members[c] for c in own]
            )).astype(np.int32)
        else:
            rows = np.zeros((0,), np.int32)
        out.append(rows)
    return tuple(out)


def _build_plane(base: IVFIndex, n_shards: int, shard_of_cluster: np.ndarray,
                 shard_rows: tuple, doc_vecs, doc_sigs) -> ShardedIVFIndex:
    """Materialize the per-shard resident blocks (an O(N) gather on the
    device — only at train/adopt/restack time, never on the query
    path)."""
    doc_vecs, doc_sigs = torch.as_tensor(doc_vecs), torch.as_tensor(doc_sigs)
    L = _bucket(max(1, max((r.size for r in shard_rows), default=1)))
    devices = make_shard_mesh(n_shards, doc_vecs.device)
    blocks = [_gather_shard_block(doc_vecs, doc_sigs, rows, L, devices[s])
              for s, rows in enumerate(shard_rows)]
    return ShardedIVFIndex(
        base=base, n_shards=int(n_shards),
        shard_of_cluster=np.asarray(shard_of_cluster, np.int32),
        shard_rows=shard_rows, block_len=int(L),
        dv_blocks=tuple(b[0] for b in blocks),
        ds_blocks=tuple(b[1] for b in blocks),
        gid_blocks=tuple(b[2] for b in blocks),
        devices=devices,
    )


def _merge_shard_topk(vals, gids, cos, ind, kk: int):
    """Stable global merge of per-shard top-k lists.

    Sort key (score desc, global id asc) — the flat scan's tie rule.
    Sentinel-id rows carry -inf scores and lose every comparison; the
    per-shard coverage widening guarantees ≥ kk real candidates, so they
    never surface.
    """
    s, bp, kl = vals.shape
    v = np.swapaxes(vals, 0, 1).reshape(bp, s * kl)
    g = np.swapaxes(gids, 0, 1).reshape(bp, s * kl)
    c = np.swapaxes(cos, 0, 1).reshape(bp, s * kl)
    d = np.swapaxes(ind, 0, 1).reshape(bp, s * kl)
    pick = np.lexsort((g, -v), axis=-1)[:, :kk]
    return (np.take_along_axis(v, pick, axis=1),
            np.take_along_axis(g, pick, axis=1).astype(np.int32),
            np.take_along_axis(c, pick, axis=1),
            np.take_along_axis(d, pick, axis=1))
