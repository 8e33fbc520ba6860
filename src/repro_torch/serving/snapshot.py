"""Generation-pinned snapshots: immutable read plane over a live engine.

The concurrency model mirrors the sharded container's manifest design
(core/container.py): readers pin a *generation*; the single writer
builds the next one and publishes it with one atomic reference swap.
Applied to the query plane:

- ``EngineSnapshot`` freezes everything a query needs at generation
  *g*: the device-resident doc matrix + signature matrix (torch
  tensors that nothing writes after they are bound — ``refresh()``
  patches a clone and *rebinds* the engine's attributes, so a captured
  tensor can never be half-updated), the doc
  id layout, and a **copy** of the vectorizer's idf state (df array +
  doc count) so query vectors are built against *g*'s statistics, not
  whatever the live ingest thread has mutated df to meanwhile.  Its
  ``query_batch`` is a pure function over that frozen state — safe to
  call from any number of threads, never refreshes, bit-identical to
  ``QueryEngine.query_batch`` on a KB frozen at the same generation.

- ``SnapshotManager`` owns the live engine and the current snapshot.
  ``publish()`` (writer thread only) runs the engine's incremental
  ``refresh()`` — O(changed docs), the whole point — captures a new
  snapshot, and swaps the ``current`` reference.  Readers that already
  hold generation *g* keep serving it untouched; new requests see
  *g+1*.  Queries never observe a partially refreshed matrix, and live
  ingest never blocks serving (verified under contention in
  tests/test_serving.py).

Single-writer contract (asserted by KnowledgeBase's write guard): one
thread performs all KB mutations *and* all ``publish()`` calls.  Any
number of threads may read ``current`` / call snapshot queries.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

from repro_torch.core import signature as sigmod
from repro_torch.core.engine import (
    QueryEngine,
    RetrievalResult,
    pack_query_arrays,
    results_from_topk,
    score_batch_arrays,
)
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.vectorizer import HashedTfIdf
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import global_registry

# shared reentrant no-op scope for the explain=False query path
_NULL_CTX = contextlib.nullcontext()


@dataclass(frozen=True)
class EngineSnapshot:
    """An immutable view of one engine generation (see module docs)."""

    generation: int
    doc_ids: tuple[str, ...]
    doc_vecs: object          # torch [N, D] — never written once bound
    doc_sigs: object          # torch [N, W]
    vectorizer: HashedTfIdf   # private copy: df frozen at `generation`
    sig_words: int
    alpha: float
    beta: float
    scoring_path: str
    kernel_operands: tuple | None  # kernel-ready doc operands
    max_batch: int
    # index plane pin: the engine's IVFIndex / ShardedIVFIndex is
    # immutable after build (maintenance *rebinds* engine.ivf, same as
    # the tensors), so the capture is one reference — readers serve the
    # clustered index of generation g lock-free while the writer
    # retrains/reassigns g+1.  For the sharded plane that one reference
    # pins every shard's resident block of generation g (a patch clones
    # a block, never writes it), so a reader's merge never mixes shard
    # blocks from two generations
    index_kind: str = "flat"
    guarantee: str = "probe"
    ivf: object | None = None
    nprobe: int = 8

    @staticmethod
    def capture(engine: QueryEngine) -> "EngineSnapshot":
        """Freeze the engine's current generation.  Caller (the writer
        thread) must have run ``engine.refresh()`` first so the arrays
        reflect ``engine.synced_version == kb.version``."""
        vec = engine.kb.vectorizer
        return EngineSnapshot(
            generation=engine.synced_version,
            doc_ids=tuple(engine.doc_ids),
            doc_vecs=engine.doc_vecs,
            doc_sigs=engine.doc_sigs,
            vectorizer=HashedTfIdf.from_state(vec.state(), vec.df.copy()),
            sig_words=engine.kb.sig_words,
            alpha=engine.alpha,
            beta=engine.beta,
            scoring_path=engine.scoring_path,
            kernel_operands=(
                engine._kernel_operands() if engine.use_kernel else None
            ),
            max_batch=engine.max_batch,
            index_kind=engine.index,
            guarantee=engine.guarantee,
            ivf=engine.ivf,
            nprobe=engine.nprobe,
        )

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    def query_batch(
        self, texts: list[str], k: int = 5, *, explain: bool = False
    ):
        """Score against this generation — pure, thread-safe, no refresh.

        Query vectors are built from the snapshot's own idf copy, so the
        result is bit-identical to ``QueryEngine.query_batch`` on a KB
        frozen at ``generation`` even while the live KB mutates.

        ``explain=True`` returns ``(results, plans)`` — one
        :class:`repro_torch.obs.explain.QueryPlan` per query, pinned at this
        snapshot's generation (docs/ARCHITECTURE.md §14).
        """
        if k <= 0:
            raise ValueError(f"k must be a positive integer, got {k}")
        if not self.doc_ids or not texts:
            empty = [[] for _ in texts]
            if explain:
                from repro_torch.obs import explain as explain_mod
                plans = explain_mod.plans_from_dispatch(
                    texts, k, index=self.index_kind,
                    scoring_path=self.scoring_path,
                    guarantee=self.guarantee, n_docs=0,
                    generation=self.generation)
                return empty, plans
            return empty
        out: list[list[RetrievalResult]] = []
        batches = []
        for start in range(0, len(texts), self.max_batch):
            chunk = texts[start: start + self.max_batch]
            if explain:
                res, ps = self._chunk(chunk, k, explain=True)
                out.extend(res)
                batches.append(ps)
            else:
                out.extend(self._chunk(chunk, k))
        if explain:
            from repro_torch.obs.explain import PlanBatch
            return out, PlanBatch.concat(batches)
        return out

    def _chunk(self, texts: list[str], k: int, *, explain: bool = False):
        if explain:
            from repro_torch.obs import explain as explain_mod
            col = obs_trace.StageCollector()
            scope = obs_trace.get().collect(col)
            t0 = time.perf_counter()
        else:
            scope = _NULL_CTX
        with scope:
            with obs_trace.span("query_embed", queries=len(texts)):
                pairs = [
                    (
                        self.vectorizer.query_vector(t),
                        sigmod.query_signature(t, width_words=self.sig_words),
                    )
                    for t in texts
                ]
                qv, qs = pack_query_arrays(
                    pairs, self.vectorizer.dim, self.sig_words)
            n = len(self.doc_ids)
            stats = None
            if self.index_kind != "flat" and self.ivf is not None:
                vals, idx, cos, ind, stats = self.ivf.search(
                    self.doc_vecs, self.doc_sigs, qv, qs,
                    b=len(texts), k=min(k, n), nprobe=self.nprobe,
                    guarantee=self.guarantee, scoring_path=self.scoring_path,
                    alpha=self.alpha, beta=self.beta, explain=explain,
                )
            else:
                vals, idx, cos, ind = score_batch_arrays(
                    self.doc_vecs, self.doc_sigs, qv, qs,
                    scoring_path=self.scoring_path, k=min(k, n),
                    alpha=self.alpha, beta=self.beta, n_docs=n,
                    kernel_operands=self.kernel_operands,
                )
            results = results_from_topk(self.doc_ids, len(texts),
                                        vals, idx, cos, ind)
        if not explain:
            return results
        # capture only — plan dataclasses materialize on first access
        # (PlanBatch), keeping explain inside the traced-QPS budget
        stages = tuple(col.stages)
        total_s = time.perf_counter() - t0
        kind, path, guar = self.index_kind, self.scoring_path, self.guarantee
        gen = self.generation
        return results, explain_mod.PlanBatch(
            lambda: explain_mod.plans_from_dispatch(
                texts, k, index=kind, scoring_path=path, guarantee=guar,
                n_docs=n, stats=stats, stages=stages,
                vector_cache_hits=None, generation=gen, total_s=total_s))


class SnapshotManager:
    """Owns the live engine + the current published snapshot.

    ``current`` is a single attribute read (atomic under the GIL);
    ``publish()`` serializes writers with a lock — but the lock is never
    taken on the read path, so publication cannot stall readers.
    """

    def __init__(self, kb=None, engine: QueryEngine | None = None,
                 container_path: str | None = None,
                 compact_ratio: float | None =
                 KnowledgeBase.DEFAULT_COMPACT_RATIO,
                 tenant: str | None = None,
                 ledger=None,
                 **engine_kwargs):
        if engine is None:
            if kb is None:
                raise ValueError("need a KnowledgeBase or a QueryEngine")
            engine = QueryEngine(kb, **engine_kwargs)
        self.engine = engine
        # durable-publish target: the KB's container + delta journal.
        # ``compact_ratio=None`` disables auto-compaction (same contract
        # as KnowledgeBase.save_delta — passed through verbatim).
        self.container_path = container_path
        self.compact_ratio = compact_ratio
        # tenancy label: set by ContainerPool mounts so publish spans
        # and the publish-lag gauge carry the tenant end to end; None
        # on the classic single-tenant path (unchanged series names)
        self.tenant = tenant
        # resource ledger (obs/ledger.py): re-measured at every publish
        # so resident-byte accounting always reflects the generation
        # readers can actually see
        self.ledger = ledger
        self._publish_lock = threading.Lock()
        with self._publish_lock:
            engine.refresh()
            self._current = EngineSnapshot.capture(engine)
        self._ledger_update()

    @property
    def current(self) -> EngineSnapshot:
        return self._current

    @property
    def generation(self) -> int:
        return self._current.generation

    def publish(self, durable: bool = False) -> EngineSnapshot:
        """Refresh the engine from the KB's dirty log and atomically
        swap in the new generation.  Writer thread only (the same
        thread that mutates the KB — see the single-writer contract).
        No-op (returns the live snapshot) when nothing changed.

        ``durable=True`` also persists the generation being swapped in:
        ``KnowledgeBase.save_delta(container_path)`` appends the O(U)
        delta record (or full-saves on the first publish) *before* the
        in-memory swap — persist-then-swap, so no reader can ever
        observe a generation that a crash could lose.  A crash between
        the two steps merely leaves an extra durable generation no
        reader had seen yet; on restart, ``KnowledgeBase.load`` replays
        base + journal back to exactly the last durable publish.
        Requires ``container_path`` (constructor arg)."""
        if durable and self.container_path is None:
            raise ValueError(
                "durable publish needs SnapshotManager(container_path=...)"
            )
        span_kw = {} if self.tenant is None else {"tenant": self.tenant}
        with self._publish_lock, \
                obs_trace.span("publish", durable=durable, **span_kw) as sp:
            with obs_trace.span("refresh"):
                self.engine.refresh()
            if durable:
                with obs_trace.span("delta_save"):
                    self.engine.kb.save_delta(
                        self.container_path,
                        compact_ratio=self.compact_ratio)
            if self.engine.synced_version != self._current.generation:
                with obs_trace.span("snapshot_capture"):
                    snap = EngineSnapshot.capture(self.engine)
                self._current = snap  # atomic reference swap — the publish
                # publish lag: wall time from the oldest KB mutation
                # this generation absorbs to the moment readers see it
                lag = self.engine.kb.take_publish_lag()
                if lag is not None:
                    lag_labels = ({} if self.tenant is None
                                  else {"tenant": self.tenant})
                    global_registry().gauge(
                        "ragdb_publish_lag_seconds",
                        "oldest unpublished mutation -> snapshot swap",
                        **lag_labels,
                    ).set(lag)
                    sp.set(generation=snap.generation, lag_s=round(lag, 6))
            self._ledger_update()
            return self._current

    def _ledger_update(self) -> None:
        """Re-measure this engine's resident planes into the ledger
        (mount + every publish — the points where they change)."""
        if self.ledger is None:
            return
        from repro_torch.obs import ledger as ledger_mod
        planes = ledger_mod.measure_engine_planes(self.engine)
        if self.container_path is not None:
            planes["journal_tail"] = ledger_mod.measure_journal(
                self.container_path)
        self.ledger.update(self.tenant or "default", planes,
                           generation=self._current.generation)


def results_equal(a: list[RetrievalResult], b: list[RetrievalResult]) -> bool:
    """Bit-exact result-list equality (used by tests and examples to
    verify the pinned-generation contract)."""
    if len(a) != len(b):
        return False
    return all(
        x.doc_id == y.doc_id
        and x.score == y.score
        and x.cosine == y.cosine
        and x.boosted == y.boosted
        for x, y in zip(a, b)
    )
