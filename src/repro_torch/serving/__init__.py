"""The concurrent serving runtime (docs/ARCHITECTURE.md §7), in PyTorch.

Sits between callers and the batched ``QueryEngine``:

    callers ──submit()──▶ MicroBatchScheduler ──flush──▶ EngineSnapshot@g
                │   ▲           (scheduler.py)              (snapshot.py)
                │   └── Future[ServedResult]                      ▲
                │                                        publish() │ atomic swap
                ├── ResultCache (query, k, generation)   SnapshotManager
                │        (cache.py)                            ▲
                └── ServingMetrics (metrics.py)     sync()/add_text + refresh()
                                                     single writer thread

``ServingRuntime`` is the one-stop composition: construct it over a
``KnowledgeBase``, ``start()`` it (or use it as a context manager),
``submit`` queries from any number of threads, and call ``publish()``
from the (single) ingest thread after KB mutations.  Queries are
micro-batched into the engine's power-of-two buckets, served from a
generation-pinned snapshot, cached per generation, and accounted in the
metrics plane.  Engine kwargs (``device=``, ``scoring_path=``, ...)
thread straight through.

Index-plane knobs thread through the same way:
``ServingRuntime(kb, index="ivf", nprobe=4, guarantee="exact")`` serves
every flush from the generation's *frozen* IVF index (snapshots pin the
immutable ``IVFIndex`` reference exactly like the doc tensors — readers
never see a half-retrained index; docs/ARCHITECTURE.md §9).

Observability (docs/ARCHITECTURE.md §12): ``ServingMetrics`` is backed
by a labeled ``repro_torch.obs`` metrics registry, and the scheduler
emits per-stage request spans into the process tracer when
``repro_torch.obs.trace.enable()`` (or ``RAGDB_TRACE=1``) is on.

Tenancy (``pool=``) is not ported yet and raises ``NotImplementedError``
until the tenancy slice of the port.
"""
from __future__ import annotations

from concurrent.futures import Future

from repro_torch.analysis import sanitizers
from repro_torch.core.engine import QueryEngine, RetrievalResult  # noqa: F401
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.obs import render_prometheus
from repro_torch.obs.ledger import ResourceLedger
from repro_torch.obs.metrics import global_registry

from repro_torch.serving.cache import ResultCache
from repro_torch.serving.metrics import LatencyHistogram, ServingMetrics  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    MicroBatchScheduler,
    RequestRejected,
    ServedResult,
)
from repro_torch.serving.snapshot import (  # noqa: F401
    EngineSnapshot,
    SnapshotManager,
    results_equal,
)

__all__ = [
    "EngineSnapshot",
    "KnowledgeBase",
    "LatencyHistogram",
    "MicroBatchScheduler",
    "QueryEngine",
    "RequestRejected",
    "ResultCache",
    "ServedResult",
    "ServingMetrics",
    "ServingRuntime",
    "SnapshotManager",
    "results_equal",
]


class ServingRuntime:
    """Scheduler + snapshots + result cache + metrics, wired together."""

    def __init__(
        self,
        kb: KnowledgeBase | None = None,
        *,
        engine: QueryEngine | None = None,
        pool=None,
        quotas=None,
        max_batch: int = 16,
        flush_deadline: float = 0.002,
        max_queue: int = 1024,
        result_cache_size: int = 2048,
        container_path: str | None = None,
        compact_ratio: float | None = KnowledgeBase.DEFAULT_COMPACT_RATIO,
        slo=None,
        **engine_kwargs,
    ):
        if pool is not None or quotas is not None:
            raise NotImplementedError(
                "multi-tenant serving (pool=, quotas=) belongs to the "
                "tenancy slice of the PyTorch port, which is not ported "
                "yet; serve one KnowledgeBase")
        self.metrics = ServingMetrics()
        self.cache = (
            ResultCache(result_cache_size) if result_cache_size else None
        )
        # kept for API parity; a no-op under eager PyTorch (sanitizers.py)
        self.retrace_guard = sanitizers.RetraceGuard()
        # SLO health monitor (obs/health.py): lazily constructed on the
        # first health() call so the window clock starts at first use
        self._slo = slo
        self._health_monitor = None
        self.pool = None
        self.ledger = ResourceLedger(registry=self.metrics.registry)
        self.snapshots = SnapshotManager(
            kb, engine=engine, container_path=container_path,
            compact_ratio=compact_ratio, ledger=self.ledger,
            **engine_kwargs,
        )
        self.scheduler = MicroBatchScheduler(
            self.snapshots,
            max_batch=max_batch,
            flush_deadline=flush_deadline,
            max_queue=max_queue,
            cache=self.cache,
            metrics=self.metrics,
            retrace_guard=self.retrace_guard,
        )

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "ServingRuntime":
        self.scheduler.start()
        return self

    def stop(self) -> None:
        self.scheduler.stop()

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- request plane (any thread) -------------------------------------

    def submit(self, text: str, k: int = 5, *,
               explain: bool = False) -> Future:
        """Future[ServedResult]; raises RequestRejected on backpressure
        (queue full).  ``explain=True`` attaches the per-query EXPLAIN
        plan to the resolved ``ServedResult.plan``."""
        return self.scheduler.submit(text, k, explain=explain)

    def query_batch(self, texts: list[str],
                    k: int = 5) -> list[list[RetrievalResult]]:
        """Blocking convenience: submit all, wait for all.  Same
        signature/result shape as ``QueryEngine.query_batch``."""
        futures = [self.submit(t, k) for t in texts]
        return [f.result().results for f in futures]

    # ---- ingest plane (the single writer thread) ------------------------

    def publish(self, durable: bool = False) -> int:
        """Refresh the engine from the KB's dirty log and atomically
        publish the next generation; returns the published generation.
        Call from the same thread that mutates the KB.

        ``durable=True`` (requires ``container_path``) also appends the
        O(U) delta record to the container's journal before the swap, so
        a crash never loses a published generation."""
        gen = self.snapshots.publish(durable=durable).generation
        self.retrace_guard.reset()
        return gen

    # ---- runtime sanitizers ----------------------------------------------

    def arm_sanitizers(self, k: int = 5) -> None:
        """Warm every query-batch bucket the serving loop can emit
        ({1, 2, 4, .., max_batch} at ``k``) against the current
        snapshot, then arm the (eager no-op) retrace guard."""
        snap = self.snapshots.current
        b = 1
        while True:
            snap.query_batch(["warmup bucket probe"] * b, k)
            if b >= self.scheduler.max_batch:
                break
            b *= 2
        self.retrace_guard.arm()

    # ---- introspection ---------------------------------------------------

    def render_metrics(self) -> str:
        """One Prometheus text exposition for the whole runtime: the
        per-runtime serving registry plus the process-global obs
        registry (IVF probe stats, journal bytes, publish lag, sanitizer
        trips)."""
        return render_prometheus(self.metrics.registry, global_registry())

    def index_stats(self) -> dict:
        """The engine's clustered-index health counters (probed
        fraction, widening rounds, retrains); probe fields are None
        on a flat index or before the first ivf dispatch."""
        return self.engine.index_stats()

    def resources(self) -> dict:
        """Ledger snapshot of resident bytes per plane (torch tensors
        report their ``nbytes`` like numpy arrays do).  The result-cache
        plane is refreshed from the live cache at call time."""
        if self.cache is not None:
            sizes = self.cache.keyspace_bytes()
            self.ledger.set_plane("default", "result_cache",
                                  sum(sizes.values()))
        return self.ledger.snapshot()

    def health(self) -> dict:
        """One SLO health verdict: ``{"status": "ok|degraded|critical",
        "reasons": [...], "signals": {...}}`` (obs/health.py)."""
        if self._health_monitor is None:
            from repro_torch.obs.health import HealthMonitor
            self._health_monitor = HealthMonitor(
                self.metrics, targets=self._slo,
                export_registry=self.metrics.registry)
        return self._health_monitor.check()

    @property
    def engine(self) -> QueryEngine:
        return self.snapshots.engine

    @property
    def generation(self) -> int:
        return self.snapshots.generation
