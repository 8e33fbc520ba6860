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

Tenancy (docs/ARCHITECTURE.md §13): construct over a
``tenancy.ContainerPool`` instead of a KB —
``ServingRuntime(pool=ContainerPool(root), quotas=...)`` — and the
same runtime multiplexes N tenants: ``submit(text, k, tenant=...)``
routes through the ``TenantRouter`` (token-bucket admission, lazy
mount, refcount-pinned flushes), ``publish(tenant=...)`` drives that
tenant's writer plane, the result cache is keyspace-isolated per
tenant, and pool evictions drop the evicted tenant's cache keyspace.
The pool's engine kwargs place every mount (the card unless they say
``device="cpu"``).  The two construction modes are exclusive; the
single-tenant mode is bit-identical to the pre-tenancy runtime.
"""
from __future__ import annotations

from concurrent.futures import Future
from contextlib import contextmanager

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
        self.metrics = ServingMetrics()
        self.cache = (
            ResultCache(result_cache_size) if result_cache_size else None
        )
        # the capture guard: zero CUDA graph captures once armed
        # (sanitizers.py; silent on the CPU, which captures nothing)
        self.retrace_guard = sanitizers.RetraceGuard()
        # SLO health monitor (obs/health.py): lazily constructed on the
        # first health() call so the window clock starts at first use
        self._slo = slo
        self._health_monitor = None
        if pool is not None:
            # multi-tenant mode: the pool owns every KB/engine stack
            if kb is not None or engine is not None or container_path:
                raise ValueError(
                    "pool= is exclusive with kb=/engine=/container_path= "
                    "— per-tenant stacks are mounted by the ContainerPool")
            # deferred import: tenancy builds on serving.snapshot, so a
            # module-level import here would cycle through the package
            from repro_torch.tenancy.router import TenantRouter
            self.pool = pool
            self.router = TenantRouter(pool, quotas=quotas)
            self.snapshots = None
            # the pool's ledger is the runtime's resource accounting
            self.ledger = pool.ledger
            # unmount hygiene: an evicted tenant's cached results AND
            # its labeled metric series leave memory with its stack —
            # without the prune, zipf tenant churn grows label
            # cardinality without bound and evicted tenants' gauges
            # (publish lag, resident bytes) go stale forever
            pool.on_evict = self._on_tenant_evict
            self.scheduler = MicroBatchScheduler(
                router=self.router,
                max_batch=max_batch,
                flush_deadline=flush_deadline,
                max_queue=max_queue,
                cache=self.cache,
                metrics=self.metrics,
                retrace_guard=self.retrace_guard,
            )
            return
        self.pool = None
        self.router = None
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

    def _on_tenant_evict(self, tenant: str) -> None:
        """Pool eviction hook: drop the tenant's cache keyspace and
        prune its labeled series from the runtime registry."""
        if self.cache is not None:
            self.cache.drop_keyspace(tenant)
        self.metrics.drop_tenant(tenant)

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

    def submit(self, text: str, k: int = 5,
               tenant: str | None = None, *,
               explain: bool = False) -> Future:
        """Future[ServedResult]; raises RequestRejected on backpressure
        (queue full, or — multi-tenant mode — tenant over quota).
        ``explain=True`` attaches the per-query EXPLAIN plan to the
        resolved ``ServedResult.plan``."""
        return self.scheduler.submit(text, k, tenant=tenant,
                                     explain=explain)

    def query_batch(
        self, texts: list[str], k: int = 5, tenant: str | None = None
    ) -> list[list[RetrievalResult]]:
        """Blocking convenience: submit all, wait for all.  Same
        signature/result shape as ``QueryEngine.query_batch``."""
        futures = [self.submit(t, k, tenant=tenant) for t in texts]
        return [f.result().results for f in futures]

    # ---- ingest plane (the single writer thread) ------------------------

    def publish(self, durable: bool = False,
                tenant: str | None = None) -> int:
        """Refresh the engine from the KB's dirty log and atomically
        publish the next generation; returns the published generation.
        Call from the same thread that mutates the KB (per tenant, in
        multi-tenant mode — pass the tenant whose KB you mutated).

        ``durable=True`` (requires ``container_path``; always available
        in multi-tenant mode, where every mount has its container) also
        appends the O(U) delta record to the container's journal before
        the swap, so a crash never loses a published generation."""
        if self.router is not None:
            from repro_torch.tenancy.router import DEFAULT_TENANT
            gen = self.router.publish(
                DEFAULT_TENANT if tenant is None else tenant,
                durable=durable)
        else:
            if tenant is not None:
                raise ValueError(
                    "tenant= requires multi-tenant mode "
                    "(ServingRuntime(pool=...))")
            gen = self.snapshots.publish(durable=durable).generation
        self.retrace_guard.reset()
        return gen

    # ---- tenancy plane ---------------------------------------------------

    @contextmanager
    def tenant_writer(self, tenant: str):
        """``with runtime.tenant_writer(t) as kb:`` — pin tenant ``t``
        (mounting it if cold) and yield its KnowledgeBase for a writer
        session; follow with ``publish(tenant=t)``.  The pin makes pool
        eviction of the tenant structurally impossible mid-session.
        Multi-tenant mode only."""
        if self.router is None:
            raise RuntimeError(
                "tenant_writer requires multi-tenant mode "
                "(ServingRuntime(pool=...))")
        with self.router.writer(tenant) as mount:
            yield mount.kb

    # ---- runtime sanitizers ----------------------------------------------

    def arm_sanitizers(self, k: int = 5,
                       tenants: list[str] | None = None, *,
                       rag=None, max_new_tokens: int = 16) -> None:
        """Warm every query-batch bucket the serving loop can emit
        ({1, 2, 4, .., max_batch} at ``k``) against the current
        snapshot — in multi-tenant mode against every tenant in
        ``tenants`` (default: the resident set) — then arm the capture
        guard: after this, any CUDA graph capture raises
        ``sanitizers.SanitizerError`` on the flush or generation that
        caused it (when ``RAGDB_SANITIZERS`` is on).

        When the runtime serves generation, pass its ``RAGPipeline`` as
        ``rag`` with the ``max_new_tokens`` it generates: every prompt
        bucket of its steps for that horizon (and the decode step) is
        captured before arming, and the pipeline checks the guard after
        each generation.  Re-call after every ``publish()`` (which
        disarms the guard)."""
        if rag is not None:
            rag.generation_steps(max_new_tokens).capture_all()
            rag.retrace_guard = self.retrace_guard
        if self.router is not None:
            names = tenants if tenants is not None \
                else self.pool.resident_tenants()
            for name in names:
                with self.pool.pinned(name) as mount:
                    self._warm_buckets(mount.snapshots.current, k)
        else:
            self._warm_buckets(self.snapshots.current, k)
        self.retrace_guard.arm()

    def _warm_buckets(self, snap, k: int) -> None:
        b = 1
        while True:
            snap.query_batch(["warmup bucket probe"] * b, k)
            if b >= self.scheduler.max_batch:
                break
            b *= 2

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
        """Ledger snapshot of resident bytes per (tenant, plane) — the
        same numbers pool eviction budgets against, so reported
        occupancy and budget decisions can never diverge (torch tensors
        report their ``nbytes`` like numpy arrays do, and a storage is
        counted once).  The result-cache plane is refreshed from the
        live cache at call time."""
        if self.cache is not None:
            sizes = self.cache.keyspace_bytes()
            if self.pool is None:
                self.ledger.set_plane("default", "result_cache",
                                      sum(sizes.values()))
            else:
                for keyspace, nbytes in sizes.items():
                    self.ledger.set_plane(keyspace, "result_cache", nbytes)
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

    def tenant_metrics(self) -> dict:
        """Per-tenant QPS/p50/p99/rejections (multi-tenant mode;
        empty dict on the single-tenant path)."""
        return self.metrics.tenant_snapshot()

    def pool_stats(self) -> dict:
        """The container pool's resident/pinned/byte accounting
        (multi-tenant mode only)."""
        if self.pool is None:
            raise RuntimeError("pool_stats requires multi-tenant mode")
        return self.pool.stats()

    @property
    def engine(self) -> QueryEngine:
        if self.snapshots is None:
            raise RuntimeError(
                "no single engine in multi-tenant mode — pin a tenant "
                "via tenant_writer()/pool.pinned() for its stack")
        return self.snapshots.engine

    @property
    def generation(self) -> int:
        if self.snapshots is None:
            raise RuntimeError(
                "no single generation in multi-tenant mode — use "
                "pool.peek_generation(tenant)")
        return self.snapshots.generation
