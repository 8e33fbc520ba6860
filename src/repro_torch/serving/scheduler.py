"""Micro-batching request scheduler: the concurrent front door.

Callers ``submit(text, k)`` and get a ``Future`` back immediately; a
single flusher thread drains the bounded admission queue, coalescing
requests into one scoring dispatch per flush.  A flush closes when
either ``max_batch`` requests have accumulated or ``flush_deadline``
seconds have passed since the first request of the window — the classic
throughput/latency knob pair (cf. Shen et al., arXiv 2412.11854: batch
formation dominates end-to-end RAG serving latency).  The engine's
power-of-two shape buckets mean a flush of 9 scores in the same jit
bucket as 16, so ``max_batch`` should be a bucket boundary.

Design points:

- **Bounded admission, explicit rejection.**  The queue has a hard
  capacity; when it is full, ``submit`` raises ``RequestRejected``
  instead of growing without bound.  Callers see backpressure as an
  exception at the door, never as silent unbounded latency.
- **Generation-consistent flushes.**  Each flush pins the *current*
  snapshot once per tenant group and serves every request of that
  group from it, so one batch never straddles a container publication
  (torn reads are structurally impossible — see serving/snapshot.py).
- **Duplicate coalescing.**  Requests in one flush that normalize to
  the same (tenant, query, k) are scored once and fanned out to all
  futures.
- **Result-cache compose.**  On submit, a hit in the serving-tier
  result cache (keyed with the current generation, in the tenant's
  keyspace) resolves the future immediately — the request never enters
  the queue.  Flush results are inserted back under the generation
  that served them.
- **One scoring thread.**  Scoring stays single-threaded (the flusher),
  so the jit dispatch path needs no locking; concurrency lives at the
  queue, and readers scale by batching, not by fighting for the device.

Tenancy (docs/ARCHITECTURE.md §13): constructed with a
``TenantRouter``, the scheduler becomes multi-tenant — ``submit``
takes a tenant id, admission additionally spends the tenant's
token-bucket quota (over-quota → ``RequestRejected`` carrying the
tenant, *before* the request can touch the shared queue or thrash the
container pool), and a flush groups requests by tenant, resolving each
group against that tenant's *pinned* mount (the pin is the
teardown barrier against pool eviction; it is held only for the
group's scoring, never across the whole batch).  A scoring failure in
one tenant's group fails only that group's futures.  Without a router
the scheduler is exactly the classic single-tenant front door — one
tenant group per flush, one snapshot pin, bit-identical results.

The future resolves to a ``ServedResult`` carrying the results *and*
the generation that served them, so callers (and the stress tests) can
audit exactly which corpus state answered.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from repro_torch.core.engine import RetrievalResult
from repro_torch.core.tokenizer import normalize
from repro_torch.obs import trace
from repro_torch.obs.explain import QueryPlan, finalize_plan

from repro_torch.serving.cache import DEFAULT_KEYSPACE, ResultCache
from repro_torch.serving.metrics import ServingMetrics

# the tenant the classic single-tenant path maps onto (== the result
# cache's default keyspace and tenancy.DEFAULT_TENANT)
DEFAULT_TENANT = DEFAULT_KEYSPACE


class RequestRejected(RuntimeError):
    """Admission refused — queue full, scheduler stopped, or tenant
    over quota — explicit backpressure to the caller.  ``tenant`` names
    the rejected tenant (None on the single-tenant path)."""

    def __init__(self, msg: str, tenant: str | None = None):
        super().__init__(msg)
        self.tenant = tenant


@dataclass
class ServedResult:
    """What a resolved future holds.  ``plan`` is the EXPLAIN record
    (obs/explain.py), available only when the request was submitted
    with ``explain=True`` — materialized lazily on first access
    (``plan_source`` holds the bound thunk), so resolving a future
    costs nothing on the traced-QPS budget when nobody reads the plan."""

    results: list[RetrievalResult]
    generation: int
    cached: bool = False
    plan_source: object = None   # zero-arg () -> QueryPlan, or None
    _plan: QueryPlan | None = field(default=None, repr=False,
                                    compare=False)

    @property
    def plan(self) -> QueryPlan | None:
        if self.plan_source is None:
            return None
        if self._plan is None:
            self._plan = self.plan_source()
        return self._plan


@dataclass
class _Pending:
    text: str
    k: int
    tenant: str = DEFAULT_TENANT
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    # observability: nonzero when this request was sampled for tracing
    # (id allocated on the submitting thread, stage spans recorded
    # against it by the flusher); t_dequeue splits queue wait from
    # flush wait
    trace_id: int = 0
    t_dequeue: float = 0.0
    explain: bool = False


_STOP = object()


def _hit_plan_thunk(text, k, generation, tenant, total_s):
    """Bind a result-cache-hit EXPLAIN plan into a zero-arg thunk for
    ``ServedResult.plan``'s lazy materialization."""
    def build():
        return QueryPlan(
            query=text, k=k, result_cache="hit",
            generation=generation, tenant=tenant, total_s=total_s,
            request_stages=(("cache_lookup", total_s),))
    return build


def _plan_thunk(qplans, idx, tenant, generation, result_cache,
                coalesced, t_submit, t_dequeue, t_score0, t_score1,
                t_done):
    """Bind one flushed request's EXPLAIN enrichment into a zero-arg
    thunk — by value, since the flush loop reuses its locals — for
    ``ServedResult.plan``'s lazy materialization.  The thunk pulls the
    engine plan out of the (itself lazy) ``PlanBatch`` and finalizes
    the per-request copy only when somebody reads the plan."""
    def build():
        return finalize_plan(
            qplans[idx],
            tenant=tenant,
            generation=generation,
            result_cache=result_cache,
            coalesced=coalesced,
            request_stages=(
                ("queue_wait", t_dequeue - t_submit),
                ("flush_wait", t_score0 - t_dequeue),
                ("score", t_score1 - t_score0),
                ("merge", t_done - t_score1),
            ),
            total_s=t_done - t_submit,
        )
    return build


class MicroBatchScheduler:
    """See module docstring.  ``source`` is anything with a ``current``
    attribute yielding a snapshot that has ``generation`` and
    ``query_batch(texts, k)`` — in practice a
    ``serving.snapshot.SnapshotManager``.  Alternatively pass
    ``router`` (a ``tenancy.TenantRouter``) for multi-tenant mode;
    exactly one of the two must be set."""

    def __init__(
        self,
        source=None,
        *,
        router=None,
        max_batch: int = 16,
        flush_deadline: float = 0.002,
        max_queue: int = 1024,
        cache: ResultCache | None = None,
        metrics: ServingMetrics | None = None,
        retrace_guard=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if (source is None) == (router is None):
            raise ValueError(
                "pass exactly one of source= (single-tenant) or "
                "router= (multi-tenant)")
        self.source = source
        self.router = router
        self.max_batch = max_batch
        self.flush_deadline = flush_deadline
        self.cache = cache
        self.metrics = metrics or ServingMetrics()
        # opt-in sanitizers.RetraceGuard: checked after every flush so a
        # steady-state recompile surfaces on the batch that caused it
        self.retrace_guard = retrace_guard
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "MicroBatchScheduler":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._worker, name="microbatch-flusher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain-free shutdown: in-flight flushes finish; anything still
        queued is rejected so no caller blocks forever."""
        self._stopping.set()
        if self._thread is not None:
            self._queue.put(_STOP)  # wake the flusher if it is blocked
            self._thread.join()
            self._thread = None
        self._drain_reject()

    def _drain_reject(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP and not item.future.done():
                item.future.set_exception(
                    RequestRejected("scheduler stopped",
                                    tenant=self._mt_tenant(item.tenant))
                )
                self.metrics.on_reject(self._mt_tenant(item.tenant))

    def _mt_tenant(self, tenant: str) -> str | None:
        """The tenant id for error/metrics attribution — None on the
        single-tenant path so its series/exceptions stay unlabeled
        (bit-identical to the pre-tenancy plane)."""
        return tenant if self.router is not None else None

    def __enter__(self) -> "MicroBatchScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- submission -----------------------------------------------------

    def submit(self, text: str, k: int = 5,
               tenant: str | None = None, *,
               explain: bool = False) -> Future:
        """Enqueue one request; returns a Future[ServedResult].

        Raises ``RequestRejected`` when the admission queue is full,
        the scheduler is stopped, or (multi-tenant mode) the tenant is
        over its token-bucket quota (bounded memory, explicit
        backpressure).  ``explain=True`` attaches the per-query
        :class:`~repro_torch.obs.explain.QueryPlan` to the resolved
        ``ServedResult.plan``.
        """
        t_submit = time.perf_counter()
        tenant = DEFAULT_TENANT if tenant is None else tenant
        mt_tenant = self._mt_tenant(tenant)
        if self.router is not None:
            self.router.validate(tenant)
        self.metrics.on_submit(mt_tenant)
        tid = trace.begin_trace()  # 0 when tracing is off or unsampled
        if self._stopping.is_set():
            self.metrics.on_reject(mt_tenant)
            raise RequestRejected("scheduler stopped", tenant=mt_tenant)
        if self.router is not None and not self.router.admit(tenant):
            # quota gate before the shared queue AND before any cache
            # or pool touch: rejected traffic cannot thrash the LRU
            self.metrics.on_reject(mt_tenant)
            raise RequestRejected(
                f"tenant {tenant!r} over admission quota", tenant=mt_tenant)
        if self.cache is not None:
            generation = self._probe_generation(tenant)
            if generation is not None:
                hit = self.cache.get(text, k, generation, keyspace=tenant)
                if hit is not None:
                    now = time.perf_counter()
                    self.metrics.on_cache_hit(now - t_submit, mt_tenant)
                    if tid:
                        trace.record("request", t_submit, now - t_submit,
                                     trace=tid, k=k, cached=True,
                                     generation=generation)
                    plan_source = None
                    if explain:
                        plan_source = _hit_plan_thunk(
                            text, k, generation, mt_tenant,
                            now - t_submit)
                    fut: Future = Future()
                    fut.set_result(
                        ServedResult(hit, generation, cached=True,
                                     plan_source=plan_source)
                    )
                    return fut
                self.metrics.on_cache_miss()
        req = _Pending(text=text, k=k, tenant=tenant,
                       t_submit=t_submit, trace_id=tid, explain=explain)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.on_reject(mt_tenant)
            raise RequestRejected(
                f"admission queue full ({self._queue.maxsize} pending)",
                tenant=mt_tenant,
            ) from None
        if self._stopping.is_set():
            # raced with stop(): its drain may already have run, leaving
            # this request in a dead queue — drain again so the future
            # is rejected, never silently stranded
            self._drain_reject()
            if req.future.done() and req.future.exception() is not None:
                raise RequestRejected("scheduler stopped",
                                      tenant=mt_tenant) from None
        return req.future

    def _probe_generation(self, tenant: str) -> int | None:
        """The generation a cache probe should key on: the pinned
        snapshot's (single-tenant) or the resident mount's (router
        mode; None when the tenant is cold — a cold tenant has no live
        generation to probe against, so the request goes to the flush,
        which mounts it)."""
        if self.router is None:
            return self.source.current.generation
        return self.router.peek_generation(tenant)

    # ---- the flusher ----------------------------------------------------

    def _worker(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._stopping.is_set():
                    return
                continue
            if first is _STOP:
                return
            first.t_dequeue = time.perf_counter()
            batch = [first]
            deadline = first.t_dequeue + self.flush_deadline
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is _STOP:
                    self._flush(batch)
                    return
                item.t_dequeue = time.perf_counter()
                batch.append(item)
            self._flush(batch)

    def _flush(self, batch: list[_Pending]) -> None:
        # the flush-level span (and the engine/index spans nesting under
        # it on this thread) rides the trace of the request that OPENED
        # the flush window — so flush instrumentation is emitted for a
        # `sample` fraction of flushes, not whenever any request in the
        # batch happens to be sampled.  Per-request stage records are
        # independent of this: every sampled request gets its
        # decomposition even when its flush is not traced.
        flush_trace = batch[0].trace_id
        scored = 0
        # deferred span emission: stage timestamps are captured in the
        # fan-out loop, but SpanRecords are built only after every
        # future of the batch has resolved — tracing work overlaps the
        # next batch's accumulation window instead of delaying wakeups
        deferred: list[tuple] = []
        with trace.span("flush", trace=flush_trace,
                        batch=len(batch)) as fsp:
            try:
                # per-tenant groups: one snapshot pin (and one pool pin,
                # in router mode) per group; the single-tenant path is
                # always exactly one group
                by_tenant: dict[str, list[_Pending]] = {}
                for req in batch:
                    by_tenant.setdefault(req.tenant, []).append(req)
                for tenant, group in by_tenant.items():
                    scored += self._flush_tenant(tenant, group, deferred)
            except Exception as exc:  # noqa: BLE001 — fail the batch, not the loop
                fsp.set(error=type(exc).__name__)
                for req in batch:
                    if not req.future.done():
                        self.metrics.on_fail()
                        req.future.set_exception(exc)
            finally:
                self.metrics.on_batch(len(batch), scored)
        for args in deferred:
            self._trace_request(*args)

    def _flush_tenant(self, tenant: str, group: list[_Pending],
                      deferred: list[tuple]) -> int:
        """Serve one tenant's group of the flush from one pinned
        snapshot; failures land on this group's futures only."""
        scored = 0
        mt_tenant = self._mt_tenant(tenant)
        pinned = False
        try:
            with trace.span("snapshot_pin") as psp:
                if self.router is not None:
                    # the pool pin: mounts the tenant if cold (the
                    # cold-start cost lands on this group's latency, by
                    # design) and bars eviction until the group is done
                    mount = self.router.pin(tenant)
                    pinned = True
                    snap = mount.snapshots.current
                    psp.set(generation=snap.generation, tenant=tenant)
                else:
                    snap = self.source.current  # pinned once per flush
                    psp.set(generation=snap.generation)
            by_k: dict[int, list[_Pending]] = {}
            for req in group:
                by_k.setdefault(req.k, []).append(req)
            for k, kgroup in by_k.items():
                # duplicate coalescing: one scored column per
                # canonical query text, fanned out to every
                # requesting future
                with trace.span("pack", k=k) as ksp:
                    order: dict[str, int] = {}
                    texts: list[str] = []
                    for req in kgroup:
                        key = normalize(req.text)
                        if key not in order:
                            order[key] = len(texts)
                            texts.append(req.text)
                    ksp.set(unique=len(texts), requests=len(kgroup))
                want_explain = any(r.explain for r in kgroup)
                t_score0 = time.perf_counter()
                if want_explain:
                    results, qplans = snap.query_batch(
                        texts, k, explain=True)
                else:
                    results = snap.query_batch(texts, k)
                    qplans = None
                t_score1 = time.perf_counter()
                scored += len(texts)
                if self.retrace_guard is not None:
                    # raises SanitizerError on steady-state jit
                    # cache growth — checked before fan-out so the
                    # failure lands on the futures of the batch
                    # that caused it
                    self.retrace_guard.check("scheduler._flush")
                if want_explain:
                    # coalesce fanout per scored column (how many
                    # requests each unique query serves)
                    fanout: dict[str, int] = {}
                    for req in kgroup:
                        key = normalize(req.text)
                        fanout[key] = fanout.get(key, 0) + 1
                for req in kgroup:
                    key = normalize(req.text)
                    res = results[order[key]]
                    if self.cache is not None:
                        self.cache.put(req.text, k, snap.generation,
                                       res, keyspace=tenant)
                    t_done = time.perf_counter()
                    self.metrics.on_complete(t_done - req.t_submit,
                                             mt_tenant)
                    plan_source = None
                    if req.explain and qplans is not None:
                        # enrich the engine plan with the scheduler
                        # view: the same timestamps _trace_request
                        # records, so EXPLAIN stage durations tile the
                        # span decomposition by construction
                        plan_source = _plan_thunk(
                            qplans, order[key], mt_tenant,
                            snap.generation,
                            ("miss" if self.cache is not None
                             else "bypass"),
                            fanout[key], req.t_submit, req.t_dequeue,
                            t_score0, t_score1, t_done)
                    req.future.set_result(
                        ServedResult(res, snap.generation,
                                     plan_source=plan_source)
                    )
                    if req.trace_id:
                        deferred.append(
                            (req, k, snap.generation,
                             t_score0, t_score1, t_done, len(texts),
                             mt_tenant))
        except Exception as exc:  # noqa: BLE001 — fail this tenant's group only
            for req in group:
                if not req.future.done():
                    self.metrics.on_fail()
                    req.future.set_exception(exc)
        finally:
            if pinned:
                self.router.unpin(tenant)
        return scored

    @staticmethod
    def _trace_request(req: _Pending, k: int, generation: int,
                       t_score0: float, t_score1: float, t_done: float,
                       batch_size: int, tenant: str | None = None) -> None:
        """Record the per-request stage decomposition.  The four stages
        tile [t_submit, t_done] exactly, so they sum to the end-to-end
        latency the histogram records (the acceptance invariant)."""
        rid = trace.alloc_id()  # the request root span's id
        request_args = {"k": k, "generation": generation, "cached": False}
        if tenant is not None:
            request_args["tenant"] = tenant
        trace.record_batch(req.trace_id, (
            ("queue_wait", req.t_submit,
             req.t_dequeue - req.t_submit, 0, rid, None),
            ("flush_wait", req.t_dequeue,
             t_score0 - req.t_dequeue, 0, rid, None),
            ("score", t_score0, t_score1 - t_score0, 0, rid,
             {"batch": batch_size}),
            ("merge", t_score1, t_done - t_score1, 0, rid, None),
            ("request", req.t_submit, t_done - req.t_submit, rid, 0,
             request_args),
        ))
