"""Serving metrics plane, backed by the obs metrics registry.

``ServingMetrics`` keeps its recording-hook API (the scheduler calls
``on_submit``/``on_complete``/…) and its ``snapshot()`` dict contract,
but the storage is now a per-runtime ``obs.MetricsRegistry`` — the
same counters/gauges/histograms the rest of the pipeline records into
— so one Prometheus exposition (``render()``) covers the serving tier
alongside the engine/index/ingest signals in
``obs.global_registry()``.  ``LatencyHistogram`` is the obs
``LogHistogram`` (fixed log-spaced buckets, O(1) memory forever);
re-exported here for compatibility.

Recorded by the scheduler (serving/scheduler.py):
- ``requests`` / ``completed`` / ``rejected`` / ``failed``
- ``cache_hits`` / ``cache_misses`` (serving-tier result cache)
- ``batches`` / batch occupancy (requests per flush) / ``scored``
  (unique queries actually dispatched — occupancy minus coalesced
  duplicates)
- end-to-end request latency (submit → future resolved): p50/p99/mean
- throughput (completed / wall-clock since construction or ``reset``)
"""
from __future__ import annotations

import time

from repro_torch.obs.export import render_prometheus
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry

# compatibility alias: the serving latency histogram is the obs
# log-bucket histogram (tests and drivers import it under this name)
LatencyHistogram = LogHistogram


class ServingMetrics:
    """Thread-safe counters + histograms for one serving runtime."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.reset()

    def reset(self) -> None:
        """Zero everything and restart the throughput clock (used by
        load generators to scope measurements to a timed window)."""
        self.registry.reset()
        reg = self.registry
        self._t0 = time.perf_counter()
        # per-tenant labeled series, memoized (one dict probe per hook
        # call instead of a registry lock round-trip); populated only
        # when the scheduler runs in router (multi-tenant) mode
        self._tenant_series: dict[str, dict] = {}
        self._requests = reg.counter(
            "ragdb_serving_requests_total", "requests submitted")
        self._completed = reg.counter(
            "ragdb_serving_completed_total", "futures resolved ok")
        self._rejected = reg.counter(
            "ragdb_serving_rejected_total", "admission-queue rejections")
        self._failed = reg.counter(
            "ragdb_serving_failed_total", "futures resolved with an error")
        self._cache_hits = reg.counter(
            "ragdb_serving_cache_hits_total", "result-cache hits at submit")
        self._cache_misses = reg.counter(
            "ragdb_serving_cache_misses_total", "result-cache misses")
        self._batches = reg.counter(
            "ragdb_serving_batches_total", "scheduler flushes")
        self._occupancy_sum = reg.counter(
            "ragdb_serving_batch_occupancy_sum", "requests across flushes")
        self._occupancy_max = reg.gauge(
            "ragdb_serving_batch_occupancy_max", "largest flush seen")
        self._scored = reg.counter(
            "ragdb_serving_scored_total",
            "unique queries dispatched (occupancy minus coalesced dups)")
        self._latency = reg.histogram(
            "ragdb_serving_latency_seconds",
            "end-to-end request latency (submit -> future resolved)")

    # ---- per-tenant labeled series (router mode) ------------------------

    def _tenant(self, tenant: str) -> dict:
        s = self._tenant_series.get(tenant)
        if s is None:
            reg = self.registry
            s = {
                "requests": reg.counter(
                    "ragdb_tenant_requests_total",
                    "requests submitted per tenant", tenant=tenant),
                "completed": reg.counter(
                    "ragdb_tenant_completed_total",
                    "futures resolved ok per tenant", tenant=tenant),
                "rejected": reg.counter(
                    "ragdb_tenant_rejected_total",
                    "quota/queue rejections per tenant", tenant=tenant),
                "latency": reg.histogram(
                    "ragdb_tenant_latency_seconds",
                    "end-to-end request latency per tenant",
                    tenant=tenant),
            }
            self._tenant_series[tenant] = s
        return s

    # ---- recording hooks (scheduler) -----------------------------------
    #
    # ``tenant=None`` (the single-tenant scheduler) records exactly the
    # pre-tenancy series — no labeled duplicates, bit-identical
    # exposition.  Router mode passes the tenant id and every hook
    # additionally records the per-tenant labeled series.

    def on_submit(self, tenant: str | None = None) -> None:
        self._requests.inc()
        if tenant is not None:
            self._tenant(tenant)["requests"].inc()

    def on_cache_hit(self, latency_s: float = 0.0,
                     tenant: str | None = None) -> None:
        """A submit-time cache hit completes immediately; its (near-zero)
        latency is recorded so the histogram covers the same request
        population as ``completed``/``qps``."""
        self._cache_hits.inc()
        self._completed.inc()
        self._latency.record(latency_s)
        if tenant is not None:
            s = self._tenant(tenant)
            s["completed"].inc()
            s["latency"].record(latency_s)

    def on_cache_miss(self) -> None:
        self._cache_misses.inc()

    def on_reject(self, tenant: str | None = None) -> None:
        self._rejected.inc()
        if tenant is not None:
            self._tenant(tenant)["rejected"].inc()

    def on_batch(self, occupancy: int, scored: int) -> None:
        self._batches.inc()
        self._occupancy_sum.inc(occupancy)
        self._scored.inc(scored)
        if occupancy > self._occupancy_max.value:
            self._occupancy_max.set(occupancy)

    def on_complete(self, latency_s: float,
                    tenant: str | None = None) -> None:
        self._completed.inc()
        self._latency.record(latency_s)
        if tenant is not None:
            s = self._tenant(tenant)
            s["completed"].inc()
            s["latency"].record(latency_s)

    def on_fail(self) -> None:
        self._failed.inc()

    # ---- tenant lifecycle ----------------------------------------------

    def drop_tenant(self, tenant: str) -> int:
        """Forget a tenant's labeled series (pool eviction path): the
        memoized handle set and every ``tenant=``-labeled series in the
        registry are pruned, so long-lived tenant churn cannot grow
        label cardinality without bound.  A remount recreates the
        series fresh from zero."""
        self._tenant_series.pop(tenant, None)
        return self.registry.prune(tenant=tenant)

    # ---- export ---------------------------------------------------------

    def health_sample(self) -> dict:
        """Raw cumulative values the SLO health monitor windows over
        (obs/health.py): counters plus one coherent latency
        bucket-snapshot."""
        return {
            "requests": self._requests.value,
            "completed": self._completed.value,
            "rejected": self._rejected.value,
            "failed": self._failed.value,
            "cache_hits": self._cache_hits.value,
            "cache_misses": self._cache_misses.value,
            "latency_buckets": self._latency.bucket_snapshot(),
        }

    @property
    def latency(self) -> LogHistogram:
        return self._latency

    def snapshot(self) -> dict:
        """One coherent dict of everything (the drivers print this)."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        completed = self._completed.value
        hits = self._cache_hits.value
        lookups = hits + self._cache_misses.value
        batches = self._batches.value
        lat = self._latency
        return {
            "requests": self._requests.value,
            "completed": completed,
            "rejected": self._rejected.value,
            "failed": self._failed.value,
            "qps": completed / elapsed,
            "elapsed_s": elapsed,
            "latency_p50_ms": lat.percentile(50) * 1e3,
            "latency_p99_ms": lat.percentile(99) * 1e3,
            "latency_mean_ms": lat.mean * 1e3,
            "latency_max_ms": lat.max * 1e3,
            "batches": batches,
            "batch_occupancy_mean": (
                self._occupancy_sum.value / batches if batches else 0.0
            ),
            "batch_occupancy_max": self._occupancy_max.value,
            "scored_queries": self._scored.value,
            "cache_hits": hits,
            "cache_misses": self._cache_misses.value,
            "cache_hit_rate": hits / lookups if lookups else 0.0,
        }

    def tenant_snapshot(self) -> dict[str, dict]:
        """Per-tenant view: {tenant: {completed, rejected, qps,
        latency_p50_ms, latency_p99_ms}} — the per-tenant QPS/p99 the
        tenancy plane reports (empty on the single-tenant path)."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        out: dict[str, dict] = {}
        for tenant, s in self._tenant_series.items():
            lat = s["latency"]
            out[tenant] = {
                "requests": s["requests"].value,
                "completed": s["completed"].value,
                "rejected": s["rejected"].value,
                "qps": s["completed"].value / elapsed,
                "latency_p50_ms": lat.percentile(50) * 1e3,
                "latency_p99_ms": lat.percentile(99) * 1e3,
            }
        return out

    def format(self) -> str:
        """Compact one-paragraph rendering for CLI drivers."""
        s = self.snapshot()
        return (
            f"served {s['completed']}/{s['requests']} requests "
            f"({s['rejected']} rejected, {s['failed']} failed) "
            f"at {s['qps']:.0f} qps | "
            f"latency p50 {s['latency_p50_ms']:.2f} ms "
            f"p99 {s['latency_p99_ms']:.2f} ms | "
            f"{s['batches']} flushes, mean occupancy "
            f"{s['batch_occupancy_mean']:.1f} "
            f"(max {s['batch_occupancy_max']}) | "
            f"result cache {s['cache_hits']}/{s['cache_hits'] + s['cache_misses']}"
            f" hits"
        )

    def render(self) -> str:
        """Prometheus text exposition of this runtime's registry."""
        return render_prometheus(self.registry)
