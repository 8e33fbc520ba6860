"""Observability plane: span tracer + metrics registry + exporters.

Zero-dependency (pure stdlib — importable from ``core/container.py``
upward without cycles), in the same spirit as the analysis plane:

- ``obs.trace`` — monotonic-clock spans with trace/parent ids in a
  bounded ring buffer; off by default, near-zero cost when off,
  sampled when on.  The serving request lifecycle (queue wait → flush
  wait → pack → snapshot pin → device dispatch → IVF probe/rerank →
  merge) and the write path (sync, extract, delta save, journal
  fsync, compact, publish) all record here.
- ``obs.metrics`` — labeled counters/gauges/log-bucket histograms in a
  ``MetricsRegistry``; ``global_registry()`` carries engine/index/
  ingest-level signals (IVF search stats, sanitizer trips, journal
  bytes, publish lag), per-runtime registries live in
  ``serving.metrics.ServingMetrics``.
- ``obs.export`` — Chrome trace-event JSON (Perfetto-loadable) and
  Prometheus text exposition; ``python -m repro_torch.obs trace.json``
  renders a per-stage p50/p99 breakdown.

- ``obs.explain`` — structured per-query EXPLAIN plans (``QueryPlan``):
  index kind, probe set + exact-mode widen/bound evidence, candidate
  counts, cache disposition, and per-stage durations collected via the
  tracer's ``StageCollector``; ``python -m repro_torch.obs explain plans.json``
  renders the text tree.
- ``obs.ledger`` — ``ResourceLedger``: resident bytes per (tenant,
  generation, plane); the container pool's byte-budget eviction and
  ``ServingRuntime.resources()`` both read from it.
- ``obs.health`` — ``HealthMonitor``: rolling-window SLO burn-rate
  alerting (``ok | degraded | critical``) over the serving metrics.

See docs/ARCHITECTURE.md §12 for the span model and overhead contract,
§14 for EXPLAIN / ledger / SLO semantics.
"""
from repro_torch.obs import trace
from repro_torch.obs.explain import QueryPlan, load_plans, write_plans
from repro_torch.obs.export import (
    chrome_trace,
    format_breakdown,
    load_chrome_trace,
    render_prometheus,
    request_decomposition,
    stage_breakdown,
    write_chrome_trace,
)
from repro_torch.obs.health import HealthMonitor, SLOTargets
from repro_torch.obs.ledger import ResourceLedger
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    LogHistogram,
    MetricsRegistry,
    global_registry,
)
from repro_torch.obs.trace import SpanRecord, StageCollector, Tracer

__all__ = [
    "trace",
    "Tracer",
    "SpanRecord",
    "StageCollector",
    "MetricsRegistry",
    "LogHistogram",
    "Counter",
    "Gauge",
    "global_registry",
    "QueryPlan",
    "write_plans",
    "load_plans",
    "ResourceLedger",
    "HealthMonitor",
    "SLOTargets",
    "chrome_trace",
    "write_chrome_trace",
    "load_chrome_trace",
    "stage_breakdown",
    "request_decomposition",
    "format_breakdown",
    "render_prometheus",
]
