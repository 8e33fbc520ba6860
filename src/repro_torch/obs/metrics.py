"""Generalized metrics registry: counters / gauges / histograms with labels.

Supersedes the ad-hoc counter fields that ``serving.metrics.
ServingMetrics`` used to carry: every plane (scheduler, engine, IVF,
ingest/persistence, sanitizers) records into a ``MetricsRegistry`` —
either the process-wide ``global_registry()`` for engine/index/ingest
level signals, or a per-runtime instance owned by ``ServingMetrics``.
Pure stdlib; rendering to Prometheus text exposition lives in
``obs/export.py``.

Memory is O(#distinct (name, labels) series); histograms are
fixed-bucket (``LogHistogram``), so nothing here grows with request
count.
"""
from __future__ import annotations

import threading
from bisect import bisect_left


class LogHistogram:
    """Fixed log-spaced buckets, 10 µs … ~79 s (×1.25 per bucket), plus
    one overflow bucket.

    ``percentile`` returns the geometric midpoint of the bucket holding
    the requested rank, clamped to the observed [min, max] — a ≤ ~12 %
    quantization error, plenty for p50/p99 serving dashboards, with
    O(1) memory forever.  The [min, max] clamp makes single-sample
    histograms exact (p50 == p99 == max) and keeps percentiles
    monotonic in q.  Thread-safe.
    """

    N_BUCKETS = 72
    BASE = 10e-6
    GROWTH = 1.25

    def __init__(self):
        self.bounds = [
            self.BASE * self.GROWTH ** i for i in range(self.N_BUCKETS)
        ]
        self.counts = [0] * (self.N_BUCKETS + 1)  # +1 overflow bucket
        self.n = 0
        self.total = 0.0
        self.max = 0.0
        self.min = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self.counts[bisect_left(self.bounds, seconds)] += 1
            if self.n == 0 or seconds < self.min:
                self.min = seconds
            self.n += 1
            self.total += seconds
            if seconds > self.max:
                self.max = seconds

    def percentile(self, q: float) -> float:
        """q in [0, 100] → seconds (0.0 when empty)."""
        if self.n == 0:
            return 0.0
        rank = q / 100.0 * (self.n - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                if i >= self.N_BUCKETS:
                    return self.max  # overflow bucket: > ~79 s
                if i == 0:
                    est = self.bounds[0] / self.GROWTH ** 0.5
                else:
                    # geometric bucket midpoint
                    est = self.bounds[i - 1] * self.GROWTH ** 0.5
                # clamp to the observed range: exact for single-sample
                # histograms, and never reports outside the data
                return min(max(est, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def bucket_snapshot(self) -> tuple:
        """One coherent ``(counts, n, sum, min, max)`` read — the SLO
        health monitor diffs two of these to compute *windowed*
        percentiles from a cumulative histogram."""
        with self._lock:
            return (list(self.counts), self.n, self.total,
                    self.min, self.max)

    def snapshot(self) -> dict:
        """One coherent read (record() holds the same lock)."""
        with self._lock:
            return {
                "count": self.n,
                "sum": self.total,
                "p50": self.percentile(50),
                "p99": self.percentile(99),
                "max": self.max,
                "mean": self.total / self.n if self.n else 0.0,
            }


class Counter:
    """Monotonic counter (floats allowed: byte totals, seconds)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": LogHistogram}


class MetricsRegistry:
    """Named, labeled metric families with get-or-create access.

    ``reg.counter("ragdb_requests_total", outcome="ok").inc()`` — the
    same (name, labels) pair always returns the same object, so call
    sites need no caching (though hot paths may hold the reference).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"kind", "help", "series": {sorted-label-items: metric}}
        self._families: dict[str, dict] = {}

    def _get(self, kind: str, name: str, help_: str, labels: dict):
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    "kind": kind, "help": help_, "series": {}}
            elif fam["kind"] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam['kind']}, not a {kind}")
            m = fam["series"].get(key)
            if m is None:
                m = fam["series"][key] = _KINDS[kind]()
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> LogHistogram:
        return self._get("histogram", name, help, labels)

    # ---- series lifecycle -----------------------------------------------

    def series(self, name: str) -> dict:
        """Read-only {labels-tuple: metric} for one family ({} when the
        family doesn't exist) — health detectors sum over this."""
        with self._lock:
            fam = self._families.get(name)
            return dict(fam["series"]) if fam else {}

    def prune(self, name: str | None = None, **labels) -> int:
        """Drop every series whose labels include all of ``labels``
        (optionally restricted to one family); empty families are
        removed entirely.  This is the tenant-evict path: without it,
        long-lived zipf traffic over many tenants grows label
        cardinality without bound and evicted tenants' gauges
        (publish-lag, resident-bytes) go stale instead of disappearing.
        Returns the number of series removed.  A later get-or-create
        with the same (name, labels) recreates the series fresh (and a
        pruned family's *kind* is forgotten with it)."""
        items = tuple(labels.items())
        removed = 0
        with self._lock:
            for fam_name in list(self._families):
                if name is not None and fam_name != name:
                    continue
                series = self._families[fam_name]["series"]
                for key in [k for k in series
                            if all(it in k for it in items)]:
                    del series[key]
                    removed += 1
                if not series:
                    del self._families[fam_name]
        return removed

    # ---- export ---------------------------------------------------------

    def collect(self) -> list:
        """[(name, kind, help, [(labels_dict, metric), ...]), ...] in
        registration order; the exporters consume this."""
        with self._lock:
            return [
                (name, fam["kind"], fam["help"],
                 [(dict(key), m) for key, m in fam["series"].items()])
                for name, fam in self._families.items()
            ]

    def snapshot(self) -> dict:
        """Flat dict for drivers/tests: ``name{k=v,...}`` -> value
        (histograms expand to their snapshot() sub-keys)."""
        out: dict = {}
        for name, kind, _help, series in self.collect():
            for labels, m in series:
                suffix = ("{" + ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())) + "}"
                    if labels else "")
                if kind == "histogram":
                    for k, v in m.snapshot().items():
                        out[f"{name}_{k}{suffix}"] = v
                else:
                    out[f"{name}{suffix}"] = m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """Process-wide registry for engine/index/ingest-level metrics."""
    return _GLOBAL
