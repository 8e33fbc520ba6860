"""SLO health monitor: rolling windows + multi-window burn-rate alerts.

Turns the cumulative counters/histograms the serving plane already
records into an operational verdict: ``ok | degraded | critical`` with
machine-readable reasons.  The design follows SRE burn-rate alerting:

- Every ``check()`` appends one *sample* (cumulative counter values +
  a latency bucket-snapshot) to a bounded deque; windowed rates are
  **deltas between samples**, so the monitor is O(1) memory and never
  rescans request history.
- Each SLO signal (error rate, reject rate, p99 latency) is evaluated
  over a **fast** and a **slow** window.  The *burn rate* is
  observed/target; ``degraded`` fires when the fast window burns ≥
  ``degraded_burn`` (default 1.0 — burning exactly the budget), and
  ``critical`` requires the fast window to burn ≥ ``critical_burn``
  *and* the slow window to confirm (≥ ``degraded_burn``) — a brief
  spike can degrade, but only sustained burn escalates.
- **Degradation detectors** ride along on signals other planes emit:
  exact-mode widen-round spikes (``ragdb_ivf_widen_rounds``),
  result-cache hit-rate collapse, and sanitizer trips
  (``ragdb_sanitizer_trips_total`` — any trip in the fast window is
  critical: a non-finite score or steady-state recompile is never
  routine).
- Publish lag is an instantaneous gauge (per tenant), compared
  directly against its target.

``ServingRuntime.health()`` wires a monitor to its ``ServingMetrics``
and exports ``ragdb_health_status`` (0 ok / 1 degraded / 2 critical)
plus per-signal burn gauges into the runtime registry so the verdict
ships in the Prometheus rendering.  The clock is injectable for
deterministic fault-injection tests.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from repro_torch.obs.metrics import LogHistogram, global_registry

_STATUS_RANK = {"ok": 0, "degraded": 1, "critical": 2}


@dataclass(frozen=True)
class SLOTargets:
    """Objectives + alerting policy.  ``None`` disables a signal."""

    p99_ms: float | None = 250.0      # end-to-end latency objective
    error_rate: float | None = 0.02   # failed / (completed + failed)
    reject_rate: float | None = 0.10  # rejected / submitted
    publish_lag_s: float | None = None
    widen_rounds_mean: float | None = 3.0   # exact-mode widen spike
    cache_hit_floor: float | None = None    # hit-rate collapse detector
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    min_samples: int = 20             # min fast-window requests to judge
    degraded_burn: float = 1.0
    critical_burn: float = 2.0


class HealthMonitor:
    """See module docstring.  One monitor per serving runtime."""

    def __init__(self, metrics, *, targets: SLOTargets | None = None,
                 registries=None, clock=time.monotonic,
                 export_registry=None):
        self.metrics = metrics          # ServingMetrics (health_sample())
        self.targets = targets or SLOTargets()
        # registries scanned for cross-plane signals (widen rounds,
        # sanitizer trips, publish lag); () isolates tests from global
        # state
        self.registries = (tuple(registries) if registries is not None
                           else (global_registry(),))
        self.clock = clock
        self.export_registry = export_registry
        cap = max(8, int(self.targets.slow_window_s) * 4)
        self._samples: deque = deque(maxlen=min(cap, 4096))

    # ---- sampling -------------------------------------------------------

    def _scan_registries(self) -> dict:
        widen_n = 0
        widen_sum = 0.0
        trips = 0
        lags: dict[str, float] = {}
        for reg in self.registries:
            for _labels, h in reg.series("ragdb_ivf_widen_rounds").items():
                widen_n += h.n
                widen_sum += h.total
            for _labels, c in reg.series(
                    "ragdb_sanitizer_trips_total").items():
                trips += c.value
            for labels, g in reg.series(
                    "ragdb_publish_lag_seconds").items():
                lags[dict(labels).get("tenant", "-")] = g.value
        return {"widen_n": widen_n, "widen_sum": widen_sum,
                "sanitizer_trips": trips, "publish_lag": lags}

    def sample(self) -> dict:
        """Append one cumulative sample (call on every ``check()``)."""
        s = {"t": self.clock()}
        s.update(self.metrics.health_sample())
        s.update(self._scan_registries())
        self._samples.append(s)
        return s

    def _window_delta(self, now: float, window_s: float):
        """(old, new) sample pair spanning ≈ the window: the anchor is
        the newest sample at least ``window_s`` old (else the oldest
        available).  None until two samples exist."""
        if len(self._samples) < 2:
            return None
        new = self._samples[-1]
        anchor = None
        for s in self._samples:
            if now - s["t"] >= window_s:
                anchor = s
            else:
                break
        if anchor is None or anchor is new:
            anchor = self._samples[0]
        if anchor is new:
            anchor = self._samples[-2]
        return anchor, new

    # ---- windowed signal math ------------------------------------------

    @staticmethod
    def _rates(old: dict, new: dict) -> dict:
        req = new["requests"] - old["requests"]
        comp = new["completed"] - old["completed"]
        rej = new["rejected"] - old["rejected"]
        fail = new["failed"] - old["failed"]
        hits = new["cache_hits"] - old["cache_hits"]
        miss = new["cache_misses"] - old["cache_misses"]
        served = comp + fail
        lookups = hits + miss
        return {
            "requests": req,
            "error_rate": fail / served if served else 0.0,
            "reject_rate": rej / req if req else 0.0,
            "cache_hit_rate": hits / lookups if lookups else None,
            "p99_s": _bucket_diff_p99(old["latency_buckets"],
                                      new["latency_buckets"]),
            "widen_mean": (
                (new["widen_sum"] - old["widen_sum"])
                / (new["widen_n"] - old["widen_n"])
                if new["widen_n"] > old["widen_n"] else None),
            "sanitizer_trips": (new["sanitizer_trips"]
                                - old["sanitizer_trips"]),
        }

    def status(self) -> dict:
        """Evaluate the SLOs against the buffered samples (read-only —
        ``check()`` is sample + status + export)."""
        t = self.targets
        now = self._samples[-1]["t"] if self._samples else self.clock()
        fast = self._window_delta(now, t.fast_window_s)
        slow = self._window_delta(now, t.slow_window_s)
        out = {"status": "ok", "reasons": [], "signals": {}}
        if fast is None:
            out["signals"]["note"] = "warming up (<2 samples)"
            return out
        fr = self._rates(*fast)
        sr = self._rates(*slow) if slow else fr
        out["signals"]["fast"] = fr
        out["signals"]["slow"] = sr

        def escalate(level: str, reason: str) -> None:
            if _STATUS_RANK[level] > _STATUS_RANK[out["status"]]:
                out["status"] = level
            out["reasons"].append(reason)

        def burn_signal(name: str, fast_v, slow_v, target) -> None:
            if target is None or fast_v is None:
                return
            burn_f = fast_v / target if target > 0 else 0.0
            burn_s = (slow_v / target
                      if target > 0 and slow_v is not None else 0.0)
            out["signals"][f"{name}_burn_fast"] = round(burn_f, 3)
            out["signals"][f"{name}_burn_slow"] = round(burn_s, 3)
            if burn_f >= t.critical_burn and burn_s >= t.degraded_burn:
                escalate("critical",
                         f"{name} burn {burn_f:.2f}x fast / "
                         f"{burn_s:.2f}x slow (target {target})")
            elif burn_f >= t.degraded_burn:
                escalate("degraded",
                         f"{name} burn {burn_f:.2f}x in fast window "
                         f"(target {target})")

        judged = fr["requests"] >= t.min_samples
        if judged:
            burn_signal("error_rate", fr["error_rate"],
                        sr["error_rate"], t.error_rate)
            burn_signal("reject_rate", fr["reject_rate"],
                        sr["reject_rate"], t.reject_rate)
            if t.p99_ms is not None:
                burn_signal("p99", fr["p99_s"], sr["p99_s"],
                            t.p99_ms / 1e3)
        else:
            out["signals"]["note"] = (
                f"fast window below min_samples "
                f"({fr['requests']}/{t.min_samples})")

        # ---- degradation detectors --------------------------------------
        if fr["sanitizer_trips"] > 0:
            escalate("critical",
                     f"{fr['sanitizer_trips']} sanitizer trip(s) in "
                     f"fast window (non-finite scores or steady-state "
                     f"recompiles)")
        if (t.widen_rounds_mean is not None
                and fr["widen_mean"] is not None
                and fr["widen_mean"] > t.widen_rounds_mean):
            escalate("degraded",
                     f"ivf widen-round spike: mean "
                     f"{fr['widen_mean']:.1f} rounds/dispatch "
                     f"(> {t.widen_rounds_mean})")
        if (t.cache_hit_floor is not None and judged
                and fr["cache_hit_rate"] is not None
                and fr["cache_hit_rate"] < t.cache_hit_floor):
            escalate("degraded",
                     f"cache hit-rate collapse: "
                     f"{fr['cache_hit_rate']:.2f} "
                     f"(< {t.cache_hit_floor})")
        if t.publish_lag_s is not None:
            for tenant, lag in self._samples[-1]["publish_lag"].items():
                if lag > t.publish_lag_s:
                    escalate("degraded",
                             f"publish lag {lag:.2f}s for tenant "
                             f"{tenant} (> {t.publish_lag_s}s)")
        return out

    def check(self) -> dict:
        """Sample + evaluate + export: the one call drivers make."""
        self.sample()
        out = self.status()
        if self.export_registry is not None:
            reg = self.export_registry
            reg.gauge("ragdb_health_status",
                      "0 ok / 1 degraded / 2 critical").set(
                _STATUS_RANK[out["status"]])
            for key in ("error_rate_burn_fast", "reject_rate_burn_fast",
                        "p99_burn_fast"):
                if key in out["signals"]:
                    reg.gauge(f"ragdb_health_{key}",
                              "fast-window SLO burn rate").set(
                        out["signals"][key])
        return out


def _bucket_diff_p99(old: tuple, new: tuple) -> float | None:
    """p99 of the *window* between two cumulative bucket snapshots
    (geometric bucket midpoints, same estimator as LogHistogram)."""
    old_counts, old_n = old[0], old[1]
    new_counts, new_n, _total, new_min, new_max = new
    n = new_n - old_n
    if n <= 0:
        return None
    counts = [b - a for a, b in zip(old_counts, new_counts)]
    rank = 0.99 * (n - 1)
    bounds = [LogHistogram.BASE * LogHistogram.GROWTH ** i
              for i in range(LogHistogram.N_BUCKETS)]
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum > rank:
            if i >= LogHistogram.N_BUCKETS:
                return new_max
            if i == 0:
                est = bounds[0] / LogHistogram.GROWTH ** 0.5
            else:
                est = bounds[i - 1] * LogHistogram.GROWTH ** 0.5
            return min(max(est, new_min), new_max)
    return new_max
