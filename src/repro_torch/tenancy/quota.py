"""Per-tenant admission quotas: token buckets at the serving front door.

The multiplexed pool has one flusher thread and one device; without
admission control a single hot tenant fills the shared queue and every
other tenant's tail latency follows it (the trade-off Shen et al.,
arXiv 2412.11854, measure for multiplexed RAG serving).  The remedy is
the classic token bucket: tenant *t* accrues ``rate`` tokens/second up
to a ``burst`` cap, each admitted request spends one token, and an
empty bucket turns into ``RequestRejected(tenant=t)`` at ``submit()``
— explicit per-tenant backpressure *before* the request touches the
shared queue, so an overloaded tenant is clipped at its own quota and
the pool's capacity stays available to everyone else.

Refill is computed lazily from a monotonic clock on each acquire (no
timer thread); ``now`` is injectable for deterministic tests.  A
``TenantQuotas`` table maps tenant ids to buckets, with an optional
default applied to tenants that have no explicit entry (``None``
default = unlimited, the single-tenant behavior).
"""
from __future__ import annotations

import threading
import time


class TokenBucket:
    """One tenant's admission budget: ``rate`` tokens/s, ``burst`` cap."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        self._tokens = self.burst  # start full: first requests admit
        self._t_last = None        # lazy: first acquire stamps the clock
        self._lock = threading.Lock()

    def try_acquire(self, now: float | None = None) -> bool:
        """Spend one token if available; never blocks."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._t_last is not None and now > self._t_last:
                self._tokens = min(
                    self.burst, self._tokens + (now - self._t_last) * self.rate
                )
            self._t_last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class TenantQuotas:
    """Tenant id → TokenBucket, with an optional default for tenants
    not explicitly configured (``default_rate=None`` = unlimited)."""

    def __init__(self, default_rate: float | None = None,
                 default_burst: float | None = None):
        self.default_rate = default_rate
        self.default_burst = default_burst
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def set(self, tenant: str, rate: float,
            burst: float | None = None) -> TokenBucket:
        """Install (or replace) tenant's bucket; returns it."""
        bucket = TokenBucket(rate, burst)
        with self._lock:
            self._buckets[tenant] = bucket
        return bucket

    def bucket(self, tenant: str) -> TokenBucket | None:
        """Tenant's bucket, lazily created from the default (None when
        neither an explicit bucket nor a default rate exists —
        unlimited admission)."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None and self.default_rate is not None:
                b = TokenBucket(self.default_rate, self.default_burst)
                self._buckets[tenant] = b
            return b

    def try_acquire(self, tenant: str, now: float | None = None) -> bool:
        b = self.bucket(tenant)
        return True if b is None else b.try_acquire(now)
