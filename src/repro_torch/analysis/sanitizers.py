"""Opt-in runtime sanitizers: NaN/Inf score guard (+ retrace-guard API).

The NaN/Inf guard catches a non-finite score escaping a scoring path
(which top-k silently absorbs until results are garbage).  It is
disabled by default and costs nothing when off.  Enable with
``RAGDB_SANITIZERS=1`` or programmatically via :func:`enable`.  A
tripped sanitizer raises :class:`SanitizerError` (an ``AssertionError``
subclass, so test harnesses that catch assertion failures see it
naturally).

The retrace guard keeps the JAX package's ``RetraceGuard`` protocol so
the serving runtime composes the same way, but it is a documented no-op
here: PyTorch runs eagerly and this package compiles nothing per shape,
so there is no jit cache whose growth could be counted; ``check`` never
trips.

This module is stdlib-only and imports neither torch nor numpy — hot
modules import it at load time; it duck-types on the score arrays
handed to it (elementwise comparison).
"""
from __future__ import annotations

import os
import threading

from repro_torch.obs.metrics import global_registry

ENV_FLAG = "RAGDB_SANITIZERS"

_TRUTHY = {"1", "true", "yes", "on"}

_enabled: bool | None = None  # None → read ENV_FLAG lazily


class SanitizerError(AssertionError):
    """A runtime invariant the sanitizers guard was violated."""


def _count_trip(rule: str, where: str) -> None:
    """Surface a trip as a first-class metric before the raise — the
    exception may be swallowed by a request future, but the counter
    survives in the obs registry for the metrics endpoint."""
    global_registry().counter(
        "ragdb_sanitizer_trips_total",
        "runtime sanitizer violations (finite-score / retrace guards)",
        rule=rule, where=where,
    ).inc()


def enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get(ENV_FLAG, "").strip().lower() in _TRUTHY


def enable(on: bool = True) -> None:
    """Programmatic override of the env flag (tests, bench harness)."""
    global _enabled
    _enabled = on


# --------------------------------------------------------------------------
# NaN/Inf score guard
# --------------------------------------------------------------------------

def check_finite_scores(vals, n_rows: int, where: str) -> None:
    """Raise if any selected top-k score in the first ``n_rows`` rows is
    NaN or ±Inf.

    ``vals`` is the host-side (row, k) score array at the one audited
    device→host boundary (``engine.results_from_topk``).  Rows beyond
    ``n_rows`` are bucket padding and legitimately hold -inf sentinels;
    selected scores of real rows must be finite.
    """
    if not enabled():
        return
    head = vals[:n_rows]
    # duck-typed finiteness: x != x catches NaN; the comparisons catch
    # ±inf without importing numpy here
    bad = (head != head) | (head == float("inf")) | (head == float("-inf"))
    if bool(bad.any()):
        _count_trip("finite-scores", where)
        raise SanitizerError(
            f"non-finite score escaped the scoring path at {where}: "
            f"{int(bad.sum())} of {head.size} selected scores are "
            "NaN/Inf — upstream vectors or masks are corrupt"
        )


# --------------------------------------------------------------------------
# Retrace guard (no-op under eager PyTorch; see module docstring)
# --------------------------------------------------------------------------

class RetraceGuard:
    """The JAX package's retrace guard protocol (arm after warmup,
    ``check`` after each flush, ``reset`` on publish).  Under eager
    PyTorch there is no recompile to detect, so ``check`` never trips
    and ``report`` is always empty; ``armed`` still tracks the protocol
    state so callers behave identically."""

    def __init__(self) -> None:
        self._armed = False
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self._armed

    def arm(self) -> None:
        with self._lock:
            self._armed = True

    def reset(self) -> None:
        with self._lock:
            self._armed = False

    def report(self) -> dict[str, int]:
        return {}

    def check(self, where: str) -> None:
        return None
