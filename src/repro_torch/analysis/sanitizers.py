"""Opt-in runtime sanitizers: NaN/Inf score guard + capture guard.

The NaN/Inf guard catches a non-finite score escaping a scoring path
(which top-k silently absorbs until results are garbage).  It is
disabled by default and costs nothing when off.  Enable with
``RAGDB_SANITIZERS=1`` or programmatically via :func:`enable`.  A
tripped sanitizer raises :class:`SanitizerError` (an ``AssertionError``
subclass, so test harnesses that catch assertion failures see it
naturally).

The capture guard is the JAX package's retrace guard over what this
package compiles: CUDA graph captures.  Every
``launch.steps.CapturedStep`` registers itself here when it is made
(``register_capture``); a warmed serving loop captures nothing more, so
a capture after :meth:`RetraceGuard.arm` means a shape escaped the
bucket discipline (a query batch or a prompt bucket that was never
warmed) and paid a capture — tens to hundreds of milliseconds — on the
hot path.  On the CPU a ``CapturedStep`` runs eagerly and captures
nothing, so the guard stays silent there.

This module is stdlib-only and imports neither torch nor numpy — hot
modules import it at load time; it duck-types on the score arrays
handed to it (elementwise comparison) and on the registered steps
(``name`` and ``captures``).
"""
from __future__ import annotations

import os
import threading
import weakref

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
# Capture guard (the JAX package's retrace guard over CUDA graph captures)
# --------------------------------------------------------------------------

# every live captured step, by identity: a step holder made anew (a
# GenerationSteps for another horizon) leaves with its steps
_registry: "weakref.WeakSet" = weakref.WeakSet()
_registry_lock = threading.Lock()


def register_capture(step) -> None:
    """Register a captured step for capture accounting: any object with
    a ``name`` (str) and a ``captures`` count (int) — what
    ``CapturedStep`` is.  Held weakly; costs one set slot when
    sanitizers are off."""
    with _registry_lock:
        _registry.add(step)


def capture_counts() -> dict[str, int]:
    """Captures per registered step name (steps of one name summed, so
    a new step of a known name that captures still counts)."""
    with _registry_lock:
        steps = list(_registry)
    out: dict[str, int] = {}
    for step in steps:
        out[step.name] = out.get(step.name, 0) + int(step.captures)
    return out


class RetraceGuard:
    """Asserts zero steady-state CUDA graph captures after an explicit
    warmup (the JAX package's guard asserts zero jit recompiles).

    Protocol (wired through ``ServingRuntime``):

    1. warm every power-of-two batch bucket the serving loop can emit,
       and capture every prompt bucket of the generation steps served;
    2. :meth:`arm` — baseline the per-step capture counts;
    3. the scheduler calls :meth:`check` after each flush, and a
       ``RAGPipeline`` the runtime armed after each generation — any
       growth means a shape escaped the bucket discipline and was
       captured on the hot path;
    4. a snapshot publish calls :meth:`reset` (a new corpus generation
       may legitimately warm new shapes); the caller re-arms after
       re-warming.

    After a trip the baseline is rebased to the current counts, so one
    regression raises once instead of failing every later batch.
    """

    def __init__(self) -> None:
        self._baseline: dict[str, int] | None = None
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self._baseline is not None

    def arm(self) -> None:
        with self._lock:
            self._baseline = capture_counts()

    def reset(self) -> None:
        with self._lock:
            self._baseline = None

    def report(self) -> dict[str, int]:
        """Captures per step since arming (empty when clean)."""
        with self._lock:
            if self._baseline is None:
                return {}
            now = capture_counts()
            return {
                name: n - self._baseline.get(name, 0)
                for name, n in now.items()
                if n > self._baseline.get(name, 0)
            }

    def check(self, where: str) -> None:
        if not enabled():
            return
        with self._lock:
            if self._baseline is None:
                return
            now = capture_counts()
            grew = {
                name: (self._baseline.get(name, 0), n)
                for name, n in now.items()
                if n > self._baseline.get(name, 0)
            }
            if grew:
                self._baseline = now  # rebase: report each regression once
        if grew:
            _count_trip("retrace", where)
            detail = ", ".join(
                f"{name}: {a}→{b}" for name, (a, b) in sorted(grew.items())
            )
            raise SanitizerError(
                f"steady-state CUDA graph capture at {where}: {detail} — "
                "a shape escaped the power-of-two bucket discipline "
                "(warm every bucket before arming)"
            )
