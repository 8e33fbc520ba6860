"""Span tracer: monotonic-clock spans in a bounded ring buffer.

The serving/index/ingest planes are instrumented with spans (named,
timed intervals carrying a trace id, a parent id, and key=value args).
This module is the zero-dependency substrate they record into — pure
stdlib, importable from ``core/container.py`` upward without cycles,
in the same spirit as ``analysis/sanitizers.py``.

Contract (docs/ARCHITECTURE.md §12):

- **Off by default, near-zero cost when off.**  Every instrumentation
  site calls ``span(...)`` / ``record(...)``; when the tracer is
  disabled these return a shared no-op object after one attribute
  check — no allocation, no clock read, no lock.
- **O(1) memory forever.**  Completed spans land in a ``deque`` with a
  hard ``maxlen``; a long-running server can trace continuously and
  only ever holds the most recent ``capacity`` spans.
- **Sampling.**  ``enable(sample=0.01)`` keeps 1-in-100 *traces* (not
  spans): the sampling decision is made once per request at
  ``begin_trace`` and every child span of an unsampled trace
  short-circuits to the no-op, so a sampled request is always complete.
- **Monotonic clock.**  All timestamps are ``time.perf_counter_ns``
  (same epoch as ``time.perf_counter``), so manually-measured
  intervals from the scheduler can be recorded next to context-manager
  spans and line up on one timeline.

Parenting is implicit within a thread (a thread-local span stack) and
explicit across threads: the scheduler allocates a trace id at submit
time on the caller's thread and the flusher thread records that
request's stage spans against it via ``record(..., trace=tid)``.

Env knobs: ``RAGDB_TRACE=1`` enables the default tracer at import;
``RAGDB_TRACE_SAMPLE=0.01`` sets its sampling rate.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 65536

# the default of ``trace=`` and ``parent=``: the enclosing span's on
# this thread (a fresh trace at top level, for ``span``)
INHERIT = object()


class SpanRecord:
    """One completed span: what the ring buffer holds and exporters read."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "t0_ns", "dur_ns", "tid", "args")

    def __init__(self, name, trace_id, span_id, parent_id,
                 t0_ns, dur_ns, tid, args):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.args = args

    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, trace={self.trace_id}, "
                f"dur={self.dur_ns / 1e6:.3f}ms, args={self.args})")


class _NullSpan:
    """Shared no-op returned whenever a span would not be recorded."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL = _NullSpan()


class _SuppressScope:
    """Entered when a caller explicitly binds trace=0 (an unsampled
    request): pushes a zero trace onto this thread's stack so every
    nested span inherits 'unsampled' instead of starting a fresh
    trace.  Records nothing."""

    __slots__ = ("_tracer",)
    trace_id = 0
    span_id = 0

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self):
        self._tracer._push(0, 0)
        return self

    def __exit__(self, *exc):
        self._tracer._pop()
        return False

    def set(self, **args):
        return self


class _Span:
    """Context-manager span; emits a SpanRecord on exit.

    When a :class:`StageCollector` is active on this thread the span
    additionally feeds ``(name, dur_s, args)`` into it on exit — with
    ``trace_id=0`` that is the *only* output (EXPLAIN capture without
    the tracer buffering anything)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id",
                 "parent_id", "args", "_t0", "_col")

    def __init__(self, tracer, name, trace_id, span_id, parent_id, args,
                 col=None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self._col = col

    def set(self, **args):
        """Attach args discovered mid-span (sizes, counts, outcomes)."""
        self.args.update(args)
        return self

    def __enter__(self):
        self._tracer._push(self.trace_id, self.span_id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        self._tracer._pop()
        if self._col is not None:
            self._col.add(self.name, dur / 1e9, self.args)
        if self.trace_id:
            # raw tuple in SpanRecord field order — materialized at drain
            self._tracer._buf.append((
                self.name, self.trace_id, self.span_id, self.parent_id,
                self._t0, dur, threading.get_ident(), self.args,
            ))
        return False


class StageCollector:
    """Accumulates ``(name, dur_s, args)`` stage tuples from spans and
    ``record()`` calls executed under :func:`collect` — the substrate
    EXPLAIN plans source their per-stage durations from.  Thread-local
    (one collector per query dispatch), so no lock."""

    __slots__ = ("stages",)

    def __init__(self):
        self.stages: list = []

    def add(self, name: str, dur_s: float, args) -> None:
        self.stages.append((name, dur_s, dict(args) if args else {}))


class _CollectScope:
    """Context manager binding a StageCollector to this thread."""

    __slots__ = ("_tracer", "_col", "_prev")

    def __init__(self, tracer, col):
        self._tracer = tracer
        self._col = col

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "collector", None)
        tls.collector = self._col
        return self._col

    def __exit__(self, *exc):
        self._tracer._tls.collector = self._prev
        return False


class Tracer:
    """See module docstring.  One instance = one ring buffer."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample: float = 1.0):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._enabled = False
        # itertools.count.__next__ is a single C call — atomic under
        # the GIL, so the emit path never takes a lock
        self._ids = itertools.count(1)
        self._trace_n = itertools.count()
        self._period = 1
        self.configure(sample=sample)

    # ---- lifecycle ------------------------------------------------------

    def configure(self, *, sample: float | None = None,
                  capacity: int | None = None) -> "Tracer":
        with self._lock:
            if sample is not None:
                if not 0.0 < sample <= 1.0:
                    raise ValueError("sample must be in (0, 1]")
                self._period = max(1, round(1.0 / sample))
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = deque(self._buf, maxlen=capacity)
        return self

    def enable(self, *, sample: float | None = None,
               capacity: int | None = None) -> "Tracer":
        self.configure(sample=sample, capacity=capacity)
        self._enabled = True
        return self

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def collect(self, col: "StageCollector") -> "_CollectScope":
        """Bind ``col`` to this thread for the scope: spans and
        ``record()`` calls inside feed it even when tracing is off
        (EXPLAIN capture).  Nests; restores the previous collector."""
        return _CollectScope(self, col)

    def active(self) -> bool:
        """True when instrumentation should run its timed path: the
        tracer is enabled *or* a collector is bound to this thread.
        Host-sync gates (``block_until_ready`` before reading the
        clock) key off this so EXPLAIN gets honest device-time
        attribution."""
        return self._enabled or getattr(self._tls, "collector",
                                        None) is not None

    # ---- ids / sampling -------------------------------------------------

    def alloc_id(self) -> int:
        """A fresh nonzero id (0 always means 'none'/'unsampled')."""
        if not self._enabled:
            return 0
        return next(self._ids)

    def begin_trace(self) -> int:
        """Per-request sampling decision: a nonzero trace id when this
        request should be traced, else 0 (all its spans become no-ops)."""
        if not self._enabled:
            return 0
        if next(self._trace_n) % self._period:
            return 0
        return next(self._ids)

    # ---- recording ------------------------------------------------------

    def span(self, name: str, *, trace=INHERIT, parent=INHERIT, **args):
        """Open a span as a context manager.

        ``trace`` defaults to the enclosing span's trace on this thread
        (or a fresh ``begin_trace`` at top level); pass an explicit id
        to attach to a request trace from another thread, or 0 to
        force a no-op.  ``parent`` defaults to the enclosing span.
        """
        col = getattr(self._tls, "collector", None)
        if not self._enabled:
            if col is None:
                return _NULL
            # collector-only span: timed, feeds the collector, buffers
            # nothing (trace_id=0 also suppresses descendants' traces
            # via the stack push, like _SuppressScope)
            return _Span(self, name, 0, 0, 0, args, col)
        stack = getattr(self._tls, "stack", None)
        explicit = trace is not INHERIT
        if not explicit:
            trace = stack[-1][0] if stack else self.begin_trace()
        if not trace:
            if col is not None:
                return _Span(self, name, 0, 0, 0, args, col)
            # explicit 0 = an unsampled request: suppress descendants
            # too (otherwise they would each start orphan traces)
            return _SuppressScope(self) if explicit else _NULL
        if parent is INHERIT:
            parent = stack[-1][1] if stack else 0
        return _Span(self, name, trace, self.alloc_id(), parent, args, col)

    def record(self, name: str, t0_s: float, dur_s: float, *,
               trace=INHERIT, parent=INHERIT, span_id: int = 0,
               **args) -> int:
        """Record an already-measured interval (``time.perf_counter``
        floats) as a span — for stages timed manually, either across
        threads (explicit ``trace``) or inside an enclosing span on
        this thread (inherited; dropped at top level rather than
        starting a trace).  Returns the span id (0 when dropped)."""
        col = getattr(self._tls, "collector", None)
        if col is not None:
            col.add(name, dur_s, args)
        if not self._enabled:
            return 0
        stack = getattr(self._tls, "stack", None)
        if trace is INHERIT:
            trace = stack[-1][0] if stack else 0
        if not trace:
            return 0
        if parent is INHERIT:
            parent = stack[-1][1] if stack else 0
        sid = span_id or self.alloc_id()
        self._buf.append((
            name, trace, sid, parent,
            int(t0_s * 1e9), max(int(dur_s * 1e9), 0),
            threading.get_ident(), args,
        ))
        return sid

    def record_batch(self, trace: int, intervals) -> None:
        """Emit several already-measured intervals of one trace in a
        single call — the scheduler's per-request stage records, where
        per-call API overhead would otherwise be paid five times per
        request on the flush hot path.

        ``intervals``: iterable of ``(name, t0_s, dur_s, span_id,
        parent_id, args_or_None)``; a zero ``span_id`` allocates one.
        """
        if not self._enabled or not trace:
            return
        tid = threading.get_ident()
        emit = self._buf.append
        ids = self._ids
        for name, t0_s, dur_s, sid, parent, args in intervals:
            emit((
                name, trace, sid or next(ids), parent,
                int(t0_s * 1e9), max(int(dur_s * 1e9), 0),
                tid, args if args is not None else {},
            ))

    # ---- buffer access --------------------------------------------------

    def spans(self) -> list[SpanRecord]:
        return [SpanRecord(*t) for t in list(self._buf)]

    def drain(self) -> list[SpanRecord]:
        """Atomically take everything buffered (oldest first).  The
        ring holds raw tuples (emit-path economy); materialization to
        SpanRecord happens here, on the cold path."""
        out = []
        buf = self._buf
        while True:
            try:
                out.append(SpanRecord(*buf.popleft()))
            except IndexError:
                return out

    def __len__(self) -> int:
        return len(self._buf)

    # ---- internals ------------------------------------------------------

    def _push(self, trace_id: int, span_id: int) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append((trace_id, span_id))

    def _pop(self) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack.pop()
    # note: emits append raw tuples straight to the deque — append with
    # maxlen is atomic under the GIL, so the hot path takes no lock


# ---- module-level default tracer (what the instrumentation uses) --------

_DEFAULT = Tracer()


def get() -> Tracer:
    return _DEFAULT


def enable(*, sample: float | None = None,
           capacity: int | None = None) -> Tracer:
    return _DEFAULT.enable(sample=sample, capacity=capacity)


def disable() -> None:
    _DEFAULT.disable()


def enabled() -> bool:
    return _DEFAULT._enabled


def active() -> bool:
    """Tracing enabled or a collector bound to this thread (EXPLAIN)."""
    return _DEFAULT.active()


span = _DEFAULT.span
record = _DEFAULT.record
record_batch = _DEFAULT.record_batch
begin_trace = _DEFAULT.begin_trace
alloc_id = _DEFAULT.alloc_id
drain = _DEFAULT.drain
collect = _DEFAULT.collect


if os.environ.get("RAGDB_TRACE", "") not in ("", "0"):  # pragma: no cover
    _DEFAULT.enable(
        sample=float(os.environ.get("RAGDB_TRACE_SAMPLE", "1.0")))
