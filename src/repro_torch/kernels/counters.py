"""Launch counters of the kernel wrappers.

Each wrapper keeps its counts in a plain dict (``ops.counts``) and adds
one, through ``bump``, where it launches its kernel.  A CUDA graph
replays launches without running the wrappers, so a step captured into
a graph (``launch.steps.CapturedStep``) records what its own thread
bumps while the step is warmed up and captured (``recording``): it takes
those set-up passes back out of the counts, and adds the captured
pass's bumps again at every replay (``add``).  Bumps made by other
threads meanwhile (a serving runtime's retrieval dispatches) are not
recorded, so they are neither taken out nor replayed.
"""
from __future__ import annotations

import contextlib
import threading

_TABLES: dict[str, tuple[dict, threading.Lock]] = {}
_local = threading.local()


def register(name: str, table: dict, lock: threading.Lock) -> None:
    """Make ``table`` (guarded by ``lock``) the counts named ``name``."""
    _TABLES[name] = (table, lock)


def bump(name: str, key: str) -> None:
    table, lock = _TABLES[name]
    with lock:
        table[key] += 1
    records = getattr(_local, "records", None)
    if records is not None:
        records.append((name, key))


@contextlib.contextmanager
def recording():
    """Collect this thread's bumps, as (table name, key), while open.  An
    enclosing recording sees them too, once this one closes."""
    outer = getattr(_local, "records", None)
    records: list[tuple[str, str]] = []
    _local.records = records
    try:
        yield records
    finally:
        _local.records = outer
        if outer is not None:
            outer.extend(records)


def tally(records, times: int = 1) -> dict[tuple[str, str], int]:
    """{(table name, key): count × ``times``} over ``records``."""
    out: dict[tuple[str, str], int] = {}
    for name_key in records:
        out[name_key] = out.get(name_key, 0) + times
    return out


def add(deltas: dict[tuple[str, str], int]) -> None:
    """Add ``deltas`` ({(table name, key): n}, n may be negative) to the
    counts; nothing is recorded."""
    for (name, key), n in deltas.items():
        table, lock = _TABLES[name]
        with lock:
            table[key] += n
