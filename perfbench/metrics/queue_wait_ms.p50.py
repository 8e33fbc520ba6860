"""Median of the program's ``queue_wait`` spans in the window (ms):
the scheduler's queue (from submit to the flusher taking the request)."""
from pbkit.stats import percentile


def read(run):
    spans = run.spans_named("queue_wait")
    return percentile([s.dur_ns / 1e6 for s in spans], 50) if spans else None
