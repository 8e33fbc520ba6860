"""Median of the program's ``query_embed`` spans in the window (ms):
the engine's query vectorizing and signing on the host."""
from pbkit.stats import percentile


def read(run):
    spans = run.spans_named("query_embed")
    return percentile([s.dur_ns / 1e6 for s in spans], 50) if spans else None
