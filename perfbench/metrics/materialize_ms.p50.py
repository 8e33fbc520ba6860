"""Median of the program's ``materialize`` spans in the window (ms):
the engine's turning of the top-k rows into results."""
from pbkit.stats import percentile


def read(run):
    spans = run.spans_named("materialize")
    return percentile([s.dur_ns / 1e6 for s in spans], 50) if spans else None
