"""Median of the program's decode ``step_launch`` spans in the window
(ms): the host's enqueue of one decode step (its input tensors built
and copied in, the graph launched), before it blocks on the token."""
from pbkit.stats import percentile


def read(run):
    spans = [s for s in run.spans_named("step_launch")
             if s.args.get("step") == "decode"]
    return percentile([s.dur_ns / 1e6 for s in spans], 50) if spans else None
