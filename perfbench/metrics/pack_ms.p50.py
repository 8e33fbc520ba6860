"""Median of the program's ``pack_context`` spans in the window (ms):
the generator packing the retrieved passages and the question into the
prompt (``RAGPipeline.generate``), on the host."""
from pbkit.stats import percentile


def read(run):
    spans = run.spans_named("pack_context")
    return percentile([s.dur_ns / 1e6 for s in spans], 50) if spans else None
