"""Median prefill time of the window's answers (ms): the pipeline's
``RAGOutput.prefill_s``, which ends in the first token's read-back."""
from pbkit.stats import percentile


def read(run):
    xs = [r.out.prefill_s * 1e3 for r in run.answers]
    return percentile(xs, 50) if xs else None
