"""Median over the window's answers of ``RAGOutput.decode_s`` over the
answer's tokens (ms a token)."""
from pbkit.stats import percentile


def read(run):
    xs = [r.out.decode_s / len(r.out.token_ids) * 1e3 for r in run.answers
          if r.out.token_ids]
    return percentile(xs, 50) if xs else None
