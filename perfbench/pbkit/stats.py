"""Percentiles of the benchmark's samples: linear interpolation between
the order statistics (numpy's default method), so p50 of an even count
is the mean of the middle two."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
