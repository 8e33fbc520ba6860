"""95th percentile of the time from ``submit()`` to the served result
resolving (as the user's thread sees it), over every retrieval asked
and resolved in the window (ms).  Host-paced and noisy (a spread of
12-32 % between runs of one seed), so it is a per-layer reading of the
answer's first leg and not an end-to-end metric with a bound."""
from pbkit.stats import percentile


def read(run):
    lat = [(r.t_retrieved - r.t_submit) * 1e3 for r in run.retrievals]
    return percentile(lat, 95) if lat else None
