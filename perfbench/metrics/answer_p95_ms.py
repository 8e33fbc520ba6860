"""95th percentile of the time from ``submit()`` to the returned
answer, over every answer asked and completed in the window (ms).  A
question still open at the close that is older than the slowest answer
enters the tail with its age then: a stall at the close is not hidden."""
from pbkit.stats import percentile


def read(run):
    lat = [(r.t_done - r.t_submit) * 1e3 for r in run.answers]
    if not lat:
        return None
    slowest = max(lat)
    lat += [a * 1e3 for a in run.open_ages if a * 1e3 > slowest]
    return percentile(lat, 95)
