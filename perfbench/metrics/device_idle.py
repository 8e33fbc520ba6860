"""The share of the profiled slice in which no kernel, copy or memset
ran on the card (%), from ``torch.profiler``'s device activities."""


def read(run):
    prof = run.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - prof.busy_s() / prof.window_s)
