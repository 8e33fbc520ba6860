"""The flash kernel's share of its roofline in the profiled slice (%):
the least time of every prefill attention the slice's answers needed
(``pbkit/counting.flash_bound_s`` at each prompt's true length, one a
layer) over the device time of the ``flash_fwd`` launches."""
from pbkit import counting

PREFIX = "flash_fwd"


def read(run):
    prof = run.profile
    if prof is None or run.peaks is None or not prof.answers:
        return None
    busy = sum(d for name, _, d in prof.kernels
               if PREFIX in name) / 1e6
    if busy <= 0:
        return None
    n_layers = len(run.counts["layer_params"])
    bound = sum(n_layers * counting.flash_bound_s(run.counts,
                                                  r.out.prompt_len, run.peaks)
                for r in prof.answers)
    return 100.0 * bound / busy
