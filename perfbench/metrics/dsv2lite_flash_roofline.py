"""The flash kernel's MLA design (``flash_fwd_wgmma<192, 128>``: q/k 192
wide, v 128) against its roofline in the profiled slice (%): the least
time of every prefill attention the slice's answers needed
(``pbkit/counting.flash_bound_s`` at dqk 192, dv 128 and each prompt's
true length, one a layer) over the device time of that design's
launches.  Nothing where the configuration's heads are not 192/128 or
no launch of the design is in the slice (a route that pads the heads)."""
import re

from pbkit import counting

DESIGN = re.compile(r"flash_fwd_wgmma<\s*192\s*,\s*128\s*>")


def read(run):
    prof, c = run.profile, run.counts
    if prof is None or run.peaks is None or not prof.answers \
            or (c.get("dqk"), c.get("dv")) != (192, 128):
        return None
    busy = sum(d for name, _, d in prof.kernels
               if DESIGN.search(name)) / 1e6
    if busy <= 0:
        return None
    n_layers = len(c["layer_params"])
    bound = sum(n_layers * counting.flash_bound_s(c, r.out.prompt_len,
                                                  run.peaks)
                for r in prof.answers)
    return 100.0 * bound / busy
