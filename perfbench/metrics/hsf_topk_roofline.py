"""The fused HSF top-k kernel's share of its roofline in the profiled
slice (%): the least time of every dispatch (``pbkit/counting.
hsf_bound_s``, the real queries, not the padded bucket) over the device
time of its launches (``hsf_topk_split``, ``_tiles``, ``_merge``).  A
dispatch is one ``hsf_topk_tiles`` launch; its real queries are the
``pack`` spans' unique texts in the slice."""
from pbkit import counting

PREFIX = "hsf_topk_"


def read(run):
    prof = run.profile
    if prof is None or run.peaks is None:
        return None
    launches = [(n, d) for n, _, d in prof.kernels if PREFIX in n]
    dispatches = sum("hsf_topk_tiles" in n for n, _ in launches)
    busy = sum(d for _, d in launches) / 1e6
    if dispatches == 0 or busy <= 0:
        return None
    lo, hi = prof.t_start * 1e9, prof.t_stop * 1e9
    unique = [s.args.get("unique", 1) for s in run.spans
              if s.name == "pack" and lo <= s.t0_ns <= hi]
    queries = sum(unique) / len(unique) if unique else 1.0
    r, n = run.cell.config["retrieval"], run.cell.config["n_docs"]
    bound = dispatches * counting.hsf_bound_s(
        n, r["dim"], r["sig_words"], queries, r["top_k"], run.peaks)
    return 100.0 * bound / busy
