"""Model FLOPs of every prefill and decode of the answers asked and
completed in the window (``pbkit/counting.answer_flops``: counted from
the published configuration at each prompt's true length), over the
window's time as ``answer_tokens_per_s`` takes it and the card's bf16
peak (%)."""
from pbkit import counting


def read(run):
    last = run.t_last_done
    if run.peaks is None or last is None or last <= run.t0:
        return None
    flops = sum(counting.answer_flops(run.counts, r.out.prompt_len,
                                      len(r.out.token_ids))
                for r in run.answers)
    return 100.0 * flops / (last - run.t0) / run.peaks["bfloat16"]
