"""The decode steps' least time over the time they took, for the traced
answers of the window (%).  A step's least time is the bytes it must
read at the card's HBM rate: every active weight a generated token
passes through once in bf16 (``counts()["layer_params"]`` and the output
head, d_model × vocab) and the compressed MLA cache at that step's fill,
(kv_lora_rank + qk_rope_head_dim) × 2 B a slot and layer.  Counted from
the configuration file, never from what the program does: an answer of
n tokens needs n - 1 decode steps (the first token is the prefill's),
at fills prompt + 1 ... prompt + n - 1, whatever steps the program
runs; the time is the answer's ``RAGOutput.decode_s``.

An answer counts only where its ``generate`` span says the absorbed
decode ran every layer of every decode step the program took
(``mla_decode_layers`` = layers × its decode ``step_launch`` spans), so
the reading is of that path; nothing without such spans."""
from pbkit.counting import BF16_BYTES


def step_bytes(counts: dict, cfg: dict, fill: int) -> float:
    """Bytes one decode step must read with ``fill`` cache slots filled."""
    n_layers = len(counts["layer_params"])
    weights = sum(counts["layer_params"]) + counts["d_model"] * counts["vocab"]
    slot = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * n_layers
    return BF16_BYTES * (weights + slot * fill)


def read(run):
    if run.peaks is None:
        return None
    c, cfg = run.counts, run.cell.config
    n_layers = len(c["layer_params"])
    gens = [s for s in run.spans_named("generate")
            if "mla_decode_layers" in s.args]
    steps: dict[int, int] = {}
    for s in run.spans:
        if s.name == "step_launch" and s.args.get("step") == "decode":
            steps[s.parent_id] = steps.get(s.parent_id, 0) + 1
    need = took = 0.0
    for r in run.answers:
        lo, hi = r.t_gen_start * 1e9, r.t_done * 1e9
        span = next((s for s in gens
                     if lo <= s.t0_ns and s.t0_ns + s.dur_ns <= hi), None)
        ran = steps.get(span.span_id, 0) if span is not None else 0
        if ran == 0 or span.args["mla_decode_layers"] != n_layers * ran:
            continue
        n = len(r.out.token_ids)
        need += sum(step_bytes(c, cfg, r.out.prompt_len + j)
                    for j in range(1, n)) / run.peaks["hbm_bytes_per_s"]
        took += r.out.decode_s
    return 100.0 * need / took if took > 0 and need > 0 else None
