"""Operations and bytes that the inputs need, counted from the
published configuration and the true lengths, never from what the
program's kernels do (padding, recomputation, a wasted step).

Model FLOPs of a token: 2 × the non-embedding parameters it passes
through (attention projections, the dense MLP or the router, the top-k
routed and the shared experts), plus causal attention at its true
context; the output head only where a token is generated.  What is
particular to an architecture comes from its reference module's
``counts(cfg)``: ``layer_params`` (active parameters a token passes
through in each layer), ``hq``, ``hkv``, ``dqk``, ``dv`` (query and
key/value heads, q/k and v widths), ``d_model`` and ``vocab``.
"""
from __future__ import annotations

BF16_BYTES = 2
F32_BYTES = 4


def attention_flops(c: dict, n_new: int, context_end: int) -> float:
    """Causal attention of ``n_new`` tokens ending at position
    ``context_end`` (exclusive), all layers: each (query, key) pair it
    needs, q·k and p·v, 2 FLOPs a multiply-add.  A prefill of L tokens
    needs L²/2 pairs a head: MLA at L = 1,941 is 16 · L² · 320 FLOPs a
    layer."""
    if n_new == context_end:
        pairs = context_end * context_end / 2
    else:
        start = context_end - n_new
        pairs = sum(start + j + 1 for j in range(n_new))
    return 2 * pairs * c["hq"] * (c["dqk"] + c["dv"]) * len(c["layer_params"])


def answer_flops(c: dict, prompt_len: int, n_tokens: int) -> float:
    """Model FLOPs of one answer: the prompt's prefill (the first token's
    logits) and the decode steps that generate the other n_tokens - 1
    tokens."""
    per_token = 2 * sum(c["layer_params"])
    head = 2 * c["d_model"] * c["vocab"]
    n_decode = max(n_tokens - 1, 0)
    total = per_token * (prompt_len + n_decode) + head * n_tokens
    total += attention_flops(c, prompt_len, prompt_len)
    for j in range(n_decode):
        total += attention_flops(c, 1, prompt_len + j + 1)
    return float(total)


def flash_bound_s(c: dict, length: int, peaks: dict) -> float:
    """Least time of one layer's causal prefill attention at the true
    ``length``: q, k, v and o each moved once (bf16), or the causal
    FLOPs, whichever takes longer."""
    nbytes = BF16_BYTES * length * (c["hq"] * c["dqk"] + c["hkv"] * c["dqk"]
                                    + c["hkv"] * c["dv"] + c["hq"] * c["dv"])
    flops = length * length * c["hq"] * (c["dqk"] + c["dv"])
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["bfloat16"])


def hsf_bound_s(n_docs: int, dim: int, sig_words: int, queries: float,
                k: int, peaks: dict) -> float:
    """Least time of one fused HSF top-k dispatch over ``queries`` real
    queries: the float32 doc matrix and the signatures read once, the
    queries read and the top k written once, or 2·B·N·D FLOPs at the
    TF32 peak, whichever takes longer."""
    nbytes = (F32_BYTES * n_docs * (dim + sig_words)
              + queries * F32_BYTES * (dim + sig_words)
              + queries * k * (F32_BYTES + 4))
    flops = 2 * queries * n_docs * dim
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["tf32"])
