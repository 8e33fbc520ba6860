"""Plain reference of Qwen3-MoE (hf:Qwen/Qwen3-30B-A3B
``modeling_qwen3_moe.py``) as its configuration file states it:
pre-norm RMSNorm decoder; grouped-query attention with
``num_key_value_heads`` kv heads of ``head_dim``, a per-head RMSNorm of
queries and keys before RoPE (``rope_theta``), softmax scale
head_dim^-1/2; every layer (``decoder_sparse_step`` 1, no
``mlp_only_layers``) a softmax-routed mixture of ``num_experts`` SwiGLU
experts of ``moe_intermediate_size``, top ``num_experts_per_tok``,
gates renormalized where ``norm_topk_prob``; untied output head; no
sliding window, no RoPE scaling."""
from __future__ import annotations

from pbkit import lm_ref


def check(cfg: dict) -> None:
    want = {"rope_scaling": None, "decoder_sparse_step": 1,
            "mlp_only_layers": [], "use_sliding_window": False,
            "hidden_act": "silu", "attention_bias": False}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"the reference does not implement {bad}")


def weight_specs(cfg: dict) -> list[tuple]:
    check(cfg)
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    n, e, f = (cfg["num_hidden_layers"], cfg["num_experts"],
               cfg["moe_intermediate_size"])
    bf = cfg["torch_dtype"]
    return [
        ("embed", (v, d), bf, 1.0),
        ("lm_head", (d, v), bf, d ** -0.5),
        ("final_norm", (d,), "float32", "gamma"),
        ("ln1", (n, d), "float32", "gamma"),
        ("ln2", (n, d), "float32", "gamma"),
        ("w_q", (n, d, h * hd), bf, d ** -0.5),
        ("w_k", (n, d, hk * hd), bf, d ** -0.5),
        ("w_v", (n, d, hk * hd), bf, d ** -0.5),
        ("w_o", (n, h * hd, d), bf, (h * hd) ** -0.5),
        ("q_norm", (n, hd), "float32", "gamma"),
        ("k_norm", (n, hd), "float32", "gamma"),
        ("router", (n, d, e), "float32", d ** -0.5),
        ("experts.w_gate", (n, e, d, f), bf, d ** -0.5),
        ("experts.w_up", (n, e, d, f), bf, d ** -0.5),
        ("experts.w_down", (n, e, f, d), bf, f ** -0.5),
    ]


def counts(cfg: dict) -> dict:
    """What ``pbkit/counting.py`` needs of this architecture."""
    d = cfg["hidden_size"]
    h, hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    attn = d * (h + 2 * hk) * hd + h * hd * d
    moe = (d * cfg["num_experts"]
           + 3 * d * cfg["moe_intermediate_size"] * cfg["num_experts_per_tok"])
    return {"layer_params": [attn + moe] * cfg["num_hidden_layers"],
            "hq": h, "hkv": hk, "dqk": hd, "dv": hd,
            "d_model": d, "vocab": cfg["vocab_size"]}


def logits(weights: dict, cfg: dict, seqs, wanted, fp8: bool = False):
    h, hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps, base = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    W = weights

    def attention(lin, i, x, pos):
        n = x.shape[0]
        q = lm_ref.rms_norm(lin(x, W["w_q"][i]).view(n, h, hd),
                            W["q_norm"][i], eps)
        k = lm_ref.rms_norm(lin(x, W["w_k"][i]).view(n, hk, hd),
                            W["k_norm"][i], eps)
        v = lin(x, W["w_v"][i]).view(n, hk, hd)
        o = lm_ref.causal_attention(lm_ref.rope(q, pos, base),
                                    lm_ref.rope(k, pos, base), v, hd ** -0.5)
        return lin(o.reshape(n, h * hd), W["w_o"][i])

    def mlp(lin, i, x):
        return lm_ref.moe(lin, x, W["router"][i], W["experts.w_gate"][i],
                          W["experts.w_up"][i], W["experts.w_down"][i],
                          cfg["num_experts_per_tok"], cfg["norm_topk_prob"],
                          1.0)

    return lm_ref.run(seqs, wanted, W, cfg["num_hidden_layers"], attention,
                      mlp, eps, fp8=fp8)

