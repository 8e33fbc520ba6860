"""Plain reference of DeepSeek-V2 (arXiv:2405.04434; hf:deepseek-ai/
DeepSeek-V2-Lite ``modeling_deepseek.py``) as its configuration file
states it: pre-norm RMSNorm decoder; Multi-head Latent Attention with
uncompressed queries (``q_lora_rank`` null), a compressed KV latent of
``kv_lora_rank`` normalized by its own RMSNorm, a decoupled RoPE key of
``qk_rope_head_dim`` shared by all heads, per-head keys and values
up-projected from the latent, softmax scale (nope + rope)^-1/2; the
first ``first_k_dense_replace`` layers a dense SwiGLU MLP, the rest a
softmax-routed mixture of ``n_routed_experts`` SwiGLU experts (greedy
top ``num_experts_per_tok``, gates not renormalized where
``norm_topk_prob`` is false, times ``routed_scaling_factor``) plus
``n_shared_experts`` shared experts as one SwiGLU of their summed
width; untied output head.  Keys and values are computed in full from
the latent (no absorption).  RoPE as the file's ``rope_scaling``
states it: null for plain RoPE at ``rope_theta``, or YaRN
(arXiv:2309.00071) as ``modeling_deepseek.py`` applies it: inverse
frequencies blended between ``rope_theta``'s and theirs over
``factor`` by a linear ramp between the correction dimensions of
``beta_fast`` and ``beta_slow`` rotations in
``original_max_position_embeddings``, cos and sin times
mscale(factor, ``mscale``) / mscale(factor, ``mscale_all_dim``), and the
softmax scale times mscale(factor, ``mscale_all_dim``)^2, with
mscale(s, m) = 0.1 m ln s + 1.
"""
from __future__ import annotations

import math

import torch

from pbkit import lm_ref


def check(cfg: dict) -> None:
    scaling = cfg.get("rope_scaling")
    if scaling is not None and scaling.get("type",
                                           scaling.get("rope_type")) != "yarn":
        raise ValueError(f"the reference does not implement {scaling}")
    want = {"q_lora_rank": None,
            "scoring_func": "softmax", "topk_method": "greedy",
            "hidden_act": "silu", "attention_bias": False,
            "moe_layer_freq": 1, "n_group": 1, "topk_group": 1}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"the reference does not implement {bad}")


def weight_specs(cfg: dict) -> list[tuple]:
    check(cfg)
    d, h, v = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    n, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    nm = n - nd
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs, fd = f * cfg["n_shared_experts"], cfg["intermediate_size"]
    bf = cfg["torch_dtype"]
    return [
        ("embed", (v, d), bf, 1.0),
        ("lm_head", (d, v), bf, d ** -0.5),
        ("final_norm", (d,), "float32", "gamma"),
        ("ln1", (n, d), "float32", "gamma"),
        ("ln2", (n, d), "float32", "gamma"),
        ("w_q", (n, d, h * (nope + rp)), bf, d ** -0.5),
        ("w_dkv", (n, d, r), bf, d ** -0.5),
        ("w_kr", (n, d, rp), bf, d ** -0.5),
        ("kv_norm", (n, r), "float32", "gamma"),
        ("w_uk", (n, r, h * nope), bf, r ** -0.5),
        ("w_uv", (n, r, h * dv), bf, r ** -0.5),
        ("w_o", (n, h * dv, d), bf, (h * dv) ** -0.5),
        ("dense.w_gate", (nd, d, fd), bf, d ** -0.5),
        ("dense.w_up", (nd, d, fd), bf, d ** -0.5),
        ("dense.w_down", (nd, fd, d), bf, fd ** -0.5),
        ("router", (nm, d, e), "float32", d ** -0.5),
        ("experts.w_gate", (nm, e, d, f), bf, d ** -0.5),
        ("experts.w_up", (nm, e, d, f), bf, d ** -0.5),
        ("experts.w_down", (nm, e, f, d), bf, f ** -0.5),
        ("shared.w_gate", (nm, d, fs), bf, d ** -0.5),
        ("shared.w_up", (nm, d, fs), bf, d ** -0.5),
        ("shared.w_down", (nm, fs, d), bf, fs ** -0.5),
    ]


def counts(cfg: dict) -> dict:
    """What ``pbkit/counting.py`` needs of this architecture.  MLA's
    attention is counted in its plain form: per-head keys and values of
    (nope + rope) and v widths, as the flash kernel is given them."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    attn = (d * h * (nope + rp) + d * (r + rp) + r * h * (nope + dv)
            + h * dv * d)
    f = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"]
           + 3 * d * f * (cfg["num_experts_per_tok"]
                          + cfg["n_shared_experts"]))
    dense = 3 * d * cfg["intermediate_size"]
    nd = cfg["first_k_dense_replace"]
    return {"layer_params": [attn + (dense if i < nd else moe)
                             for i in range(cfg["num_hidden_layers"])],
            "hq": h, "hkv": h, "dqk": nope + rp, "dv": dv,
            "d_model": d, "vocab": cfg["vocab_size"]}


def _yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg: dict) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies [rope/2] in float64, the factor on cos and
    sin, the factor on the softmax scale) that ``rope_scaling`` gives."""
    rp, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    half = rp // 2
    extra = base ** (-torch.arange(half, dtype=torch.float64) / half)
    ys = cfg.get("rope_scaling")
    if ys is None:
        return extra, 1.0, 1.0
    factor, orig = float(ys["factor"]), ys["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (rp * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(ys.get("beta_fast", 32))), 0)
    high = min(math.ceil(correction_dim(ys.get("beta_slow", 1))), rp - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv = extra / factor * ramp + extra * (1 - ramp)
    all_dim = ys.get("mscale_all_dim", 0)
    cos_sin = (_yarn_mscale(factor, ys.get("mscale", 1))
               / _yarn_mscale(factor, all_dim))
    softmax = _yarn_mscale(factor, all_dim) ** 2 if all_dim else 1.0
    return inv, cos_sin, softmax


def logits(weights: dict, cfg: dict, seqs, wanted, fp8: bool = False):
    h = cfg["num_attention_heads"]
    nope, rp = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    nd = cfg["first_k_dense_replace"]
    eps, base = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    inv, cos_sin, softmax = rope_tables(cfg)
    scale = (nope + rp) ** -0.5 * softmax
    W = weights

    def rope(x, pos):
        return lm_ref.rope(x, pos, base, inv) * cos_sin

    def attention(lin, i, x, pos):
        n = x.shape[0]
        q = lin(x, W["w_q"][i]).view(n, h, nope + rp)
        c = lm_ref.rms_norm(lin(x, W["w_dkv"][i]), W["kv_norm"][i], eps)
        k_pe = rope(lin(x, W["w_kr"][i])[:, None, :], pos)
        k = torch.cat([lin(c, W["w_uk"][i]).view(n, h, nope),
                       k_pe.expand(n, h, rp)], dim=-1)
        v = lin(c, W["w_uv"][i]).view(n, h, dv)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos)],
                      dim=-1)
        o = lm_ref.causal_attention(q, k, v, scale)
        return lin(o.reshape(n, h * dv), W["w_o"][i])

    def mlp(lin, i, x):
        if i < nd:
            return lm_ref.swiglu(lin, x, W["dense.w_gate"][i],
                                 W["dense.w_up"][i], W["dense.w_down"][i])
        j = i - nd
        routed = lm_ref.moe(
            lin, x, W["router"][j], W["experts.w_gate"][j],
            W["experts.w_up"][j], W["experts.w_down"][j],
            cfg["num_experts_per_tok"], cfg["norm_topk_prob"],
            cfg["routed_scaling_factor"])
        return routed + lm_ref.swiglu(lin, x, W["shared.w_gate"][j],
                                      W["shared.w_up"][j],
                                      W["shared.w_down"][j])

    return lm_ref.run(seqs, wanted, W, cfg["num_hidden_layers"], attention,
                      mlp, eps, fp8=fp8)
