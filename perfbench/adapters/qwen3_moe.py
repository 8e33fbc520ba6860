"""How the program under test is given a Qwen3-MoE configuration file
and the benchmark's weights: the port's ``LMConfig`` with qk-norm and
MoE, and its parameter tree built from the same tensors (views, no
copy).  The port parameterizes every RMSNorm gain as 1 + w, so it is
given gain - 1."""
from __future__ import annotations

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def program_config(cfg: dict) -> LMConfig:
    if cfg["rms_norm_eps"] != 1e-6:
        raise ValueError("the port's RMSNorm takes eps 1e-6 only")
    return LMConfig(
        name=cfg["name"],
        n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"],
        d_ff=cfg["moe_intermediate_size"],
        vocab=cfg["vocab_size"],
        qk_norm=True,
        rope_base=float(cfg["rope_theta"]),
        activation="silu",
        tie_embeddings=cfg["tie_word_embeddings"],
        moe=MoEConfig(n_experts=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["moe_intermediate_size"],
                      norm_topk=cfg["norm_topk_prob"]),
        dtype=cfg["torch_dtype"],
    )


def program_tree(w: dict, cfg: dict) -> dict:
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        attn = {k: w[k][i] for k in ("w_q", "w_k", "w_v", "w_o")}
        attn["q_norm"] = w["q_norm"][i] - 1.0
        attn["k_norm"] = w["k_norm"][i] - 1.0
        mlp = {"router": w["router"][i],
               **{k: w[f"experts.{k}"][i]
                  for k in ("w_gate", "w_up", "w_down")}}
        layers.append({"ln1": w["ln1"][i] - 1.0, "ln2": w["ln2"][i] - 1.0,
                       "attn": attn, "mlp": mlp})
    return {"embed": w["embed"], "lm_head": w["lm_head"],
            "final_norm": w["final_norm"] - 1.0, "layers": layers}
