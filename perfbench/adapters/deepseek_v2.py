"""How the program under test is given a DeepSeek-V2 configuration file
and the benchmark's weights: the port's ``LMConfig`` with MLA and MoE,
and its parameter tree built from the same tensors (views, no copy).
The port parameterizes every RMSNorm gain as 1 + w, so it is given
gain - 1.

Every key the reference reads reaches the program.  ``rope_scaling``
(when not null) and ``routed_scaling_factor`` (when not 1) are passed
under their published names, so a file that states the identity builds
the ``LMConfig`` it always did, and one that states what the program
lacks stops at construction with a ``TypeError`` naming the key."""
from __future__ import annotations

from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def program_config(cfg: dict) -> LMConfig:
    if cfg["rms_norm_eps"] != 1e-6:
        raise ValueError("the port's RMSNorm takes eps 1e-6 only")
    rope = {}
    if cfg.get("rope_scaling") is not None:
        rope["rope_scaling"] = dict(cfg["rope_scaling"])
    routed = {}
    if cfg["routed_scaling_factor"] != 1:
        routed["routed_scaling_factor"] = cfg["routed_scaling_factor"]
    return LMConfig(
        name=cfg["name"],
        n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["v_head_dim"],
        d_ff=cfg["moe_intermediate_size"],
        vocab=cfg["vocab_size"],
        rope_base=float(cfg["rope_theta"]),
        activation="silu",
        tie_embeddings=cfg["tie_word_embeddings"],
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      rope_head_dim=cfg["qk_rope_head_dim"],
                      nope_head_dim=cfg["qk_nope_head_dim"],
                      v_head_dim=cfg["v_head_dim"],
                      q_lora_rank=cfg["q_lora_rank"]),
        moe=MoEConfig(n_experts=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["moe_intermediate_size"],
                      n_shared=cfg["n_shared_experts"],
                      norm_topk=cfg["norm_topk_prob"], **routed),
        n_dense_head_layers=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        dtype=cfg["torch_dtype"],
        **rope,
    )


def program_tree(w: dict, cfg: dict) -> dict:
    nd = cfg["first_k_dense_replace"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        attn = {"w_q": w["w_q"][i], "w_dkv": w["w_dkv"][i],
                "w_kr": w["w_kr"][i], "kv_norm": w["kv_norm"][i] - 1.0,
                "w_uk": w["w_uk"][i], "w_uv": w["w_uv"][i],
                "w_o": w["w_o"][i]}
        if i < nd:
            mlp = {k: w[f"dense.{k}"][i]
                   for k in ("w_gate", "w_up", "w_down")}
        else:
            j = i - nd
            mlp = {"router": w["router"][j],
                   **{k: w[f"experts.{k}"][j]
                      for k in ("w_gate", "w_up", "w_down")},
                   "shared": {k: w[f"shared.{k}"][j]
                              for k in ("w_gate", "w_up", "w_down")}}
        layers.append({"ln1": w["ln1"][i] - 1.0, "ln2": w["ln2"][i] - 1.0,
                       "attn": attn, "mlp": mlp})
    return {"embed": w["embed"], "lm_head": w["lm_head"],
            "final_norm": w["final_norm"] - 1.0, "layers": layers}
