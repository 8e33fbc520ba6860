"""Small configurations for running the harness on the CPU: the port's
SMOKE sizes of the two architectures and of the retrieval plane, as
files in a benchmark directory of their own (what the CPU tests run)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

RETRIEVAL = {"dim": 512, "sig_words": 128, "alpha": 1.0, "beta": 1.0,
             "top_k": 4, "query_batch": 4}
CORPUS = {"generator": "topical", "doc_len": 40, "n_topics": 8,
          "n_entities": 32, "seed": 7, "sharpness": 0.85}
SERVING = {"index": "flat", "scoring_path": "kernel",
           "flush_deadline_ms": 2.0, "max_batch": 4,
           "max_context_tokens": 256}

DEEPSEEK = {
    "model_type": "deepseek_v2", "attention_bias": False,
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 64,
    "intermediate_size": 128, "kv_lora_rank": 32,
    "max_position_embeddings": 4096, "moe_intermediate_size": 32,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 8,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 4, "num_experts_per_tok": 2,
    "num_hidden_layers": 3, "num_key_value_heads": 4, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "rms_norm_eps": 1e-06,
    "rope_scaling": None, "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 16,
    "vocab_size": 512, "torch_dtype": "bfloat16"}
QWEN = {
    "model_type": "qwen3_moe", "attention_bias": False,
    "decoder_sparse_step": 1, "head_dim": 16, "hidden_act": "silu",
    "hidden_size": 64, "mlp_only_layers": [], "moe_intermediate_size": 32,
    "norm_topk_prob": True, "num_attention_heads": 4, "num_experts": 8,
    "num_experts_per_tok": 2, "num_hidden_layers": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-06, "rope_scaling": None,
    "rope_theta": 1000000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_sliding_window": False,
    "vocab_size": 512}

# Limits at these sizes, set from readings over 12 seeds a cell on the
# CPU (12 program seeds, 3 control seeds): retrieval_gap program
# ≤ 1.4e-7, its TF32 control ≥ 1.9e-4; the widest logit gap of the
# bf16 program reaches 0.82 at this size (a routing flip among 8 experts
# moves a token's logits by tenths), as far as the fp8 control's, so
# here the retrieval number is the one the control fails.
LIMITS = {"retrieval_gap": 1e-5, "boost_mismatch": 0, "prompt_mismatch": 0,
          "logit_gap": 1.5}


def bench_dir(dst: Path, src: Path) -> Path:
    """A benchmark directory at ``dst``: ``src``'s code and files, the
    small configurations and cells beside them, and a ``BENCHMARK.json``
    naming them (returned)."""
    shutil.copytree(src, dst / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    root = dst
    pb = root / "perfbench"
    configs, cells = [], []
    for name, arch in (("smoke.deepseek", DEEPSEEK), ("smoke.qwen", QWEN)):
        cfg = dict(arch, name=name, n_docs=256, retrieval=RETRIEVAL,
                   corpus=CORPUS, serving=SERVING)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "SMOKE",
                        "file": f"perfbench/configs/{name}.json",
                        "reduced": [], "why": "CPU test size"})
        for traffic, users, tokens in (("smoke_1u", 1, 4),
                                       ("smoke_4u", 4, 6)):
            (pb / "traffic" / f"{traffic}.json").write_text(json.dumps({
                "loop": "closed", "users": users, "max_new_tokens": tokens,
                "lookup_share": 0.5, "topical_words": [3, 8],
                "check_tokens": 64}))
            cell = f"{name}.{traffic}"
            (pb / "workloads" / f"{cell}.json").write_text(
                json.dumps({"limits": LIMITS}))
            cells.append({"name": cell, "config": name, "traffic": traffic,
                          "chips": 1, "why": "CPU test"})
    bench = json.loads((src.parent / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = configs, cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    out = root / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return out
