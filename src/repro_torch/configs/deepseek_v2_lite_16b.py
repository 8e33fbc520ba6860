"""deepseek-v2-lite-16b [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

27L, d_model 2048, 16 heads, vocab 102400.  MLA: kv_lora_rank 512,
decoupled RoPE key dim 64, nope 128, v 128 (queries uncompressed in
Lite).  MoE: 64 routed + 2 shared experts, top-6, d_ff(expert) 1408;
layer 0 is a dense MLP with d_ff 10944.  ~15.7 B total / ~2.7 B active.
The same values as the JAX package's ``configs/deepseek_v2_lite_16b.py``
(64 routed experts: the Lite model, not full V2's 160).

``FULL`` mirrors the JAX package's values, plain RoPE at ``rope_base``
included, so that the two packages can be held to each other.  The
published model also scales its RoPE by YaRN (factor 40, mscale and
mscale_all_dim 0.707, beta 32/1 over 4,096 original positions); that
model, ``rope_scaling`` and all, is what the benchmark's configuration
file ``perfbench/configs/rag.deepseek-v2-lite-16b.json`` builds.
"""
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    rope_base=10_000.0,
    activation="silu",
    tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128, q_lora_rank=None),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  norm_topk=False),
    n_dense_head_layers=1,
    dense_d_ff=10944,
)

SMOKE = LMConfig(
    name="deepseek-v2-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab=512,
    rope_base=10_000.0,
    activation="silu",
    tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16, q_lora_rank=None),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                  norm_topk=False),
    n_dense_head_layers=1,
    dense_d_ff=128,
    dtype="float32",
)
