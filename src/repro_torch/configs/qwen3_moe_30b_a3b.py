"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B].

48L, d_model 2048, 32 q heads (GQA kv=4), head_dim 128, vocab 151936.
MoE: 128 routed experts, top-8, d_ff(expert)=768, gate renormalized
(norm_topk_prob), no shared experts.  qk-norm; untied embeddings.
~30.5 B total / ~3.3 B active.  The same values as the JAX package's
``configs/qwen3_moe_30b_a3b.py``.
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    qk_norm=True,
    rope_base=1_000_000.0,
    activation="silu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, norm_topk=True),
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=512,
    qk_norm=True,
    rope_base=1_000_000.0,
    activation="silu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, norm_topk=True),
    dtype="float32",
)
