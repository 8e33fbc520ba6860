"""gemma2-9b [arXiv:2408.00118].

42L, d_model 3584, 16 q heads (GQA kv=8), head_dim 256, d_ff 14336,
vocab 256000.  Local (window 4096) / global alternating; attention
logit softcap 50, final logit softcap 30; sandwich norms; tied embeds.
The same values as the JAX package's ``configs/gemma2_9b.py``.
"""
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    rope_base=10_000.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    query_scale=256 ** -0.5,
)

SMOKE = LMConfig(
    name="gemma2-smoke",
    n_layers=5,  # 2 units + 1 tail layer
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("local", "global"),
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    rope_base=10_000.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    query_scale=16 ** -0.5,
    dtype="float32",
)
