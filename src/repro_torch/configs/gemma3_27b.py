"""gemma3-27b [hf:google/gemma-3-27b-it family; assignment spec].

62L, d_model 5376, 32 q heads (GQA kv=16), head_dim 128, d_ff 21504,
vocab 262144.  5 local (sliding window 1024) : 1 global interleave;
RoPE base 1M global / 10k local; qk-norm; sandwich norms; tied embeds;
query scale (d_model/n_heads)^-1/2 = 168^-1/2.  The same values as the
JAX package's ``configs/gemma3_27b.py``.
"""
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    pattern=("local",) * 5 + ("global",),
    window=1024,
    qk_norm=True,
    post_norms=True,
    rope_base=1_000_000.0,
    rope_base_local=10_000.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    query_scale=(5376 / 32) ** -0.5,
)

SMOKE = LMConfig(
    name="gemma3-smoke",
    n_layers=8,  # 1 full pattern unit + 2 tail layers
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=("local",) * 5 + ("global",),
    window=16,
    qk_norm=True,
    post_norms=True,
    rope_base=1_000_000.0,
    rope_base_local=10_000.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    query_scale=(64 / 4) ** -0.5,
    dtype="float32",
)
