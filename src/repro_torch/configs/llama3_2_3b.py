"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B family; assignment spec].

28L, d_model 3072, 24 q heads (GQA kv=8), head_dim 128, d_ff 8192,
vocab 128256.  Full causal attention, RoPE base 500k, SwiGLU, tied.
The same values as the JAX package's ``configs/llama3_2_3b.py``.
"""
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_base=500_000.0,
    activation="silu",
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="llama3.2-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    rope_base=500_000.0,
    activation="silu",
    tie_embeddings=True,
    dtype="float32",
)
