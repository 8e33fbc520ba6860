"""autoint [arXiv:1810.11921]: 39 sparse fields, embed 16,
3 self-attention layers, 2 heads, d_attn 32.
The same values as the JAX package's ``configs/autoint.py``.
"""
from repro_torch.models.recsys.base import DEEPFM_VOCABS, RecsysConfig

FULL = RecsysConfig(
    name="autoint",
    vocab_sizes=DEEPFM_VOCABS,
    embed_dim=16,
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
    interaction="self-attn",
)

SMOKE = RecsysConfig(
    name="autoint-smoke",
    vocab_sizes=(53, 11, 7, 31, 17, 23, 5, 13),
    embed_dim=8,
    n_attn_layers=2,
    n_attn_heads=2,
    d_attn=16,
    interaction="self-attn",
)
