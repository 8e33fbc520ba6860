"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed 10,
deep MLP 400-400-400, FM interaction.
The same values as the JAX package's ``configs/deepfm.py``.
"""
from repro_torch.models.recsys.base import DEEPFM_VOCABS, RecsysConfig

FULL = RecsysConfig(
    name="deepfm",
    vocab_sizes=DEEPFM_VOCABS,
    embed_dim=10,
    mlp_dims=(400, 400, 400),
    interaction="fm",
)

SMOKE = RecsysConfig(
    name="deepfm-smoke",
    vocab_sizes=(53, 11, 7, 31, 17, 23, 5, 13),
    embed_dim=8,
    mlp_dims=(32, 32),
    interaction="fm",
)
