"""dlrm-rm2 [arXiv:1906.00091; Park et al. RM2 class]:
13 dense, 26 sparse (Criteo vocabs), embed 64,
bottom 13-512-256-64, top 512-512-256-1, dot interaction.
The same values as the JAX package's ``configs/dlrm_rm2.py``.
"""
from repro_torch.models.recsys.base import CRITEO_VOCABS, RecsysConfig

FULL = RecsysConfig(
    name="dlrm-rm2",
    vocab_sizes=CRITEO_VOCABS,
    embed_dim=64,
    n_dense=13,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
)

SMOKE = RecsysConfig(
    name="dlrm-rm2-smoke",
    vocab_sizes=(97, 41, 13, 7, 29, 3) * 2,  # 12 tiny tables
    embed_dim=16,
    n_dense=13,
    bot_mlp=(32, 16),
    top_mlp=(32, 16, 1),
    interaction="dot",
)
