"""dlrm-mlperf [arXiv:1906.00091; MLPerf DLRM benchmark, Criteo 1TB]:
13 dense, 26 sparse, embed 128, bottom 13-512-256-128,
top 1024-1024-512-256-1, dot interaction.
The same values as the JAX package's ``configs/dlrm_mlperf.py``.
"""
from repro_torch.models.recsys.base import CRITEO_VOCABS, RecsysConfig

FULL = RecsysConfig(
    name="dlrm-mlperf",
    vocab_sizes=CRITEO_VOCABS,
    embed_dim=128,
    n_dense=13,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
)

SMOKE = RecsysConfig(
    name="dlrm-mlperf-smoke",
    vocab_sizes=(97, 41, 13, 7, 29, 3) * 2,
    embed_dim=32,
    n_dense=13,
    bot_mlp=(64, 32),
    top_mlp=(64, 32, 1),
    interaction="dot",
)
