"""The paper's own architecture: the RAGdb retrieval plane, scaled.

Shapes (the paper runs 1k docs on one laptop; the production configs
shard the corpus over the mesh):

    edge_1k      1,024 docs × 1 device      (the paper's regime)
    pod_16m      16.7M docs × 256 devices   (65,536 docs/device)
    multipod_33m 33.5M docs × 512 devices

The same values as the JAX package's ``configs/ragdb.py``; the sharded
cells that use them are ``launch/steps.build_ragdb_cell``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class RAGdbConfig:
    name: str = "ragdb"
    dim: int = 4096  # hashed TF-IDF dims
    sig_words: int = 128  # bloom signature int32 words
    alpha: float = 1.0
    beta: float = 1.0
    top_k: int = 16
    query_batch: int = 64
    docs_per_device: int = 65536


FULL = RAGdbConfig()
SMOKE = RAGdbConfig(name="ragdb-smoke", dim=512, sig_words=128, top_k=4,
                    query_batch=4, docs_per_device=256)
