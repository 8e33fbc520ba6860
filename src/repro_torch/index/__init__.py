"""The clustered index plane, in PyTorch (docs/ARCHITECTURE.md §9).

Instead of scanning all N documents per query, the IVF index scores a
[k_clusters, D] centroid matrix, probes the top-``nprobe`` clusters,
and runs the **exact** HSF (cosine + substring boost) over the gathered
candidate rows through the same ``score_batch_arrays`` machinery the
flat paths use — so results within the probed set are bit-identical to
the brute-force scan, and ``guarantee="exact"`` widens the probe set
until the top-k is provably stable (see ivf.py for the bound).

- ``kmeans.py`` — deterministic spherical k-means over the TF-IDF doc
  matrix on its device (k ≈ √N default, empty-cluster reseeding).
- ``ivf.py``    — cluster assignment, probe/rerank search, incremental
  maintenance off the engine's dirty-row log, and the container state
  the persistence plane journals (the JAX package's ``ivf_*`` segments).

- ``sharded.py`` — the cluster plane partitioned over a shard mesh
  (docs/ARCHITECTURE.md §10): per-shard resident blocks on their
  devices, a global host probe, per-shard map-path rerank, stable merge.

Consumed by ``QueryEngine(index="ivf" | "ivf-sharded")``
(core/engine.py); frozen per-generation by the serving snapshots
(serving/snapshot.py).
"""
from repro_torch.index.kmeans import default_n_clusters, spherical_kmeans
from repro_torch.index.ivf import IVFIndex, IVFSearchStats, score_candidate_rows
from repro_torch.index.sharded import (
    ShardedIVFIndex,
    ShardedIVFSearchStats,
    partition_clusters,
)

__all__ = [
    "IVFIndex",
    "IVFSearchStats",
    "ShardedIVFIndex",
    "ShardedIVFSearchStats",
    "default_n_clusters",
    "partition_clusters",
    "score_candidate_rows",
    "spherical_kmeans",
]
