"""Neighbour sampler for minibatch GNN training (GraphSAGE-style
fanout); the JAX package's ``models/gnn/sampler.py``, numpy on the host.

Deterministic given its ``np.random.Generator``: the same generator
gives the reference's arrays exactly.  Output is a padded, static-shape
subgraph: exactly ``batch_nodes · (1 + f1 + f1·f2)`` node slots and
``batch_nodes · (f1 + f1·f2)`` edge slots, with masks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SampledSubgraph:
    node_ids: np.ndarray  # [n_slots] global ids (padded with 0)
    node_mask: np.ndarray  # [n_slots] bool
    senders: np.ndarray  # [e_slots] local indices
    receivers: np.ndarray  # [e_slots] local indices
    edge_mask: np.ndarray  # [e_slots] bool
    seed_mask: np.ndarray  # [n_slots] bool — loss restricted to seeds


class CSRGraph:
    """Compressed neighbour lists for sampling (host-side numpy)."""

    def __init__(self, n_nodes: int, senders: np.ndarray, receivers: np.ndarray):
        self.n_nodes = n_nodes
        order = np.argsort(receivers, kind="stable")
        self.src_sorted = senders[order].astype(np.int64)
        counts = np.bincount(receivers, minlength=n_nodes)
        self.ptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.ptr[1:])

    def neighbors(self, node: int) -> np.ndarray:
        return self.src_sorted[self.ptr[node]: self.ptr[node + 1]]


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledSubgraph:
    """Multi-hop uniform neighbour sampling, without replacement where
    a node has at least the fanout's neighbours."""
    batch = len(seeds)
    n_slots = batch
    e_slots = 0
    per_layer = [batch]
    for f in fanouts:
        per_layer.append(per_layer[-1] * f)
        n_slots += per_layer[-1]
        e_slots += per_layer[-1]

    node_ids = np.zeros(n_slots, np.int64)
    node_mask = np.zeros(n_slots, bool)
    senders = np.zeros(e_slots, np.int32)
    receivers = np.zeros(e_slots, np.int32)
    edge_mask = np.zeros(e_slots, bool)
    seed_mask = np.zeros(n_slots, bool)

    node_ids[:batch] = seeds
    node_mask[:batch] = True
    seed_mask[:batch] = True

    frontier_start, frontier_len = 0, batch
    node_cursor, edge_cursor = batch, 0
    for f in fanouts:
        layer_nodes = frontier_len * f
        for j in range(frontier_len):
            dst_local = frontier_start + j
            if not node_mask[dst_local]:
                node_cursor += f
                edge_cursor += f
                continue
            neigh = graph.neighbors(int(node_ids[dst_local]))
            if len(neigh) == 0:
                node_cursor += f
                edge_cursor += f
                continue
            take = rng.choice(neigh, size=f, replace=len(neigh) < f)
            sl_n = slice(node_cursor, node_cursor + f)
            sl_e = slice(edge_cursor, edge_cursor + f)
            node_ids[sl_n] = take
            node_mask[sl_n] = True
            senders[sl_e] = np.arange(node_cursor, node_cursor + f)
            receivers[sl_e] = dst_local
            edge_mask[sl_e] = True
            node_cursor += f
            edge_cursor += f
        frontier_start += frontier_len
        frontier_len = layer_nodes

    return SampledSubgraph(node_ids, node_mask, senders.astype(np.int32),
                           receivers.astype(np.int32), edge_mask, seed_mask)
