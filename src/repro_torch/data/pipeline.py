"""Deterministic data pipeline (the JAX package's ``data/pipeline.py``:
``DataCursor``, ``lm_batch``, ``recsys_batch``, ``gnn_graph``; numpy, no
device).

Every batch is a function of (seed, step, stream).  The stream enters
the seed through Python's ``hash(stream)``, which is salted per process
unless ``PYTHONHASHSEED`` is fixed: within one process the port's
batches equal the JAX package's, but two processes give different
batches for one (seed, step).  The formula is the reference's, kept
for parity (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataCursor:
    """The only mutable pipeline state; checkpointed as one int."""

    seed: int
    step: int = 0

    def advance(self) -> int:
        s = self.step
        self.step += 1
        return s


def _rng(seed: int, step: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, hash(stream) & 0x7FFFFFFF])
    )


def lm_batch(cursor: DataCursor, batch: int, seq: int, vocab: int):
    """Synthetic LM tokens with local n-gram structure: (tokens,
    targets), each int32 [batch, seq]."""
    step = cursor.advance()
    rng = _rng(cursor.seed, step, "lm")
    # Markov-ish stream: next token = (prev * 31 + noise) % vocab
    start = rng.integers(0, vocab, size=(batch, 1))
    noise = rng.integers(0, 17, size=(batch, seq))
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, 0] = start[:, 0]
    for t in range(1, seq + 1):
        toks[:, t] = (toks[:, t - 1] * 31 + noise[:, min(t - 1, seq - 1)]) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def recsys_batch(cursor: DataCursor, batch: int, vocab_sizes, n_dense: int):
    """(dense f32 [batch, n_dense] or None, sparse int32 [batch, F],
    labels f32 [batch])."""
    step = cursor.advance()
    rng = _rng(cursor.seed, step, "recsys")
    sparse = np.stack(
        [rng.integers(0, v, size=batch) for v in vocab_sizes], axis=1
    ).astype(np.int32)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32) \
        if n_dense else None
    # click label correlated with field 0 parity (learnable signal)
    logit = (sparse[:, 0] % 2) * 2.0 - 1.0 + rng.normal(size=batch)
    labels = (logit > 0).astype(np.float32)
    return dense, sparse, labels


def gnn_graph(cursor: DataCursor, n_nodes: int, n_edges: int, d_feat: int,
              n_graphs: int = 1):
    """A random graph: node features and positions (N(0, 1), positions
    × 3), ``n_edges`` edges with uniform endpoints (with ``n_graphs`` >
    1, ``n_nodes // n_graphs`` nodes and ``n_edges // n_graphs`` edges a
    graph, edges inside their graph, the rest ``(0, 0)``), labels in
    [0, 8) and one energy target a graph, as numpy arrays."""
    step = cursor.advance()
    rng = _rng(cursor.seed, step, "gnn")
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 3.0
    if n_graphs > 1:
        per = n_nodes // n_graphs
        graph_ids = (np.arange(n_nodes) // per).clip(0, n_graphs - 1)
        # edges stay within a graph
        eper = n_edges // n_graphs
        snd, rcv = [], []
        for g in range(n_graphs):
            snd.append(rng.integers(g * per, (g + 1) * per, size=eper))
            rcv.append(rng.integers(g * per, (g + 1) * per, size=eper))
        senders = np.concatenate(snd)
        receivers = np.concatenate(rcv)
        pad = n_edges - len(senders)
        senders = np.concatenate([senders, np.zeros(pad, np.int64)])
        receivers = np.concatenate([receivers, np.zeros(pad, np.int64)])
    else:
        graph_ids = np.zeros(n_nodes, np.int64)
        senders = rng.integers(0, n_nodes, size=n_edges)
        receivers = rng.integers(0, n_nodes, size=n_edges)
    labels = rng.integers(0, 8, size=n_nodes)
    energy = rng.normal(size=n_graphs).astype(np.float32)
    return {
        "node_feats": feats, "positions": pos,
        "senders": senders.astype(np.int32),
        "receivers": receivers.astype(np.int32),
        "graph_ids": graph_ids.astype(np.int32),
        "labels": labels.astype(np.int32),
        "energy_targets": energy,
    }
