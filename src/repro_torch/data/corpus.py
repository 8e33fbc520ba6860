"""Synthetic corpus generator — reproduces the paper's §5.1 setup:
mixed business/technical English documents with unique entity codes
injected into known documents, so Recall@1 for entity queries is
ground-truthable.

Fully deterministic from the seed (the benchmark and the tests replay
identical corpora).
"""
from __future__ import annotations

import numpy as np

_BUSINESS = (
    "invoice payment quarterly revenue forecast client contract renewal "
    "procurement supplier ledger audit compliance budget expense margin "
    "stakeholder projection fiscal onboarding churn retention pipeline"
).split()
_TECH = (
    "server deployment kubernetes container latency throughput database "
    "index replication shard failover cache queue endpoint token schema "
    "migration rollback observability metric tracing alert incident"
).split()
_GLUE = "the of for with and to in on a is was were has have".split()


def make_corpus(
    n_docs: int = 1000,
    doc_len: int = 120,
    n_entities: int = 10,
    seed: int = 0,
) -> tuple[list[str], dict[str, int]]:
    """Returns (documents, {entity_code: doc_index}).

    Entity codes follow the paper's pattern (UNIQUE_INVOICE_CODE_XYZ_999)
    and each appears in exactly one document.
    """
    rng = np.random.default_rng(seed)
    vocab = _BUSINESS + _TECH + _GLUE
    docs = []
    for i in range(n_docs):
        words = rng.choice(vocab, size=doc_len)
        docs.append(" ".join(words))

    entities: dict[str, int] = {}
    targets = rng.choice(n_docs, size=n_entities, replace=False)
    for j, doc_idx in enumerate(targets):
        code = f"UNIQUE_INVOICE_CODE_{chr(65 + j % 26)}{chr(88 + j % 3)}_{900 + j}"
        words = docs[doc_idx].split()
        pos = int(rng.integers(0, len(words)))
        words.insert(pos, code)
        docs[doc_idx] = " ".join(words)
        entities[code] = int(doc_idx)
    return docs, entities


def make_topical_corpus(
    n_docs: int = 1000,
    doc_len: int = 120,
    n_topics: int = 32,
    n_entities: int = 10,
    seed: int = 0,
    sharpness: float = 0.85,
) -> tuple[list[str], dict[str, int], list[list[str]]]:
    """Returns (documents, {entity_code: doc_index}, topic_core_words).

    Like ``make_corpus`` but with *topical structure*: each document
    draws ``sharpness`` of its words from one topic's core vocabulary
    (16 words over an extended 512-term vocab) and the rest globally.
    Real document collections cluster by topic; the uniform
    ``make_corpus`` is intentionally structure-free (worst case for any
    cluster-pruned index), so the index-plane benchmarks measure
    QPS-vs-Recall on this generator (benchmarks/bench_index.py) where
    cosine neighborhoods actually concentrate.  Entity codes are
    injected exactly as in ``make_corpus``.  Deterministic from seed.
    """
    rng = np.random.default_rng(seed)
    base = _BUSINESS + _TECH + _GLUE
    vocab = np.array(base + [f"term{i:04d}" for i in range(512 - len(base))])
    cores = [rng.choice(len(vocab), size=16, replace=False)
             for _ in range(n_topics)]
    docs = []
    for i in range(n_docs):
        core = cores[int(rng.integers(n_topics))]
        from_core = rng.random(doc_len) < sharpness
        idx = np.where(
            from_core,
            core[rng.integers(0, len(core), size=doc_len)],
            rng.integers(0, len(vocab), size=doc_len),
        )
        docs.append(" ".join(vocab[idx]))

    entities: dict[str, int] = {}
    targets = rng.choice(n_docs, size=n_entities, replace=False)
    for j, doc_idx in enumerate(targets):
        code = f"UNIQUE_INVOICE_CODE_{chr(65 + j % 26)}{chr(88 + j % 3)}_{900 + j}"
        words = docs[doc_idx].split()
        words.insert(int(rng.integers(0, len(words))), code)
        docs[doc_idx] = " ".join(words)
        entities[code] = int(doc_idx)
    return docs, entities, [list(vocab[c]) for c in cores]


def write_corpus_dir(path: str, docs: list[str]) -> None:
    import os

    os.makedirs(path, exist_ok=True)
    for i, d in enumerate(docs):
        with open(os.path.join(path, f"doc_{i:05d}.txt"), "w") as f:
            f.write(d)
