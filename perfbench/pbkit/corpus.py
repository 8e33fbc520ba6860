"""The corpus a configuration serves: a frozen copy of the program's
topical generator (``repro_torch/data/corpus.make_topical_corpus``),
so that later changes to the program do not move the data.

Mixed business and technical English documents, each drawing
``sharpness`` of its words from one topic's 16 core words over a
512-term vocabulary and the rest from the whole vocabulary, with unique
entity codes injected into known documents (the paper's RQ2 task).
Deterministic from the configuration's corpus seed, as a public data
set is fixed; a run's ``--seed`` never changes it.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

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


def make_topical_corpus(n_docs: int, doc_len: int, n_topics: int,
                        n_entities: int, seed: int, sharpness: float):
    """(documents, {entity_code: doc_index}, topic core words)."""
    rng = np.random.default_rng(seed)
    base = _BUSINESS + _TECH + _GLUE
    vocab = np.array(base + [f"term{i:04d}" for i in range(512 - len(base))])
    cores = [rng.choice(len(vocab), size=16, replace=False)
             for _ in range(n_topics)]
    docs = []
    for _ in range(n_docs):
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
        code = (f"UNIQUE_INVOICE_CODE_{chr(65 + j % 26)}{chr(88 + j % 3)}"
                f"_{900 + j}")
        words = docs[doc_idx].split()
        words.insert(int(rng.integers(0, len(words))), code)
        docs[doc_idx] = " ".join(words)
        entities[code] = int(doc_idx)
    return docs, entities, [list(vocab[c]) for c in cores]


def doc_id(i: int) -> str:
    """Fixed-width ids, so sorting them as strings keeps their order."""
    return f"d{i:07d}"


class Corpus:
    """The generated corpus and what the traffic draws questions from."""

    def __init__(self, texts: list[str], entities: dict[str, int],
                 cores: list[list[str]]):
        self.texts = texts
        self.entities = entities
        self.cores = cores


def corpus_key(spec: dict) -> str:
    """A directory name for one corpus and retrieval plane (what the
    cached container and the reference's arrays depend on)."""
    c, r = spec["corpus"], spec["retrieval"]
    return (f"n{spec['n_docs']}-len{c['doc_len']}-t{c['n_topics']}"
            f"-e{c['n_entities']}-s{c['seed']}-sh{c['sharpness']}"
            f"-dim{r['dim']}-w{r['sig_words']}")


def load_or_make(spec: dict, cache_dir: Path) -> Corpus:
    """The corpus of a configuration, generated once into ``cache_dir``
    and read from there afterwards."""
    path = cache_dir / "corpus.json"
    if path.exists():
        with open(path) as f:
            d = json.load(f)
        return Corpus(d["texts"], d["entities"], d["cores"])
    c = spec["corpus"]
    texts, entities, cores = make_topical_corpus(
        spec["n_docs"], c["doc_len"], c["n_topics"], c["n_entities"],
        c["seed"], c["sharpness"])
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump({"texts": texts, "entities": entities, "cores": cores}, f)
    os.replace(tmp, path)
    return Corpus(texts, entities, cores)
