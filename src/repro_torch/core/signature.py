"""N-gram Bloom signatures — the TPU-native form of the paper's substring
indicator (docs/ARCHITECTURE.md §3).

Paper (§4.2): ``1_substr(Q, D) = 1 if lowercase(Q) ⊆ lowercase(D)``.
A byte-scan is unvectorizable on a TPU VPU, so we encode each document's
character n-gram set into a fixed-width Bloom signature and test
*containment*:

    1_bloom(Q, D) = all((sig(D) & sig(Q)) == sig(Q))

Soundness: if Q is a substring of D then every char n-gram of Q is a char
n-gram of D, so every bit of sig(Q) is set in sig(D) — **no false
negatives**, which preserves the paper's 100 % Recall@1 guarantee for
known entities.  False positives are bounded by signature width; with
W=128 words (4096 bits), k=2 probes and typical doc gram counts (~1e3)
the per-doc FP rate is < (m/4096·k)^k ≈ 1e-1..1e-2 — and a false positive
only *adds* β to an unrelated doc, it never demotes a true match.

Signatures are int32 (TPU-friendly lane type); W is a multiple of 128 so a
(block_docs × W) tile is lane-aligned in VMEM.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import hashing, tokenizer

# Defaults: 4096-bit signatures, 4-byte grams, 2 probes per gram.
DEFAULT_WIDTH_WORDS = 128
DEFAULT_NGRAM = 4
DEFAULT_PROBES = 2

_U64 = np.uint64


def _bit_positions(gram_hashes: np.ndarray, width_words: int, probes: int) -> np.ndarray:
    """Map gram hashes to Bloom bit positions (probes per gram)."""
    nbits = _U64(width_words * 32)
    positions = []
    h = gram_hashes.astype(np.uint64)
    for _ in range(probes):
        positions.append((h % nbits).astype(np.int64))
        h = hashing.mix64(h)
    if not positions:
        return np.zeros((0,), np.int64)
    return np.concatenate(positions)


def signature_of_text(
    text: str,
    width_words: int = DEFAULT_WIDTH_WORDS,
    ngram: int = DEFAULT_NGRAM,
    probes: int = DEFAULT_PROBES,
) -> np.ndarray:
    """Bloom signature (int32 [width_words]) of the canonicalized text."""
    data = tokenizer.normalize(text).encode("utf-8")
    grams = hashing.rolling_ngram_hashes(data, ngram)
    sig = np.zeros((width_words,), dtype=np.uint32)
    if grams.size:
        pos = _bit_positions(grams, width_words, probes)
        words = (pos >> 5).astype(np.int64)
        bits = (pos & 31).astype(np.uint32)
        np.bitwise_or.at(sig, words, np.uint32(1) << bits)
    return sig.view(np.int32)


def batch_signatures(
    texts: list[str],
    width_words: int = DEFAULT_WIDTH_WORDS,
    ngram: int = DEFAULT_NGRAM,
    probes: int = DEFAULT_PROBES,
) -> np.ndarray:
    """Stacked signatures, int32 [n_docs, width_words]."""
    if not texts:
        return np.zeros((0, width_words), dtype=np.int32)
    return np.stack(
        [signature_of_text(t, width_words, ngram, probes) for t in texts]
    )


def contains(doc_sigs: np.ndarray, query_sig: np.ndarray) -> np.ndarray:
    """Vectorized containment test (numpy oracle; the JAX/Pallas versions
    live in hsf.py / kernels/hsf_score).  Returns bool [n_docs]."""
    d = doc_sigs.view(np.uint32)
    q = query_sig.view(np.uint32)
    return np.all((d & q) == q, axis=-1)


def query_signature(
    query: str,
    width_words: int = DEFAULT_WIDTH_WORDS,
    ngram: int = DEFAULT_NGRAM,
    probes: int = DEFAULT_PROBES,
) -> np.ndarray:
    """Signature of a query string.

    Queries shorter than the gram size produce an *empty* signature
    (all-zero), whose containment test is trivially true for every doc —
    i.e. the boost degenerates to a rank-preserving constant.  Documented
    edge case; matches the paper's behaviour of boosting on any exact
    occurrence without ever demoting the true match.
    """
    return signature_of_text(query, width_words, ngram, probes)
