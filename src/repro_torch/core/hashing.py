"""Deterministic, dependency-free hashing primitives.

Everything in the retrieval plane must be *exactly* reproducible across
hosts, processes and restarts (the paper's determinism guarantee), so we
never use Python's salted ``hash()``.  Two families:

- ``fnv1a64`` / ``fnv1a64_bytes``: scalar FNV-1a for strings (token
  hashing).  Cached — token distributions are Zipfian so the cache hit
  rate is high during ingestion.
- ``rolling_ngram_hashes``: vectorized polynomial rolling hash over the
  byte stream for character n-grams (Bloom signature construction).
  O(len) numpy ops, no per-gram Python loop.
"""
from __future__ import annotations

import functools

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

# Multiplier for the secondary (derived) hash — splitmix64 finalizer constant.
_MIX = np.uint64(0xFF51AFD7ED558CCD)

_U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def fnv1a64_bytes(data: bytes) -> int:
    """FNV-1a 64-bit over raw bytes. Returns a Python int in [0, 2^64)."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@functools.lru_cache(maxsize=1 << 20)
def fnv1a64(token: str) -> int:
    """Cached FNV-1a of a unicode string (utf-8)."""
    return fnv1a64_bytes(token.encode("utf-8"))


def mix64(h: np.ndarray | int):
    """splitmix64-style finalizer; decorrelates derived hashes."""
    if isinstance(h, (int, np.integer)):
        h = int(h)
        h ^= h >> 33
        h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 33
        return h
    h = h.astype(np.uint64)
    h = h ^ (h >> _U64(33))
    h = (h * _MIX) & _MASK64
    h = h ^ (h >> _U64(33))
    return h


def hash_tokens(tokens: list[str]) -> np.ndarray:
    """Vector of FNV-1a hashes, one per token (uint64)."""
    return np.fromiter(
        (fnv1a64(t) for t in tokens), dtype=np.uint64, count=len(tokens)
    )


# Polynomial base for the rolling hash.  Any odd constant works; this is
# the FNV prime for symmetry with the token hash.
_POLY_BASE = 0x100000001B3


def rolling_ngram_hashes(data: bytes, n: int) -> np.ndarray:
    """All char n-gram hashes of ``data``, vectorized.

    h(i) = sum_j data[i+j] * BASE^(n-1-j)  (mod 2^64), then mixed.
    Returns uint64 array of length max(0, len(data) - n + 1).
    """
    if len(data) < n:
        return np.zeros((0,), dtype=np.uint64)
    b = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    with np.errstate(over="ignore"):
        acc = np.zeros(len(data) - n + 1, dtype=np.uint64)
        for j in range(n):
            power = _U64(pow(_POLY_BASE, n - 1 - j, 1 << 64))
            acc = (acc + b[j : j + len(acc)] * power) & _MASK64
    return mix64(acc)
