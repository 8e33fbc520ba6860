"""Deterministic word tokenizer + normalization (paper §4.1 substrate).

The paper's vectorizer is a classic TF-IDF pipeline: lowercase, split on
non-alphanumeric runs.  We keep that exact semantic so the HSF scores are
reproducible and the substring-boost normalization (``lowercase(Q) ⊆
lowercase(D)``) shares the same canonical form.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from repro_torch.core import hashing

_TOKEN_RE = re.compile(r"[a-z0-9_]+")


def normalize(text: str) -> str:
    """Paper's canonical form: casefolded text (used for both the
    vectorizer and the substring indicator)."""
    return text.lower()


def tokenize(text: str) -> list[str]:
    """Lowercase word tokens (alnum + underscore runs)."""
    return _TOKEN_RE.findall(normalize(text))


@dataclass(frozen=True)
class TermCounts:
    """Per-document term statistics: unique hashed terms and raw counts.

    This is the ⟨V⟩-region precursor stored in the knowledge container —
    keeping *counts* (not weights) is what makes incremental IDF refresh
    possible without re-tokenizing unchanged documents (paper §3.3).
    """

    term_hashes: np.ndarray  # uint64 [T_unique]
    counts: np.ndarray  # int32  [T_unique]
    n_tokens: int

    @staticmethod
    def from_text(text: str) -> "TermCounts":
        tokens = tokenize(text)
        if not tokens:
            return TermCounts(
                np.zeros((0,), np.uint64), np.zeros((0,), np.int32), 0
            )
        hashes = hashing.hash_tokens(tokens)
        uniq, counts = np.unique(hashes, return_counts=True)
        return TermCounts(uniq, counts.astype(np.int32), len(tokens))
