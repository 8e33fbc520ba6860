"""The ⟨I⟩ region proper: an inverted index (term hash → posting list).

Paper §3.1 defines K = ⟨M, C, V, I⟩ with I "an inverted index mapping
vocabulary tokens to document IDs".  The Bloom signatures cover the
substring indicator; this module adds the classic postings structure and
the query paths it unlocks:

- **candidate pre-filtering**: intersect/union postings of the query's
  terms and run HSF only over the candidate set — sub-linear query cost
  when query terms are selective (the common entity-lookup case);
- **exact term lookups** (`docs_with_term`) for the RAG orchestrator.

Storage is CSR-style (sorted unique term hashes + offsets + doc-id
lists), so it serializes as three flat arrays into the container and
merges across shards by concatenation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.tokenizer import TermCounts, tokenize


@dataclass
class PostingsIndex:
    term_hashes: np.ndarray  # uint64 [T] sorted unique
    offsets: np.ndarray  # int64 [T+1]
    doc_ids: np.ndarray  # int32 [total_postings] (local doc indices)

    @staticmethod
    def build(term_counts: list[TermCounts]) -> "PostingsIndex":
        """Build from per-doc unique term hashes (doc index = position)."""
        if not term_counts:
            return PostingsIndex(np.zeros(0, np.uint64),
                                 np.zeros(1, np.int64),
                                 np.zeros(0, np.int32))
        all_terms = np.concatenate([tc.term_hashes for tc in term_counts])
        all_docs = np.concatenate([
            np.full(tc.term_hashes.size, i, np.int32)
            for i, tc in enumerate(term_counts)
        ])
        order = np.lexsort((all_docs, all_terms))
        terms_sorted = all_terms[order]
        docs_sorted = all_docs[order]
        uniq, starts = np.unique(terms_sorted, return_index=True)
        offsets = np.concatenate([starts, [len(terms_sorted)]]).astype(
            np.int64)
        return PostingsIndex(uniq, offsets, docs_sorted)

    # ---- lookups --------------------------------------------------------

    def docs_with_term(self, term: str) -> np.ndarray:
        h = np.uint64(hashing.fnv1a64(term))
        i = np.searchsorted(self.term_hashes, h)
        if i >= len(self.term_hashes) or self.term_hashes[i] != h:
            return np.zeros(0, np.int32)
        return self.doc_ids[self.offsets[i]: self.offsets[i + 1]]

    def candidates(self, query: str, mode: str = "union",
                   max_candidates: int | None = None) -> np.ndarray | None:
        """Docs containing query terms.  ``union`` (recall-safe for HSF
        re-ranking) or ``intersect`` (high precision).  Returns None when
        the query has no indexed terms (caller falls back to full scan).
        """
        terms = tokenize(query)
        if not terms:
            return None
        lists = [self.docs_with_term(t) for t in terms]
        if all(len(l) == 0 for l in lists):
            return np.zeros(0, np.int32)
        if mode == "intersect":
            out = lists[0]
            for l in lists[1:]:
                out = np.intersect1d(out, l, assume_unique=False)
        else:
            out = np.unique(np.concatenate(lists))
        if max_candidates is not None and len(out) > max_candidates:
            return None  # unselective query: full HSF scan is cheaper
        return out.astype(np.int32)

    # ---- container (de)serialization ------------------------------------

    def segments(self) -> dict[str, np.ndarray]:
        return {"post_terms": self.term_hashes, "post_offsets": self.offsets,
                "post_docs": self.doc_ids}

    @staticmethod
    def from_segments(segs: dict) -> "PostingsIndex | None":
        if "post_terms" not in segs:
            return None
        return PostingsIndex(segs["post_terms"], segs["post_offsets"],
                             segs["post_docs"])
