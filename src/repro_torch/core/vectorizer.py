"""Hashed sublinear TF-IDF vectorizer (paper §4.1, TPU-adapted).

Paper formulas (kept exactly):

    tf(t, d)  = 1 + ln f_{t,d}
    idf(t)    = ln(N / (1 + df_t)) + 1
    v_d       = l2_normalize( [tf·idf]_t )

Adaptation (docs/ARCHITECTURE.md §2): the paper stores vocabulary-dimensional sparse
vectors; a TPU MXU wants dense, bounded-width operands.  We apply *signed
feature hashing* (hashing trick): term t → bucket ``h(t) mod D`` with sign
``±1`` from a decorrelated hash bit.  Cosine similarity is preserved in
expectation; D is a build-time constant (multiple of 128 → lane-aligned).

Document frequency is maintained *per bucket* and updated incrementally
(`add_doc` / `remove_doc`), which is what keeps re-indexing O(U) in the
number of updated documents (paper §3.3): unchanged documents keep their
stored `TermCounts`; only the cheap re-weighting pass is global.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.tokenizer import TermCounts, tokenize

DEFAULT_DIM = 4096


def bucket_sign(term_hashes: np.ndarray, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Signed feature hashing: bucket = h mod D, sign = ±1 from mixed bit."""
    h = term_hashes.astype(np.uint64)
    buckets = (h % np.uint64(dim)).astype(np.int32)
    signs = np.where(
        (hashing.mix64(h) >> np.uint64(63)).astype(np.int8) == 1, -1, 1
    ).astype(np.int8)
    return buckets, signs


@dataclass
class HashedTfIdf:
    """Stateful hashed TF-IDF model.  State = (dim, n_docs, df[dim])."""

    dim: int = DEFAULT_DIM
    n_docs: int = 0
    df: np.ndarray = field(default=None)  # int64 [dim]

    def __post_init__(self):
        if self.df is None:
            self.df = np.zeros((self.dim,), dtype=np.int64)
        assert self.dim % 128 == 0, "hashed dim must be lane-aligned (×128)"

    # ---- incremental df maintenance (O(U) ingestion path) -------------

    def _doc_buckets(self, tc: TermCounts) -> np.ndarray:
        buckets, _ = bucket_sign(tc.term_hashes, self.dim)
        return np.unique(buckets)

    def add_doc(self, tc: TermCounts) -> None:
        self.df[self._doc_buckets(tc)] += 1
        self.n_docs += 1

    def remove_doc(self, tc: TermCounts) -> None:
        self.df[self._doc_buckets(tc)] -= 1
        self.n_docs -= 1

    # ---- weighting -----------------------------------------------------

    def idf(self) -> np.ndarray:
        """idf(t) = ln(N / (1 + df)) + 1  (float32 [dim])."""
        n = max(self.n_docs, 1)
        return (np.log(n / (1.0 + self.df.astype(np.float64))) + 1.0).astype(
            np.float32
        )

    # ---- factored materialization: U (per-doc) × idf (global) ----------
    #
    # The weighted row of a document factors as
    #     v_d = normalize( u_d ⊙ idf ),   u_d[b] = Σ_{t: h(t)=b} tf(t)·sign(t)
    # where u_d depends ONLY on the document and idf ONLY on global df.
    # That split is what makes query-plane refresh O(U): unchanged docs
    # keep their cached u_d rows and only the cheap elementwise
    # reweight + renormalize pass is global (core/engine.py).  The sign
    # multiply is exact (±1), so the factored form is deterministic.

    def unweighted_row(self, tc: TermCounts) -> np.ndarray:
        """tf·sign scatter of one document — no idf, no normalization.

        Bit-identical to the corresponding row of
        ``build_unweighted_matrix`` (same scatter-add order), which is
        what lets the incremental engine patch single rows.
        """
        v = np.zeros((self.dim,), dtype=np.float32)
        if tc.term_hashes.size:
            buckets, signs = bucket_sign(tc.term_hashes, self.dim)
            tf = 1.0 + np.log(tc.counts.astype(np.float32))
            np.add.at(v, buckets, tf * signs.astype(np.float32))
        return v

    def build_unweighted_matrix(self, term_counts: list[TermCounts]) -> np.ndarray:
        """Batch tf·sign scatter, float32 [n, dim].

        One concatenated host scatter-add (``np.add.at``) instead of a
        per-doc loop — the same bag-accumulation dataflow as the recsys
        EmbeddingBag, but no kernel runs here.
        """
        n = len(term_counts)
        out = np.zeros((n, self.dim), dtype=np.float32)
        if n == 0:
            return out
        rows, cols, vals = [], [], []
        for i, tc in enumerate(term_counts):
            if tc.term_hashes.size == 0:
                continue
            buckets, signs = bucket_sign(tc.term_hashes, self.dim)
            tf = 1.0 + np.log(tc.counts.astype(np.float32))
            rows.append(np.full(buckets.shape, i, dtype=np.int64))
            cols.append(buckets.astype(np.int64))
            vals.append(tf * signs.astype(np.float32))
        if rows:
            flat = np.concatenate(rows) * self.dim + np.concatenate(cols)
            np.add.at(out.reshape(-1), flat, np.concatenate(vals))
        return out

    def finalize_matrix(self, unweighted: np.ndarray,
                        idf: np.ndarray | None = None) -> np.ndarray:
        """idf reweight + row ℓ2-normalize (the cheap global stage).

        ``idf`` defaults to the live statistics; pass a snapshot to
        reproduce vectors against archived df state.
        """
        if idf is None:
            idf = self.idf()
        out = unweighted * idf[None, :]
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        return out

    def doc_vector(self, tc: TermCounts, idf: np.ndarray | None = None) -> np.ndarray:
        """Dense ℓ2-normalized doc vector (float32 [dim])."""
        return self.finalize_matrix(self.unweighted_row(tc)[None, :], idf)[0]

    def build_matrix(self, term_counts: list[TermCounts]) -> np.ndarray:
        """Weighted, normalized doc matrix [n, dim] (cold build)."""
        return self.finalize_matrix(self.build_unweighted_matrix(term_counts))

    def query_vector(self, query: str) -> np.ndarray:
        """Vectorize a query with the *current* idf statistics."""
        return self.doc_vector(TermCounts.from_text(query))

    # ---- (de)serialization for the knowledge container ----------------

    def state(self) -> dict:
        return {"dim": self.dim, "n_docs": self.n_docs}

    @staticmethod
    def from_state(state: dict, df: np.ndarray) -> "HashedTfIdf":
        return HashedTfIdf(dim=int(state["dim"]), n_docs=int(state["n_docs"]), df=df)


def tokenize_query(query: str) -> list[str]:
    return tokenize(query)
