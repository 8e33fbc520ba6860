"""Single-query retrieval wrapper and the oracle of the sharded path
(PyTorch port of the JAX package's ``core/retrieval.py``).

Sharding design (docs/ARCHITECTURE.md §4): documents are
range-partitioned over the devices; per query each device computes its
local HSF scores and local top-k, and a global top-k merge of the
gathered (k vals, k ids) pairs follows — an O(k · n_shards) payload,
independent of corpus size.  Ties are broken by document index (lower
wins) so the sharded result equals the single-device one exactly.  The
multi-device plane itself (``build_sharded_retrieve``) comes with the
multi-device slice of the port and raises until then; its oracle
``single_device_reference`` and helper ``pad_corpus`` are here.

The single-process ``Retriever`` is a thin wrapper over the batched
``QueryEngine`` (core/engine.py) — the serving-time entry point with
incremental materialization and a query cache.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import hsf
from repro_torch.core.engine import QueryEngine, RetrievalResult  # noqa: F401 — re-export
from repro_torch.core.ingest import KnowledgeBase


# --------------------------------------------------------------------------
# tie-stable scoring helper
# --------------------------------------------------------------------------

def _stable_top_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k by (score desc, id asc): deterministic under score ties.

    Exact lexicographic order (no epsilon arithmetic): a stable sort by
    id, then a stable descending sort by score, so equal scores keep
    ascending ids.
    """
    by_id = torch.argsort(ids, dim=-1, stable=True)
    s1 = torch.gather(scores, -1, by_id)
    order = torch.gather(
        by_id, -1, torch.argsort(s1, dim=-1, descending=True,
                                 stable=True))[..., :k]
    return torch.gather(scores, -1, order), torch.gather(ids, -1, order)


# --------------------------------------------------------------------------
# edge-parity retriever (the paper's laptop deployment)
# --------------------------------------------------------------------------

class Retriever:
    """Single-process retriever over a KnowledgeBase (paper's deployment).

    Thin single-query wrapper over the batched ``QueryEngine`` — kept
    for API compatibility; multi-query serving should call
    ``QueryEngine.query_batch`` directly.  Queries see KB mutations
    automatically (the engine refreshes incrementally from the KB's
    dirty log).

    ``prefilter=True`` uses the ⟨I⟩-region postings to restrict HSF
    scoring to documents sharing at least one query term — sub-linear
    for selective queries.  Recall caveat (documented): char-level
    substring matches inside *longer tokens* have no shared term and
    are only found by the full scan, so prefiltering is an opt-in
    accelerator (exact for whole-token queries, e.g. entity codes).
    The IVF plane (``QueryEngine(index="ivf")``) has no such caveat: its
    probe ranks clusters by cosine **and** a signature-union containment
    test.  The candidate subset is scored through the index plane's
    shared gather helper (``index.ivf.score_candidate_rows`` →
    ``score_batch_arrays``), so subset scores are bit-identical to the
    corresponding rows of the full scan and ties break by global doc
    index, same as every other path.
    """

    def __init__(
        self,
        kb: KnowledgeBase,
        alpha: float = hsf.DEFAULT_ALPHA,
        beta: float = hsf.DEFAULT_BETA,
        use_kernel: bool = False,
        prefilter: bool = False,
        engine: QueryEngine | None = None,
        scoring_path: str = "auto",
        device=None,
    ):
        from repro_torch.core.engine import resolve_device, resolve_scoring_path

        self.kb = kb
        self.alpha = alpha
        self.beta = beta
        if engine is not None and device is None:
            device = engine.device
        device = resolve_device(device)
        # same device-aware resolution as the engine, so a default
        # Retriever and a default QueryEngine always agree on the path
        path = resolve_scoring_path(scoring_path, use_kernel=use_kernel,
                                    device=device)
        self.use_kernel = path == "kernel"
        self.prefilter = prefilter
        if engine is not None and (
            engine.kb is not kb
            or engine.alpha != alpha
            or engine.beta != beta
            or engine.scoring_path != path
            or engine.device != device
        ):
            raise ValueError(
                "shared engine disagrees with Retriever parameters "
                f"(engine: same_kb={engine.kb is kb} alpha={engine.alpha} "
                f"beta={engine.beta} scoring_path={engine.scoring_path} "
                f"device={engine.device} vs {path} on {device})"
            )
        self.engine = engine or QueryEngine(
            kb, alpha=alpha, beta=beta, scoring_path=path, device=device
        )

    # materialized state lives in the engine; expose it for compat
    @property
    def doc_vecs(self):
        return self.engine.doc_vecs

    @property
    def doc_sigs(self):
        return self.engine.doc_sigs

    @property
    def doc_ids(self):
        return self.engine.doc_ids

    def query(self, text: str, k: int = 5) -> list[RetrievalResult]:
        if not self.prefilter:
            return self.engine.query(text, k)
        return self._query_prefiltered(text, k)

    def _query_prefiltered(self, text: str, k: int) -> list[RetrievalResult]:
        from repro_torch.core.engine import (
            pack_query_arrays,
            results_from_topk,
            score_batch_arrays,
        )
        from repro_torch.index.ivf import score_candidate_rows

        if k <= 0:
            raise ValueError(f"k must be a positive integer, got {k}")
        self.engine.refresh()
        if not self.doc_ids:
            return []
        qv, qs = self.engine._query_arrays(text)
        qvp, qsp = pack_query_arrays([(qv, qs)], self.kb.dim,
                                     self.kb.sig_words)
        cand = self.kb.postings().candidates(
            text, mode="union",
            max_candidates=max(256, len(self.doc_ids) // 4),
        )
        if cand is not None and len(cand) == 0:
            return []
        n = len(self.doc_ids)
        if cand is None:  # unselective query: full scan is cheaper
            vals, idx, cos, ind = score_batch_arrays(
                self.doc_vecs, self.doc_sigs, qvp, qsp,
                scoring_path=self.engine.scoring_path, k=min(k, n),
                alpha=self.alpha, beta=self.beta, n_docs=n,
            )
        else:
            vals, idx, cos, ind = score_candidate_rows(
                self.doc_vecs, self.doc_sigs,
                np.sort(np.asarray(cand, np.int32)), qvp, qsp,
                scoring_path=self.engine.scoring_path,
                k=min(k, len(cand)), alpha=self.alpha, beta=self.beta,
            )
        return results_from_topk(self.doc_ids, 1, vals, idx, cos, ind)[0]


# --------------------------------------------------------------------------
# sharded retrieval (multi-device slice)
# --------------------------------------------------------------------------

def pad_corpus(
    doc_vecs: np.ndarray, doc_sigs: np.ndarray, n_shards: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad doc count to a multiple of n_shards (padding is masked out at
    query time via the global-index < n_docs test)."""
    n = doc_vecs.shape[0]
    padded = math.ceil(max(n, 1) / n_shards) * n_shards
    if padded != n:
        doc_vecs = np.concatenate(
            [doc_vecs, np.zeros((padded - n, doc_vecs.shape[1]), doc_vecs.dtype)]
        )
        doc_sigs = np.concatenate(
            [doc_sigs, np.zeros((padded - n, doc_sigs.shape[1]), doc_sigs.dtype)]
        )
    return doc_vecs, doc_sigs, n


def build_sharded_retrieve(*args, **kwargs):
    """The mesh-sharded retriever: per-device local HSF top-k and a
    global stable merge.  Ported with the multi-device slice."""
    raise NotImplementedError(
        "build_sharded_retrieve belongs to the multi-device slice of the "
        "PyTorch port (ROADMAP Queue 1 item 8), which is not ported yet; "
        "single_device_reference is its oracle")


def single_device_reference(doc_vecs, doc_sigs, q_vecs, q_sigs, n_docs, k,
                            alpha=hsf.DEFAULT_ALPHA, beta=hsf.DEFAULT_BETA):
    """Unsharded oracle for the sharded path (same masking + tie rule):
    (vals [B, k], ids [B, k]) as tensors on the inputs' device (host
    arrays score on the CPU)."""
    dv, ds, qv, qs = (torch.as_tensor(x) for x in
                      (doc_vecs, doc_sigs, q_vecs, q_sigs))
    scores = hsf.hsf_scores_batched(dv, ds, qv, qs, alpha, beta)
    gids = torch.arange(dv.shape[0], dtype=torch.int32, device=dv.device)
    scores = scores.masked_fill(gids[None, :] >= n_docs, float("-inf"))
    return _stable_top_k(scores, gids.expand(scores.shape), k)
