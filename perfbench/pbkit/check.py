"""The comparison that decides ``correct``: what the timed path served,
against the plain references, each number beside the limit the cell's
workload file gives it.

- ``retrieval_gap``: over every retrieval resolved in the window, the
  widest of |served score − reference score at the same rank|,
  |served score − reference score of the served document| and
  |served cosine − reference cosine of that document| (float64
  reference).  A wrong id, a wrong order or a wrong score shows here; a
  near tie swapped by rounding moves it by the tie's width only.  A
  result list of the wrong length, or with an unknown or repeated id,
  reads infinity.
- ``boost_mismatch``: served ``boosted`` flags that differ from the
  reference's containment indicator (exact: limit 0).
- ``prompt_mismatch``: sampled answers whose prompt length differs from
  the reference's packing of the same served documents (exact: 0).
- ``logit_gap``: over the sampled answers' served tokens, the widest
  gap by which a served token's float32 reference logit lies below the
  reference's best at that position (greedy decoding serves the best);
  ``logit_gap_mean``: the mean of those gaps.  A cell compares the one
  of the two that separates its program's readings from its control's
  (``perfbench/workloads/<cell>.json``).

A cell's workload file names the numbers it compares and their limits;
the exact ones (``boost_mismatch``, ``prompt_mismatch``) have limit 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pbkit import retrieval_ref as rref

NUMBERS = ("retrieval_gap", "boost_mismatch", "prompt_mismatch",
           "logit_gap", "logit_gap_mean")
REQUIRED = ("retrieval_gap", "boost_mismatch", "prompt_mismatch")


def worst(values) -> float:
    """The largest of ``values``; infinity when any is not finite (a NaN
    must not hide behind ``max``)."""
    a = np.asarray(values, dtype=np.float64)
    if a.size == 0:
        return 0.0
    return float(a.max()) if np.all(np.isfinite(a)) else math.inf


def doc_index(doc_id: str, n: int) -> int | None:
    if len(doc_id) < 2 or doc_id[0] != "d" or not doc_id[1:].isdigit():
        return None
    i = int(doc_id[1:])
    return i if i < n else None


def served_rows(results, n: int, k: int):
    """(ids, scores, cosines, boosted) of one served result list, or
    None when its shape is wrong."""
    ids = [doc_index(r.doc_id, n) for r in results]
    if len(ids) != k or None in ids or len(set(ids)) != k:
        return None
    return (np.array(ids), np.array([r.score for r in results]),
            np.array([r.cosine for r in results]),
            np.array([r.boosted for r in results]))


def retrieval_numbers(ref: rref.RetrievalReference, questions: list[str],
                      served: list, k: int, control: bool = False) -> dict:
    """``served[i]`` is (ids, scores, cosines, boosted) or None.  With
    ``control`` the served rows are ignored and the reference's own
    TF32 top-k is judged in their place."""
    top = ref.top_k(questions, k)
    if control:
        ctl = ref.top_k(questions, k, control=True)
        served = []
        for i in range(len(questions)):
            ids = ctl["ids"][i]
            served.append((ids, ctl["scores"][i], ctl["cos_all"][i][ids],
                           ctl["ind_all"][i][ids] > 0.5))
    gap, mismatch = 0.0, 0
    for i, rows in enumerate(served):
        if rows is None:
            gap = math.inf
            continue
        ids, scores, cos, boosted = rows
        ref_scores = ref.alpha * top["cos_all"][i][ids] \
            + ref.beta * top["ind_all"][i][ids]
        gap = max(gap, worst(np.abs(scores - top["scores"][i])),
                  worst(np.abs(scores - ref_scores)),
                  worst(np.abs(cos - top["cos_all"][i][ids])))
        mismatch += int(np.sum(boosted != (top["ind_all"][i][ids] > 0.5)))
    return {"retrieval_gap": gap, "boost_mismatch": mismatch}


def generation_numbers(ref_mod, weights: dict, cfg: dict, texts: list[str],
                       answers: list, max_context: int, n_docs: int,
                       control: bool = False, group: int = 8) -> dict:
    """``answers`` are (question, served result list, prompt_len,
    token_ids).  With ``control`` the tokens judged are those the fp8
    reference puts first at each position of the same sequences."""
    vocab = cfg["vocab_size"]
    gap, mismatch = 0.0, 0
    gaps: list[float] = []
    for lo in range(0, len(answers), group):
        seqs, wanted, served = [], [], []
        for question, results, prompt_len, tokens in answers[lo:lo + group]:
            docs = [texts[doc_index(r.doc_id, n_docs)] for r in results]
            prompt = rref.pack_prompt(question, docs, vocab, max_context)
            mismatch += int(len(prompt) != prompt_len)
            n = len(prompt)
            seqs.append(prompt + list(tokens[:-1]))
            wanted.append([n - 1 + j for j in range(len(tokens))])
            served.append(list(tokens))
        ref_logits = ref_mod.logits(weights, cfg, seqs, wanted)
        if control:
            ctl = ref_mod.logits(weights, cfg, seqs, wanted, fp8=True)
            served = [c.argmax(-1).tolist() for c in ctl]
        for lg, toks in zip(ref_logits, served):
            t = torch.tensor(toks, device=lg.device)
            best = lg.max(-1).values
            got = lg.gather(1, t[:, None])[:, 0]
            each = (best - got).cpu().numpy()
            gap = max(gap, worst(each))
            gaps.extend(each.tolist())
    mean = float(np.mean(gaps)) if np.all(np.isfinite(gaps)) else math.inf
    return {"logit_gap": gap, "prompt_mismatch": mismatch,
            "logit_gap_mean": mean if gaps else 0.0}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[tuple]]:
    """(every number the cell compares within its limit, [(name, value,
    limit)] in ``NUMBERS``' order)."""
    missing = [n for n in REQUIRED if n not in limits]
    if missing or not set(limits) <= set(NUMBERS) or not (
            {"logit_gap", "logit_gap_mean"} & set(limits)):
        raise ValueError(f"a cell compares {REQUIRED} and a logit gap, "
                         f"from {NUMBERS}; got {sorted(limits)}")
    rows = [(name, numbers[name], limits[name]) for name in NUMBERS
            if name in limits]
    return all(v <= lim for _, v, lim in rows), rows
