"""The rest of a run, the look for a card skipped, with the timed path
broken underneath: the output check must come out not correct for each
fault a cell of this benchmark can have (one card, so no exchange
between cards to leave out)."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))

from pbkit import check as chk  # noqa: E402
from pbkit import corpus as corpus_mod  # noqa: E402
from pbkit import harness, smoke, spec, weights as wts  # noqa: E402

SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults")
    bench_json = smoke.bench_dir(root, BENCH_DIR)
    pb = root / "perfbench"
    # a flush deadline long enough that the users' first questions are
    # scored in one batch, which the half-batch fault needs
    cfg = json.loads((pb / "configs" / "smoke.deepseek.json").read_text())
    cfg["serving"]["flush_deadline_ms"] = 50.0
    (pb / "configs" / "smoke.deepseek.json").write_text(json.dumps(cfg))
    cell = spec.load_cell("smoke.deepseek.smoke_4u", bench_json, pb)
    cache = pb / "cache"
    harness.use_cache_dirs(cache)
    cache_dir = cache / corpus_mod.corpus_key(cell.config)
    corpus = corpus_mod.load_or_make(cell.config, cache_dir)
    kb = harness.container(cell, corpus, cache_dir)
    return cell, corpus, kb, cache_dir


def run_once(setup) -> tuple[bool, dict]:
    cell, corpus, kb, cache_dir = setup
    device = torch.device("cpu")
    weights = wts.make(spec.reference_module(cell).weight_specs(cell.config),
                       SEED, device)
    served = harness.serve_window(cell, kb, weights, SEED, 1.5, False,
                                  device, corpus)
    numbers = harness.judge(cell, served, weights, corpus, cache_dir,
                            device, SEED)
    ok, _ = chk.verdict(numbers, cell.workload["limits"])
    return ok, numbers


def test_sound_run_is_correct(setup):
    ok, numbers = run_once(setup)
    assert ok, numbers


def _token_altered(monkeypatch):
    from repro_torch.core import rag

    orig = rag.RAGPipeline.generate

    def generate(self, question, results, max_new_tokens):
        out = orig(self, question, results, max_new_tokens)
        ids = list(out.token_ids)
        ids[-1] = (ids[-1] + 1) % self.cfg.vocab
        return dataclasses.replace(out, token_ids=ids)

    monkeypatch.setattr(rag.RAGPipeline, "generate", generate)


def _answer_altered(monkeypatch):
    from repro_torch.core import engine

    orig = engine._materialize_rows

    def materialize(doc_ids, b, vals, idx, cos, ind):
        rows = orig(doc_ids, b, vals, idx, cos, ind)
        for row in rows:
            row[0].doc_id, row[-1].doc_id = row[-1].doc_id, row[0].doc_id
        return rows

    monkeypatch.setattr(engine, "_materialize_rows", materialize)


def _state_unchanged(monkeypatch):
    """The prefill and decode steps compute on a copy of the KV cache
    and hand back the cache they were given, unchanged."""
    from repro_torch.models import transformer

    def clones(caches):
        return [{k: v.clone() for k, v in c.items()} for c in caches]

    prefill, decode = transformer.prefill_static, transformer.decode_step

    def prefill_static(model, tokens, lengths, caches, cfg=None,
                       backend="auto"):
        logits, _, lengths = prefill(model, tokens, lengths, clones(caches),
                                     cfg, backend)
        return logits, caches, lengths

    def decode_step(model, caches, tokens, lengths, cfg=None,
                    backend="auto"):
        return decode(model, clones(caches), tokens, lengths, cfg,
                      backend)[0], caches

    monkeypatch.setattr(transformer, "prefill_static", prefill_static)
    monkeypatch.setattr(transformer, "decode_step", decode_step)


def _half_batch(monkeypatch):
    from repro_torch.serving import snapshot

    orig = snapshot.score_batch_arrays

    def score(doc_vecs, doc_sigs, qv, qs, **kw):
        vals, idx, cos, ind = orig(doc_vecs, doc_sigs, qv, qs, **kw)
        b = int((abs(qv).sum(axis=1) > 0).sum())  # the real queries
        half = (b + 1) // 2
        for i in range(half, b):  # scored as the first half's mean row
            for a in (vals, idx, cos, ind):
                a[i] = a[i - half]
        return vals, idx, cos, ind

    monkeypatch.setattr(snapshot, "score_batch_arrays", score)


@pytest.mark.parametrize("fault", [_token_altered, _answer_altered,
                                   _state_unchanged, _half_batch],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(setup, monkeypatch, fault):
    fault(monkeypatch)
    ok, numbers = run_once(setup)
    assert not ok, numbers
