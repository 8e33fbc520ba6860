"""The port's examples, run on the CPU at their own sizes: each asserts
what it shows (entity recall, IVF exact mode equal to the flat scan,
zero torn reads under live ingest, crash recovery from the journal,
LRU eviction with durable state, quota rejections carrying the
tenant, micro-batched RAG serving with gemma2 SMOKE generation, the
train/checkpoint/restart-replay run of ``train_lm``), and exits
cleanly."""
import contextlib
import io

import pytest
import torch

from repro_torch.examples import (
    live_sync,
    multi_tenant,
    quickstart,
    rag_serve,
    train_lm,
)

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)


def _run(example) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example.main(["--device", "cpu"])
    return buf.getvalue()


def test_quickstart():
    out = _run(quickstart)
    assert "engine on cpu, scoring path map" in out
    assert "Recall@1 vs flat scan" in out
    assert "exact top-k bit-identical to the flat scan ✓" in out
    assert ("sharded     : 4 shards (logical), exact top-k bit-identical "
            "to the flat scan ✓") in out
    assert "query INV-2026 → doc_00007.txt" in out
    assert "restore     : retrieval identical after round-trip ✓" in out


def test_live_sync():
    out = _run(live_sync)
    assert "query TICKET-4821 → new_note.txt (boosted=True" in out
    assert "torn reads: 0" in out
    assert "crash recovery restored 400 docs" in out


def test_multi_tenant():
    out = _run(multi_tenant)
    for tenant in ("acme", "globex", "initech"):
        assert f"[{tenant}] published generation 80" in out
    assert "resident after ingest: ['globex', 'initech']" in out
    assert "[initech] quota rejected 5/6 flood requests" in out


def test_rag_serve():
    out = _run(rag_serve)
    assert "(gemma2-smoke, 0.2 M params, on cpu)" in out
    assert out.count(" tokens=[") == 8
    assert "mean occupancy" in out
    assert "RQ2 check: all entity requests retrieved their doc ✓" in out


@pytest.mark.parametrize("example", [quickstart, live_sync, multi_tenant,
                                     rag_serve, train_lm])
def test_examples_default_to_the_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_train_lm():
    out = _run(train_lm)
    assert "restored checkpoint at step 60" in out
    assert "step    99  loss" in out
    assert "final loss" in out
