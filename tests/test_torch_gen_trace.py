"""Spans of the generation layer (``RAGPipeline.generate``) on the CPU,
with the SMOKE LM: one ``generate`` span holding a ``pack_context``
span and a ``step_launch`` and a ``token_readback`` span for the
prefill and for each decode step; none with the tracer off, and the
same tokens either way; ``trace=`` choosing the trace they go into; the
breakdown table's line for traced generations."""
import time
import types

import pytest
import torch

from repro_torch import configs
from repro_torch.core.engine import QueryEngine
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.rag import RAGPipeline
from repro_torch.data.corpus import make_corpus
from repro_torch.models import transformer as T
from repro_torch.obs import format_breakdown
from repro_torch.obs import trace as obs_trace

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

STAGES = ("pack_context", "step_launch", "token_readback")
QUESTION = "invoice payment schedule"


@pytest.fixture(scope="module")
def rag():
    docs, _ = make_corpus(n_docs=24, n_entities=2, seed=11)
    kb = KnowledgeBase(dim=256)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    cfg = configs.get("llama3.2-3b").smoke_config
    model = T.init(cfg, torch.Generator().manual_seed(0))
    return RAGPipeline(kb, model, cfg, max_context_tokens=96,
                       engine=QueryEngine(kb, device="cpu"))


@pytest.fixture
def tracer():
    """The default tracer, on for the test and off and empty after it."""
    obs_trace.get().drain()
    obs_trace.enable()
    try:
        yield obs_trace.get()
    finally:
        obs_trace.disable()
        obs_trace.get().drain()


@pytest.fixture(scope="module")
def results(rag):
    """Retrieved before any test turns the tracer on (retrieval records
    spans of its own)."""
    return rag.engine.query_batch([QUESTION], k=3)[0]


@pytest.mark.parametrize("n_tokens", [1, 4])
def test_traced_generate_records_one_span_per_stage(rag, tracer, results,
                                                    n_tokens):
    out = rag.generate(QUESTION, results, n_tokens)
    spans = tracer.drain()
    (gen,) = [s for s in spans if s.name == "generate"]
    kids = [s for s in spans if s is not gen]
    assert sorted(s.name for s in kids) == sorted(
        ["pack_context"] + ["step_launch", "token_readback"] * (1 + n_tokens))
    assert all(s.parent_id == gen.span_id and s.trace_id == gen.trace_id
               for s in kids)
    assert gen.trace_id and gen.parent_id == 0
    end = gen.t0_ns + gen.dur_ns
    assert all(gen.t0_ns <= s.t0_ns and s.t0_ns + s.dur_ns <= end
               for s in kids)
    assert sum(s.dur_ns for s in kids) <= gen.dur_ns
    assert gen.args == {"prompt_len": out.prompt_len, "tokens": n_tokens,
                        "bucket": rag.steps.bucket(out.prompt_len),
                        "captures": 0}
    (pack,) = [s for s in kids if s.name == "pack_context"]
    assert pack.args == {"passages": len(results), "tokens": out.prompt_len}
    # in time order: pack, then each step's launch before its readback
    order = [(s.name, s.args.get("step")) for s in
             sorted(kids, key=lambda s: s.t0_ns)]
    steps = [("step_launch", "prefill"), ("token_readback", "prefill")] + [
        ("step_launch", "decode"), ("token_readback", "decode")] * n_tokens
    assert order == [("pack_context", None)] + steps


def test_untraced_generate_records_nothing_and_gives_the_same_tokens(
        rag, tracer, results):
    traced = rag.generate(QUESTION, results, 3)
    assert len(tracer.drain()) == 1 + 1 + 2 * 4
    obs_trace.disable()
    plain = rag.generate(QUESTION, results, 3)
    assert len(tracer) == 0
    assert plain.token_ids == traced.token_ids
    assert plain.prompt_len == traced.prompt_len
    assert plain.prefill_s > 0 and plain.decode_s > 0


@pytest.mark.parametrize("n_tokens", [1, 5])
def test_untraced_generate_reads_only_its_timings_clock(
        rag, results, monkeypatch, n_tokens):
    """Tracing off: two clock reads for the prefill's time and two a
    decode step, as before the spans; nothing more per step."""
    from repro_torch.core import rag as rag_mod

    reads = []

    def perf_counter():
        reads.append(1)
        return time.perf_counter()

    monkeypatch.setattr(rag_mod, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    assert not obs_trace.enabled()
    rag.generate(QUESTION, results, n_tokens)
    assert len(reads) == 2 + 2 * n_tokens


def test_trace_argument_chooses_the_trace(rag, tracer, results):
    tid = tracer.begin_trace()
    rag.generate(QUESTION, results, 2, trace=tid)
    spans = tracer.drain()
    assert len(spans) == 1 + 1 + 2 * 3
    assert {s.trace_id for s in spans} == {tid}
    # an unsampled request's trace (0): nothing recorded
    rag.generate(QUESTION, results, 2, trace=0)
    assert tracer.drain() == []
    # inside an enclosing span: its trace, and a child of it
    with obs_trace.span("request") as outer:
        rag.generate(QUESTION, results, 2)
    spans = tracer.drain()
    gen = next(s for s in spans if s.name == "generate")
    assert gen.trace_id == outer.trace_id and gen.parent_id == outer.span_id


def test_breakdown_lists_traced_generations(rag, tracer, results):
    for _ in range(2):
        rag.generate(QUESTION, results, 2)
    spans = tracer.drain()
    table = format_breakdown(spans)
    for name in ("generate",) + STAGES:
        assert any(line.startswith(name + " ") for line in
                   table.splitlines()), name
    (line,) = [ln for ln in table.splitlines()
               if ln.startswith("-- 2 traced generations")]
    cover = float(line.rsplit("cover ", 1)[1].split("%")[0])
    assert 0 < cover <= 100
