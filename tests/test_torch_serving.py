"""The port's serving runtime and serve driver, on the CPU.

Scheduled results equal a direct ``query_batch`` at the generation the
flush pinned, under live ingest; the driver prints the JAX engine's ids
and scores for the same corpus and generates for every request, its
``--trace`` file holding each request's retrieval and generation in one
trace, and in
multi-tenant mode (``--tenant-root``) prints the JAX driver's ids and
scores for every tenant; both drivers read the same flags alike; the
package imports neither jax nor anything of the JAX package; entry
points with no device given raise on a host without a card."""
import contextlib
import io
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.data.corpus import make_corpus, write_corpus_dir
from repro_torch.launch import serve
from repro_torch.obs import load_chrome_trace
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import (
    EngineSnapshot,
    ServingRuntime,
    results_equal,
)

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _kb(n_docs=40, dim=512, seed=0):
    docs, entities = make_corpus(n_docs=n_docs, n_entities=4, seed=seed)
    kb = KnowledgeBase(dim=dim)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    return kb, entities


@pytest.mark.parametrize("scoring_path", ["map", "kernel"])
def test_scheduled_results_equal_direct_query_at_pinned_generation(
        scoring_path):
    """Reader threads submit while the writer ingests and publishes;
    every served result equals a direct query against the snapshot of
    the generation it was served at."""
    kb, entities = _kb()
    queries = list(entities) + ["quarterly forecast", "server latency",
                                "NEW-DOC-CODE", "audit ledger"]
    runtime = ServingRuntime(kb, max_batch=4, flush_deadline=0.001,
                             scoring_path=scoring_path, device="cpu")
    snaps = {runtime.generation: runtime.snapshots.current}
    served, errors = [], []

    def reader(offset):
        try:
            for i in range(12):
                q = queries[(offset + i) % len(queries)]
                served.append((q, runtime.submit(q, k=3).result(timeout=30)))
        except Exception as exc:  # noqa: BLE001 — surfaced by the assert
            errors.append(exc)

    with runtime:
        threads = [threading.Thread(target=reader, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for r in range(3):
            kb.add_text(f"new_{r}.txt", f"fresh doc {r} NEW-DOC-CODE")
            runtime.publish()
            snaps[runtime.generation] = runtime.snapshots.current
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(served) == 48
    for q, res in served:
        direct = snaps[res.generation].query_batch([q], k=3)[0]
        assert results_equal(res.results, direct), (q, res.generation)
    assert runtime.metrics.snapshot()["completed"] == 48


def test_runtime_contracts(tmp_path):
    kb, entities = _kb(20)
    with pytest.raises(ValueError, match="exclusive"):
        ServingRuntime(kb, pool=object())
    path = str(tmp_path / "kb.ragdb")
    runtime = ServingRuntime(kb, device="cpu", container_path=path)
    with runtime:
        code = next(iter(entities))
        top = runtime.query_batch([code], k=2)[0][0]
        assert top.boosted
        kb.add_text("late.txt", "late doc LATE-1")
        gen = runtime.publish(durable=True)
        assert runtime.generation == gen
        assert runtime.query_batch(["LATE-1"], k=1)[0][0].doc_id == "late.txt"
        runtime.arm_sanitizers(k=2)
        assert runtime.retrace_guard.armed
    res = runtime.resources()
    planes = res["tenants"]["default"]["planes"]
    engine = runtime.engine
    assert planes["doc_matrix"] == \
        engine.doc_vecs.nbytes + engine.doc_sigs.nbytes
    assert runtime.health()["status"] in ("ok", "degraded", "critical")
    assert KnowledgeBase.load(path).n_docs == kb.n_docs
    assert isinstance(runtime.snapshots.current, EngineSnapshot)


_RESULT = re.compile(r"^  ([* ]) (\S+)\s+score=(\S+)$")


def _printed(out):
    rows, cur = {}, None
    for line in out.splitlines():
        if line.startswith("Q: "):
            cur = line[3:].rsplit("  [generation", 1)[0]
            rows[cur] = []
        elif cur is not None and (m := _RESULT.match(line)):
            rows[cur].append((m.group(2), m.group(1) == "*", m.group(3)))
    return rows


def test_serve_prints_the_jax_engines_ids_and_scores(tmp_path):
    docs, entities = make_corpus(n_docs=50, n_entities=3, seed=2)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    queries = list(entities) + ["other query", "invoice payment"]
    trace_file = str(tmp_path / "trace.json")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--corpus", corpus, "--dim", "1024",
                             "--top-k", "3", "--max-batch", "4",
                             "--device", "cpu",
                             "--save", str(tmp_path / "kb.ragdb"),
                             "--trace", trace_file, "--queries", *queries])
    finally:  # --trace turned the process's tracer on
        obs_trace.disable()
        obs_trace.get().drain()
    assert rc == 0
    got = _printed(buf.getvalue())
    ref_kb = RefKB(dim=1024)
    ref_kb.sync(corpus)
    ref = RefEngine(ref_kb).query_batch(queries, k=3)
    want = {q: [(r.doc_id, r.boosted, f"{r.score:.4f}") for r in rows]
            for q, rows in zip(queries, ref)}
    assert got == want
    for code, doc in entities.items():
        assert got[code][0][:2] == (f"doc_{doc:05d}.txt", True)
    # every request generated 8 tokens with the SMOKE LM
    out = buf.getvalue()
    assert out.count("  generated token ids: [") == len(queries)
    assert "generator: llama3.2-smoke" in out
    assert "generation: 5 requests" in out
    assert "serving metrics: served 5/5 requests" in out
    # the trace holds each request whole: its retrieval stages and, in
    # the same trace, its generation with one launch and one readback a
    # step (the prefill and 8 decode steps)
    spans = load_chrome_trace(trace_file)
    requests = [s for s in spans if s.name == "request"]
    assert len(requests) == len(queries)
    for req in requests:
        mine = [s for s in spans if s.trace_id == req.trace_id]
        (gen,) = [s for s in mine if s.name == "generate"]
        kids = [s.name for s in mine if s.parent_id == gen.span_id]
        assert sorted(kids) == sorted(
            ["pack_context"] + ["step_launch", "token_readback"] * 9)
        assert "queue_wait" in {s.name for s in mine}
    assert "-- 5 traced generations" in out


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b",
                                  "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
def test_serve_generates_with_every_lm_arch(tmp_path, arch):
    """``--arch`` takes each LM arch; the CPU serves its SMOKE config, and
    an MoE arch's active parameter count is printed beside the total."""
    from repro_torch import configs

    docs, entities = make_corpus(n_docs=30, n_entities=2, seed=3)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    queries = list(entities) + ["invoice payment"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--corpus", corpus, "--dim", "512", "--top-k", "2",
                         "--device", "cpu", "--arch", arch,
                         "--max-new-tokens", "3", "--queries", *queries])
    assert rc == 0
    out = buf.getvalue()
    cfg = configs.get(arch).smoke_config
    active = (f" ({cfg.active_param_count():,} active)"
              if cfg.moe is not None else "")
    assert f"generator: {cfg.name}, {cfg.param_count():,} params{active} " \
        in out
    assert out.count("  generated token ids: [") == len(queries)
    assert f"generation: {len(queries)} requests" in out
    for code, doc in entities.items():
        assert _printed(out)[code][0][:2] == (f"doc_{doc:05d}.txt", True)


def test_serve_without_a_card_and_without_device_raises(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--dim", "512", "--queries", "x"])


class _Built(Exception):
    """Raised by a stand-in runtime once it has seen its arguments."""


@pytest.mark.parametrize("argv,want", [
    (["--use-kernel"], "kernel"),
    (["--scoring-path", "map", "--use-kernel"], "kernel"),
    (["--scoring-path", "gemm"], "gemm"),
    ([], "auto"),
])
def test_both_serve_parsers_resolve_use_kernel_to_the_same_scoring_path(
        argv, want, monkeypatch):
    """``--use-kernel`` is the JAX package's ``serve.py`` alias for
    ``--scoring-path kernel``; the port's parser accepts it and hands
    the runtime the same scoring path."""
    from repro.launch import serve as ref_serve

    seen = {}

    def runtime(tag):
        def build(kb, **kwargs):
            seen[tag] = kwargs["scoring_path"]
            raise _Built
        return build

    monkeypatch.setattr(ref_serve, "ServingRuntime", runtime("ref"))
    monkeypatch.setattr(serve, "ServingRuntime", runtime("port"))
    args = ["--dim", "256", "--queries", "x", *argv]
    with pytest.raises(_Built):
        ref_serve.main(args)
    with pytest.raises(_Built):
        serve.main([*args, "--device", "cpu"])
    assert seen == {"ref": want, "port": want}


class _StubRuntime:
    """Stands in for the multi-tenant runtime: records what the driver
    built from its flags, then stops the driver at its first submit."""

    seen: dict = {}
    tag = None

    def __init__(self, pool=None, quotas=None, **kwargs):
        kwargs.pop("slo")
        type(self).seen[self.tag] = dict(
            root=os.path.basename(pool.root),
            max_resident=pool.max_resident, kb_kwargs=pool.kb_kwargs,
            scoring_path=pool.engine_kwargs["scoring_path"],
            rate=quotas and quotas.default_rate,
            burst=quotas and quotas.default_burst, **kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, *args, **kwargs):
        raise _Built


@pytest.mark.parametrize("argv", [
    [],
    ["--tenants", "3", "--resident-budget", "5", "--quota-rate", "20",
     "--quota-burst", "4"],
    ["--quota-rate", "7.5", "--resident-budget", "0", "--use-kernel"],
])
def test_both_serve_parsers_resolve_the_tenant_flags_alike(
        argv, tmp_path, monkeypatch):
    """``--tenant-root``, ``--tenants``, ``--resident-budget``,
    ``--quota-rate`` and ``--quota-burst`` build the same pool, quotas
    and runtime in both drivers, which announce the same tenants."""
    from repro.launch import serve as ref_serve

    outs = {}
    for tag, driver, extra in (("ref", ref_serve, []),
                               ("port", serve, ["--device", "cpu"])):
        stub = type(f"Stub_{tag}", (_StubRuntime,), {"tag": tag})
        monkeypatch.setattr(driver, "ServingRuntime", stub)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(_Built):
            driver.main(["--tenant-root", str(tmp_path / "root"),
                         "--dim", "256", "--queries", "x", *argv, *extra])
        outs[tag] = buf.getvalue()
    assert _StubRuntime.seen["ref"] == _StubRuntime.seen["port"]
    assert outs["ref"] == outs["port"]
    assert outs["port"].startswith("serving ")


_TENANT_Q = re.compile(r"^\[(\S+)\] Q: (.*)  \[generation (\d+)")


def _printed_tenants(out):
    """{(tenant, query): (generation, rows)} and the pool/ledger lines
    from a multi-tenant run's output."""
    rows, cur, totals = {}, None, []
    for line in out.splitlines():
        if (m := _TENANT_Q.match(line)):
            cur = (m.group(1), m.group(2))
            rows[cur] = (int(m.group(3)), [])
        elif cur is not None and (m := _RESULT.match(line)):
            rows[cur][1].append((m.group(2), m.group(1) == "*", m.group(3)))
        elif line.startswith(("pool: ", "ledger: ", "[tenant")):
            totals.append(line)
    return rows, totals


def test_serve_multitenant_prints_the_jax_drivers_ids_and_scores(tmp_path):
    from repro.launch import serve as ref_serve

    docs, entities = make_corpus(n_docs=50, n_entities=3, seed=2)
    corpus = str(tmp_path / "corpus")
    write_corpus_dir(corpus, docs)
    queries = list(entities) + ["other query", "invoice payment",
                                "quarterly audit"]
    outs = {}
    for tag, main, extra in (("ref", ref_serve.main, []),
                             ("port", serve.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--tenant-root", str(tmp_path / tag), "--tenants",
                       "3", "--corpus", corpus, "--dim", "1024",
                       "--top-k", "3", "--resident-budget", "2",
                       "--queries", *queries, *extra])
        assert rc == 0
        outs[tag] = _printed_tenants(buf.getvalue())
    (got, got_totals), (want, want_totals) = outs["port"], outs["ref"]
    assert got == want
    assert sorted(got) == sorted(
        (f"tenant{i % 3:02d}", q) for i, q in enumerate(queries))
    for i, (code, doc) in enumerate(entities.items()):
        assert got[f"tenant{i % 3:02d}", code][1][0][:2] == \
            (f"doc_{doc:05d}.txt", True)
    # per-tenant sync lines, the pool's residency and the ledger's bytes
    sync = [t for t in got_totals if "sync:" in t]
    assert sync == [t for t in want_totals if "sync:" in t] and len(sync) == 3
    assert [t for t in got_totals if t.startswith(("pool", "ledger"))] == \
        [t for t in want_totals if t.startswith(("pool", "ledger"))]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.serving\n"
        "import repro_torch.core.engine, repro_torch.kernels.hsf_score.ops\n"
        "import repro_torch.kernels.build, repro_torch.obs\n"
        "import repro_torch.models.transformer, repro_torch.models.attention\n"
        "import repro_torch.core.rag, repro_torch.configs.llama3_2_3b\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.tenancy, repro_torch.examples.quickstart\n"
        "import repro_torch.examples.live_sync\n"
        "import repro_torch.examples.multi_tenant\n"
        "import repro_torch.examples.rag_serve\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_kernel_path_on_the_cpu_gives_a_query_the_same_bits_at_any_batch():
    """The kernel path's plain version (the CPU's) keeps the card
    kernel's contract: a query's ids, scores and cosines inside a batch
    of 2-4 equal its own at B = 1, bit for bit (one gemm over the batch
    used to round them by the batch's size)."""
    from repro_torch.core.engine import QueryEngine

    kb, entities = _kb()
    queries = list(entities) + ["quarterly forecast", "server latency",
                                "NEW-DOC-CODE", "audit ledger"]
    engine = QueryEngine(kb, scoring_path="kernel", device="cpu")
    alone = {q: engine.query_batch([q], k=3)[0] for q in queries}
    checked = 0
    for size in (2, 3, 4):
        for start in range(len(queries)):
            batch = [queries[(start + i) % len(queries)]
                     for i in range(size)]
            for q, res in zip(batch, engine.query_batch(batch, k=3)):
                assert results_equal(res, alone[q]), (size, batch, q)
                for a, b in zip(res, alone[q]):
                    assert (a.score, a.cosine) == (b.score, b.cosine)
                checked += 1
    assert checked == (2 + 3 + 4) * len(queries)
