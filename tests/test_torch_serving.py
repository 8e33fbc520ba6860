"""The port's serving runtime and serve driver, on the CPU.

Scheduled results equal a direct ``query_batch`` at the generation the
flush pinned, under live ingest; the driver prints the JAX engine's ids
and scores for the same corpus and generates for every request; the
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
    with pytest.raises(NotImplementedError, match="tenancy"):
        ServingRuntime(pool=object())
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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--corpus", corpus, "--dim", "1024", "--top-k", "3",
                         "--max-batch", "4", "--device", "cpu",
                         "--save", str(tmp_path / "kb.ragdb"),
                         "--queries", *queries])
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


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.serving\n"
        "import repro_torch.core.engine, repro_torch.kernels.hsf_score.ops\n"
        "import repro_torch.kernels.build, repro_torch.obs\n"
        "import repro_torch.models.transformer, repro_torch.models.attention\n"
        "import repro_torch.core.rag, repro_torch.configs.llama3_2_3b\n"
        "import repro_torch.kernels.flash_attention.ops\n"
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
