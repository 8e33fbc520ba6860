"""The port's invariant analyzer (``repro_torch.analysis``) against the
contracts of the JAX package's (``tests/test_analysis.py``), on fixtures
written in torch: every rule catches its failing fixture and passes its
clean one, pragmas suppress exactly what they name (and are audited
themselves), the CLI exit codes hold, the runtime sanitizers catch a
capture after arming and injected NaNs, and the port's own tree is
strict-clean with a current audit (``docs/ANALYSIS_AUDIT_TORCH.md``).

The torch-specific fixtures are the rules' new reach: ``torch.matmul``
and ``.mm(`` in a scoring module, ``index_copy_`` on a snapshot's
tensor, ``.item()`` in a function ``CapturedStep`` captures, and a bare
``torch.cuda.synchronize()`` in ``serving/`` — each flagged, then
cleared by a justified pragma."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitizers
from repro_torch.analysis.pragmas import parse_pragmas
from repro_torch.analysis.runner import render_audit, run_analysis
from repro_torch.obs.metrics import global_registry

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIT = os.path.join(REPO_ROOT, "docs", "ANALYSIS_AUDIT_TORCH.md")


def _fixture_tree(tmp_path, files: dict[str, str]) -> str:
    """Materialize {relpath: source} under tmp_path and return the root
    (run_analysis treats a dir without src/repro_torch as the package
    root, so fixture paths like core/hsf.py match the real rule
    scopes)."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(tmp_path)


def _findings(tmp_path, files, rule=None, strict=False):
    report = run_analysis(_fixture_tree(tmp_path, files), strict=strict)
    assert not report.errors, report.errors
    if rule is None:
        return report.findings
    return [f for f in report.findings if f.rule == rule]


@pytest.fixture(autouse=True)
def _reset_sanitizers():
    yield
    sanitizers._enabled = None  # back to env-driven


# --------------------------------------------------------------------------
# R1 unpinned-reduction
# --------------------------------------------------------------------------

def test_r1_flags_matmul_and_calls(tmp_path):
    found = _findings(tmp_path, {"core/engine.py": """
        import torch
        def score(q, dv):
            a = q @ dv.T
            b = torch.matmul(q, dv.T)
            c = torch.einsum("bd,nd->bn", q, dv)
            return a + b + c
    """}, rule="unpinned-reduction")
    assert len(found) == 3
    assert {f.line for f in found} == {4, 5, 6}


def test_r1_flags_every_torch_product(tmp_path):
    found = _findings(tmp_path, {"index/ivf.py": """
        import numpy as np
        import torch
        import torch.nn.functional as F
        def score(q, dv, x, v):
            a = torch.mm(q, dv.T)
            b = torch.bmm(x, x)
            c = torch.dot(v, v) + torch.inner(v, v) + torch.vdot(v, v)
            d = torch.tensordot(q, dv, dims=([1], [1]))
            e = F.linear(q, dv)
            f = q.matmul(dv.T) + q.mm(dv.T) + x.bmm(x) + v.dot(v)
            g = np.dot(q, v)
            return a, b, c, d, e, f, g
    """}, rule="unpinned-reduction")
    assert sorted(f.line for f in found) == [
        6, 7, 8, 8, 8, 9, 10, 11, 11, 11, 11, 12]


def test_r1_clean_inside_stable_rowdot_and_out_of_scope(tmp_path):
    found = _findings(tmp_path, {
        # the pinned reduction itself may use whatever it wants
        "core/hsf.py": """
            import torch
            def stable_rowdot(mat, vec):
                return (mat @ vec).sum()
        """,
        # scoring-module scopes only: a model file may matmul freely
        "models/lm.py": """
            import torch
            def fwd(x, w):
                return torch.matmul(x, w) + x @ w
        """,
    }, rule="unpinned-reduction")
    assert found == []


def test_r1_pragma_suppresses_trailing_and_comment_only(tmp_path):
    found = _findings(tmp_path, {"core/engine.py": """
        def score(q, dv):
            a = q @ dv.T  # analysis: allow[unpinned-reduction] -- fixture
            # analysis: allow[unpinned-reduction] -- spans the whole
            #   statement, continuation comments included
            b = (
                q @ dv.T
            )
            return a + b
    """})
    assert found == []


@pytest.mark.parametrize("call", ["torch.matmul(q, dv.T)", "q.mm(dv.T)"])
def test_r1_torch_fixture_flagged_then_cleared_by_pragma(tmp_path, call):
    bare = {"core/hsf.py": f"""
        import torch
        def scores(q, dv):
            return {call}
    """}
    found = _findings(tmp_path, bare, rule="unpinned-reduction")
    assert len(found) == 1 and found[0].line == 4
    justified = {"core/hsf.py": f"""
        import torch
        def scores(q, dv):
            # analysis: allow[unpinned-reduction] -- opt-in gemm fixture
            return {call}
    """}
    assert _findings(tmp_path, justified, strict=True) == []


# --------------------------------------------------------------------------
# R2 writer-lock
# --------------------------------------------------------------------------

_R2_CLASS = """
    import contextlib

    class KnowledgeBase:
        @contextlib.contextmanager
        def _single_writer(self, op):
            yield

        def reader(self):
            return len(self.records)

        def locked_mutator(self, x):
            with self._single_writer("ok"):
                self.records[x] = x

        def _helper(self, x):
            self.records[x] = x
"""


def test_r2_flags_unlocked_public_mutator(tmp_path):
    found = _findings(tmp_path, {"core/ingest.py": _R2_CLASS + """
        def bad(self, x):
            self.records[x] = x
"""}, rule="writer-lock")
    assert [f for f in found if "bad" in f.message]
    assert not [f for f in found if "reader" in f.message
                or "locked_mutator" in f.message
                or "_helper" in f.message]


def test_r2_flags_transitive_mutation_via_helper(tmp_path):
    found = _findings(tmp_path, {"core/ingest.py": _R2_CLASS + """
        def bad_indirect(self, x):
            self._helper(x)
"""}, rule="writer-lock")
    assert [f for f in found if "bad_indirect" in f.message]


def test_r2_ignores_classes_without_the_lock(tmp_path):
    found = _findings(tmp_path, {"core/ingest.py": """
        class PlainBag:
            def put(self, x):
                self.records = x
    """}, rule="writer-lock")
    assert found == []


# --------------------------------------------------------------------------
# R3 durability
# --------------------------------------------------------------------------

def test_r3_flags_bare_write_rename_and_replace(tmp_path):
    found = _findings(tmp_path, {"serving/dump.py": """
        import os
        def publish(path, blob):
            with open(path + ".tmp", "w") as fh:
                fh.write(blob)
            os.rename(path + ".tmp", path)
            os.replace(path + ".tmp", path)
    """}, rule="durability")
    assert len(found) == 3


def test_r3_allows_reads_and_blessed_helpers(tmp_path):
    found = _findings(tmp_path, {"core/container.py": """
        import os
        def _atomic_write_json(path, obj):
            fd = os.open(path + ".tmp", os.O_WRONLY)
            with os.fdopen(fd, "w") as fh:
                fh.write(obj)
            os.replace(path + ".tmp", path)
        def load(path):
            with open(path) as fh:
                return fh.read()
    """}, rule="durability")
    assert found == []


def test_r3_pragma_suppressed(tmp_path):
    found = _findings(tmp_path, {"checkpoint/scratch.py": """
        def debug_dump(path, blob):
            with open(path, "w") as fh:  # analysis: allow[durability] -- fixture
                fh.write(blob)
    """})
    assert found == []


# --------------------------------------------------------------------------
# R4 snapshot-mutation
# --------------------------------------------------------------------------

def test_r4_flags_unfrozen_class_and_mutation(tmp_path):
    found = _findings(tmp_path, {"serving/snap.py": """
        from dataclasses import dataclass

        @dataclass
        class EngineSnapshot:
            generation: int

        def touch(mgr):
            snap = EngineSnapshot(generation=0)
            snap.generation = 1
            object.__setattr__(snap, "generation", 2)
    """}, rule="snapshot-mutation")
    assert len(found) == 3  # unfrozen decl, attr store, __setattr__


def test_r4_clean_frozen_capture_and_swap(tmp_path):
    found = _findings(tmp_path, {"serving/snap.py": """
        from dataclasses import dataclass

        @dataclass(frozen=True)
        class EngineSnapshot:
            generation: int

        class Manager:
            def publish(self):
                snap = EngineSnapshot(generation=1)
                self._current = snap  # swapping the ref is the protocol
                return self._current
    """}, rule="snapshot-mutation")
    assert found == []


def test_r4_flags_store_on_manager_current(tmp_path):
    found = _findings(tmp_path, {"apps/consumer.py": """
        def poke(mgr):
            snap = mgr.current
            snap.doc_ids = ()
    """}, rule="snapshot-mutation")
    assert len(found) == 1


def test_r4_flags_in_place_writes_to_pinned_tensors(tmp_path):
    found = _findings(tmp_path, {"apps/consumer.py": """
        def poke(mgr, engine, index, rows, block):
            snap = mgr.current
            snap.doc_vecs.add_(1.0)
            snap.doc_sigs[rows] = 0
            dv = engine.doc_vecs
            dv.masked_fill_(dv < 0, 0.0)
            dv[0] += 1.0
            engine.doc_sigs.zero_()
            blocks = list(index.dv_blocks)
            blocks[0][rows] = block
            index.ds_blocks[1].fill_(0)
            x, y = engine.kernel_operands
            x.copy_(block)
    """}, rule="snapshot-mutation")
    assert sorted(f.line for f in found) == [4, 5, 7, 8, 9, 11, 12, 14]


def test_r4_clean_copy_on_write_patches(tmp_path):
    found = _findings(tmp_path, {"index/sharded.py": """
        def reassign(self, rows, block, crossed):
            dv_b = list(self.dv_blocks)
            for s in crossed:
                dv_b[s] = gather(s)  # a fresh block: store into the list
            for s in (0, 1):
                dv_b[s] = dv_b[s].clone()
                dv_b[s][rows] = block  # writes the clone
            out = self.doc_vecs.clone()
            out[rows] = block
            self.doc_vecs = out  # rebinding is the protocol
            return dv_b
    """}, rule="snapshot-mutation")
    assert found == []


def test_r4_a_rebound_index_is_another_element(tmp_path):
    """A clone of ``blocks[s]`` in one loop does not clear ``blocks[s]``
    of the next loop, whose ``s`` is another element."""
    found = _findings(tmp_path, {"index/sharded.py": """
        def reassign(self, rows, block, crossed, kept):
            dv_b = list(self.dv_blocks)
            for s in crossed:
                dv_b[s] = dv_b[s].clone()
            for s in kept:
                dv_b[s][rows] = block
            return dv_b
    """}, rule="snapshot-mutation")
    assert [f.line for f in found] == [7]


def test_r4_torch_fixture_flagged_then_cleared_by_pragma(tmp_path):
    bare = {"serving/patch.py": """
        def patch(mgr, rows, block):
            snap = mgr.current
            x = snap.doc_vecs
            x.index_copy_(0, rows, block)
    """}
    found = _findings(tmp_path, bare, rule="snapshot-mutation")
    assert len(found) == 1 and found[0].line == 5
    assert "index_copy_" in found[0].message
    justified = {"serving/patch.py": """
        def patch(mgr, rows, block):
            snap = mgr.current
            x = snap.doc_vecs
            # analysis: allow[snapshot-mutation] -- fixture: a private
            #   snapshot no reader was ever handed
            x.index_copy_(0, rows, block)
    """}
    assert _findings(tmp_path, justified, strict=True) == []


# --------------------------------------------------------------------------
# R5 host-sync
# --------------------------------------------------------------------------

def test_r5_flags_host_syncs_in_captured_fns_only(tmp_path):
    found = _findings(tmp_path, {"core/score.py": """
        import numpy as np
        from repro_torch.launch.steps import CapturedStep

        def bad_item(x):
            return x.sum().item()

        def make_score_step(k):
            def step_fn(x):
                return np.asarray(x)[:k]
            return step_fn

        def _core(x):
            return float(x.sum())
        worse = CapturedStep(_core, ())
        lam = CapturedStep(lambda x: x.cpu(), ())

        def host_boundary(x):
            return float(x.sum())  # not captured: fine
        step = CapturedStep(bad_item, ())
    """}, rule="host-sync")
    assert len(found) == 4
    assert {f.line for f in found} == {6, 10, 14, 16}


def test_r5_pragma_suppressed(tmp_path):
    found = _findings(tmp_path, {"core/score.py": """
        def make_shape_step(cfg):
            def step_fn(x):
                return int(cfg.dim)  # analysis: allow[host-sync] -- static config
            return step_fn
    """})
    assert found == []


def test_r5_capture_fixture_flagged_then_cleared_by_pragma(tmp_path):
    bare = {"launch/steps.py": """
        class Holder:
            def __init__(self, model):
                self._fn = lambda x: model(x).item()
                self.step = CapturedStep(self._fn, ())
    """}
    found = _findings(tmp_path, bare, rule="host-sync")
    assert len(found) == 1 and "`.item()`" in found[0].message
    justified = {"launch/steps.py": """
        class Holder:
            def __init__(self, model):
                # analysis: allow[host-sync] -- fixture: an eager-only step
                self._fn = lambda x: model(x).item()
                self.step = CapturedStep(self._fn, ())
    """}
    assert _findings(tmp_path, justified, strict=True) == []


def test_r5_bare_synchronize_flagged_then_cleared_by_pragma(tmp_path):
    bare = {"serving/loop.py": """
        import torch
        def flush(stream):
            torch.cuda.synchronize()
            stream.synchronize()
    """}
    found = _findings(tmp_path, bare, rule="host-sync")
    assert [f.line for f in found] == [4, 5]
    justified = {"serving/loop.py": """
        import torch
        def flush(stream):
            torch.cuda.synchronize()  # analysis: allow[host-sync] -- fixture: timing barrier
            # analysis: allow[host-sync] -- fixture: tracing attribution
            stream.synchronize()
    """}
    assert _findings(tmp_path, justified, strict=True) == []


# --------------------------------------------------------------------------
# R6 tenant-pin
# --------------------------------------------------------------------------

def test_r6_flags_unguarded_mutation_and_missing_pins_check(tmp_path):
    found = _findings(tmp_path, {"tenancy/pool.py": """
        class ContainerPool:
            def __init__(self):
                self._resident = {}   # construction: exempt

            def sneak_mount(self, t, mt):
                self._resident[t] = mt  # no guard, not *_locked

            def evict(self, t):
                with self._pool_guard("evict"):
                    self._resident.pop(t)  # guarded but no pins check
    """}, rule="tenant-pin")
    msgs = [f.message for f in found]
    assert len(found) == 2, msgs
    assert any("without `with self._pool_guard" in m for m in msgs)
    assert any("pins == 0" in m for m in msgs)


def test_r6_clean_pool_passes_and_outside_mutation_flagged(tmp_path):
    clean = _findings(tmp_path, {"tenancy/pool.py": """
        class ContainerPool:
            def __init__(self):
                self._resident = {}

            def pin(self, t):
                with self._pool_guard("pin"):
                    mt = self._resident.get(t)
                    if mt is None:
                        mt = self._mount_locked(t)
                    mt.pins += 1
                    self._resident.move_to_end(t)
                    return mt

            def _mount_locked(self, t):
                self._resident[t] = object()

            def _evict_locked(self, mt):
                assert mt.pins == 0
                self._resident.pop(mt.tenant)
    """}, rule="tenant-pin")
    assert clean == []
    outside = _findings(tmp_path, {"serving/hack.py": """
        def tear_down(pool, t):
            pool._resident.pop(t)

        def overwrite(pool, t, mt):
            pool._resident[t] = mt
    """}, rule="tenant-pin")
    assert len(outside) == 2
    assert all("outside" in f.message for f in outside)


# --------------------------------------------------------------------------
# pragma hygiene
# --------------------------------------------------------------------------

def test_unknown_rule_pragma_is_a_finding(tmp_path):
    found = _findings(tmp_path, {"core/x.py": """
        x = 1  # analysis: allow[unpinned-reductionz] -- typo
    """}, rule="pragma")
    assert len(found) == 1 and "unknown rule" in found[0].message


def test_unused_pragma_is_a_finding(tmp_path):
    found = _findings(tmp_path, {"core/x.py": """
        x = 1  # analysis: allow[durability] -- nothing here to excuse
    """}, rule="pragma")
    assert len(found) == 1 and "unused" in found[0].message


def test_strict_requires_justification(tmp_path):
    files = {"core/engine.py": """
        def score(q, dv):
            return q @ dv.T  # analysis: allow[unpinned-reduction]
    """}
    assert _findings(tmp_path, files, rule="pragma", strict=False) == []
    found = _findings(tmp_path, files, rule="pragma", strict=True)
    assert len(found) == 1 and "justification" in found[0].message


def test_pragma_statement_span_stops_at_bracket_close(tmp_path):
    src = textwrap.dedent("""
        # analysis: allow[unpinned-reduction] -- first statement only
        a = (
            q @ dv.T
        )
        b = q @ dv.T
    """)
    pragmas = parse_pragmas("core/x.py", src.splitlines())
    assert len(pragmas) == 1
    assert (pragmas[0].applies_to, pragmas[0].applies_end) == (3, 5)


# --------------------------------------------------------------------------
# the port's tree is the final fixture: strict-clean, audited
# --------------------------------------------------------------------------

def test_repo_is_strict_clean():
    report = run_analysis(REPO_ROOT, strict=True)
    assert report.root.endswith(os.path.join("src", "repro_torch"))
    assert report.ok, "\n" + report.format()
    # every suppression in the tree carries a justification
    used = [p for p in report.pragmas if p.used]
    assert used, "expected the documented suppressions to be present"
    assert all(p.justification for p in used)
    # the rules reach the port's capture and copy-on-write code
    rules = {p.rule for p in used}
    assert {"unpinned-reduction", "host-sync"} <= rules


def test_checked_in_audit_is_current():
    report = run_analysis(REPO_ROOT, strict=True)
    with open(AUDIT, encoding="utf-8") as fh:
        assert fh.read() == render_audit(report), (
            "docs/ANALYSIS_AUDIT_TORCH.md is stale — regenerate with "
            "PYTHONPATH=src python -m repro_torch.analysis "
            "--write-audit docs/ANALYSIS_AUDIT_TORCH.md"
        )


# --------------------------------------------------------------------------
# CLI exit-code contract
# --------------------------------------------------------------------------

def _cli(*args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=cwd or REPO_ROOT,
    )


def test_cli_exit0_on_clean_repo_strict():
    proc = _cli("--strict", "--root", REPO_ROOT, "--check-audit", AUDIT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_exit1_on_failing_fixture(tmp_path):
    root = _fixture_tree(tmp_path, {"core/engine.py": """
        import torch
        def score(q, dv):
            return torch.matmul(q, dv.T)
    """})
    proc = _cli("--root", root)
    assert proc.returncode == 1
    assert "unpinned-reduction" in proc.stdout


def test_cli_exit3_on_audit_drift(tmp_path):
    root = _fixture_tree(tmp_path, {"core/clean.py": "x = 1\n"})
    stale = tmp_path / "audit.md"
    stale.write_text("# not the audit\n")
    proc = _cli("--root", root, "--check-audit", str(stale))
    assert proc.returncode == 3
    # and --write-audit repairs it
    proc = _cli("--root", root, "--write-audit", str(stale))
    assert proc.returncode == 0
    proc = _cli("--root", root, "--check-audit", str(stale))
    assert proc.returncode == 0


def test_analysis_loads_without_jax_or_the_jax_package():
    """A fresh interpreter imports the analyzer, runs it over the tree
    and imports the sanitizers: neither ``jax`` nor anything of
    ``repro`` gets loaded, nor torch by the analyzer itself."""
    code = (
        "import sys\n"
        "import repro_torch.analysis as a\n"
        "from repro_torch.analysis.__main__ import main\n"
        f"report = a.run_analysis({REPO_ROOT!r}, strict=True)\n"
        "assert report.ok, report.format()\n"
        "assert 'torch' not in sys.modules, 'the analyzer loaded torch'\n"
        "import repro_torch.analysis.sanitizers\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


# --------------------------------------------------------------------------
# runtime sanitizers: NaN guard
# --------------------------------------------------------------------------

def test_nan_guard_off_by_default():
    vals = np.array([[1.0, np.nan]], np.float32)
    sanitizers.check_finite_scores(vals, 1, "test")  # silently passes


def test_nan_guard_catches_injection_and_ignores_padding():
    sanitizers.enable(True)
    ok = np.array([[1.0, 0.5], [-np.inf, -np.inf]], np.float32)
    # row 1 is bucket padding (n_rows=1): -inf sentinels are legitimate
    sanitizers.check_finite_scores(ok, 1, "test")
    for poison in (np.nan, np.inf, -np.inf):
        bad = np.array([[1.0, poison]], np.float32)
        with pytest.raises(sanitizers.SanitizerError, match="non-finite"):
            sanitizers.check_finite_scores(bad, 1, "test")


def test_nan_guard_fires_through_results_from_topk():
    from repro_torch.core.engine import results_from_topk
    sanitizers.enable(True)
    vals = np.array([[1.0, np.nan]], np.float32)
    idx = np.array([[0, 1]], np.int32)
    cos = np.zeros_like(vals)
    ind = np.zeros_like(vals)
    with pytest.raises(sanitizers.SanitizerError):
        results_from_topk(["a", "b"], 1, vals, idx, cos, ind)
    # same call with the padded row poisoned instead: clean
    vals2 = np.array([[1.0, 0.5], [np.nan, np.nan]], np.float32)
    out = results_from_topk(
        ["a", "b"], 1, vals2, np.array([[0, 1], [0, 0]], np.int32),
        np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float32),
    )
    assert len(out) == 1


@pytest.mark.parametrize("poison", [np.nan, np.inf])
@pytest.mark.parametrize("path", ["map", "gemm", "kernel"])
def test_nan_guard_trips_on_a_poisoned_doc_through_the_engine(path, poison):
    """One doc row of the engine's tensors poisoned (a copy, rebound as
    a refresh would): its score is NaN for every query (an infinite row
    times a query's zero weights), NaN ranks first on every path, and
    the guard at the host boundary raises — counted once per trip."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.data.corpus import make_corpus

    docs, entities = make_corpus(n_docs=30, n_entities=3, seed=5)
    kb = KnowledgeBase(dim=256)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    engine = QueryEngine(kb, device="cpu", scoring_path=path)
    queries = list(entities) + ["quarterly revenue report"]
    clean = engine.query_batch(queries, k=4)
    sanitizers.enable(True)
    assert engine.query_batch(queries, k=4) == clean  # finite: silent
    dv = engine.doc_vecs.clone()
    dv[17] = float(poison)
    engine.doc_vecs = dv
    sanitizers.enable(False)
    served = engine.query_batch(queries, k=4)
    assert all(row[0].doc_id == "doc_00017.txt" for row in served)
    assert all(np.isnan(row[0].score) for row in served)
    sanitizers.enable(True)
    trips = sum(c.value for labels, c in global_registry().series(
        "ragdb_sanitizer_trips_total").items()
        if dict(labels).get("rule") == "finite-scores")
    with pytest.raises(sanitizers.SanitizerError, match="non-finite"):
        engine.query_batch(queries, k=4)
    assert sum(c.value for labels, c in global_registry().series(
        "ragdb_sanitizer_trips_total").items()
        if dict(labels).get("rule") == "finite-scores") == trips + 1


# --------------------------------------------------------------------------
# runtime sanitizers: capture guard
# --------------------------------------------------------------------------

class _FakeStep:
    """What the guard reads of a ``CapturedStep``: a name and a capture
    count."""

    def __init__(self, name):
        self.name, self.captures = name, 0

    def capture(self):
        self.captures += 1


def _retrace_trips() -> float:
    return sum(c.value for labels, c in global_registry().series(
        "ragdb_sanitizer_trips_total").items()
        if dict(labels).get("rule") == "retrace")


def test_retrace_guard_detects_a_capture_after_arming():
    sanitizers.enable(True)
    warm = _FakeStep("test.warm_step")
    sanitizers.register_capture(warm)
    warm.capture()  # warmed before arming
    guard = sanitizers.RetraceGuard()
    guard.arm()
    guard.check("steady")  # no capture since: clean
    late = _FakeStep("test.late_step")
    sanitizers.register_capture(late)
    guard.check("registered, not captured")  # still clean
    trips = _retrace_trips()
    late.capture()  # a shape escaped the warmed buckets
    with pytest.raises(sanitizers.SanitizerError,
                       match=r"test\.late_step: 0→1"):
        guard.check("after-capture")
    assert _retrace_trips() == trips + 1
    # baseline rebased: one regression raises once
    guard.check("rebased")
    assert guard.report() == {}
    assert _retrace_trips() == trips + 1


def test_retrace_guard_disarmed_and_reset_paths():
    sanitizers.enable(True)
    guard = sanitizers.RetraceGuard()
    guard.check("unarmed")  # never raises before arm()
    guard.arm()
    assert guard.armed
    guard.reset()
    assert not guard.armed
    guard.check("after-reset")


def test_captured_steps_register_and_capture_nothing_on_the_cpu():
    from repro_torch.launch.steps import CapturedStep

    step = CapturedStep(lambda x: x * 2, (torch.ones(3),), "cpu",
                        name="test.cpu_step")
    before = sanitizers.capture_counts()
    assert before.get("test.cpu_step") == 0
    step.capture()
    assert step(torch.full((3,), 2.0)).tolist() == [4.0, 4.0, 4.0]
    assert not step.captured and step.captures == 0
    assert sanitizers.capture_counts() == before


# --------------------------------------------------------------------------
# steady-state serving loop: zero captures across bucket transitions
# (arm_sanitizers pins the bucket set; any flush size 1..max_batch must
# reuse warmed shapes, and generation every captured prompt bucket)
# --------------------------------------------------------------------------

def test_serving_steady_state_has_zero_captures():
    from repro_torch.configs import get as get_arch
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.core.rag import RAGPipeline
    from repro_torch.data.corpus import make_corpus
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingRuntime

    docs, entities = make_corpus(n_docs=24, n_entities=4, seed=3)
    kb = KnowledgeBase(dim=256)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    queries = [f"lookup {e} status report" for e in entities]
    cfg = get_arch("llama3.2-3b").smoke_config
    model = T.init(cfg, torch.Generator("cpu").manual_seed(0), "cpu")

    sanitizers.enable(True)
    trips = _retrace_trips()
    rt = ServingRuntime(kb, max_batch=8, flush_deadline=0.001,
                        result_cache_size=0, device="cpu")
    rag = RAGPipeline(kb, model, cfg, engine=rt.engine)
    with rt:
        rt.arm_sanitizers(k=3, rag=rag, max_new_tokens=2)
        assert rt.retrace_guard.armed
        assert rag.retrace_guard is rt.retrace_guard
        assert rag.steps.buckets() == [64, 128, 256, 512]
        # drive every batch size 1..max_batch through the scheduler —
        # each flush buckets to a warmed power-of-two shape, so the
        # armed guard must stay silent; generate for each flush's first
        for size in range(1, rt.scheduler.max_batch + 1):
            futs = [rt.submit(queries[j % len(queries)], k=3)
                    for j in range(size)]
            served = [f.result(timeout=60) for f in futs]
            out = rag.generate(queries[0], served[0].results, 2)
            assert len(out.token_ids) == 2
        assert rt.retrace_guard.report() == {}
        assert _retrace_trips() == trips
        # publish disarms (a new generation may warm new shapes)
        kb.add_text("doc_new.txt", "fresh content about " + queries[0])
        rt.publish()
        assert not rt.retrace_guard.armed
