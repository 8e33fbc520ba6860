"""``run.py`` end to end on the CPU at the port's SMOKE sizes, in a
fresh interpreter: the result line, the output check passing
against the plain references, and no JAX module loaded."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import smoke  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    return smoke.bench_dir(tmp_path_factory.mktemp("bench"), BENCH_DIR)


def run_cell(bench_json: Path, cell: str, trace: int) -> tuple[dict, list]:
    """The command's main on the CPU in a new process; returns the last
    line's object and the forbidden modules loaded by then."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(BENCH_DIR)!r})\n"
        "import run\n"
        f"rc = run.main(['--workload', {cell!r}, '--seed', '{SEED}', "
        f"'--seconds', '2', '--trace', '{trace}'], "
        f"bench_json=__import__('pathlib').Path({str(bench_json)!r}), "
        "device='cpu')\n"
        "names = {m.split('.', 1)[0] for m in sys.modules}\n"
        f"print(json.dumps(sorted(names & set({sorted(FORBIDDEN)!r}))))\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("cell,trace", [("smoke.deepseek.smoke_1u", 0),
                                        ("smoke.qwen.smoke_4u", 1)])
def test_run_prints_the_result_line(bench_json, cell, trace):
    result, forbidden = run_cell(bench_json, cell, trace)
    assert forbidden == []
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "window", "checks"]
    assert result["window"]["stalled"] is False
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}
    bench = json.loads(bench_json.read_text())
    pool = bench["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in pool}
    assert set(result["metrics"]) <= names
    if trace:
        # what the CPU has: spans and the pipeline's own times
        assert {"retrieval_ms.p95", "queue_wait_ms.p50", "query_embed_ms.p50",
                "materialize_ms.p50", "prefill_ms.p50",
                "decode_ms_per_token.p50"} <= set(result["metrics"])
    else:
        assert {"answer_p95_ms", "answer_tokens_per_s",
                "setup_s"} == set(result["metrics"])
    for name, m in result["metrics"].items():
        assert m["value"] > 0, name
    checks = result["checks"]
    assert set(checks) == set(smoke.LIMITS)
    for c in checks.values():
        assert c["value"] <= c["limit"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        if "cache" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    program_side = {"harness.py"}
    for path in list((BENCH_DIR / "pbkit").glob("*.py")) + list(
            (BENCH_DIR / "reference").glob("*.py")):
        if path.name in program_side:
            continue
        assert "repro_torch" not in _imports(path), path
