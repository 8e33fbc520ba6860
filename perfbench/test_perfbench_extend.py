"""A configuration, a traffic mix, a cell and a metric added as new
files are found by name, with no file of the benchmark edited."""
from __future__ import annotations

import filecmp
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import smoke  # noqa: E402
from test_perfbench_run import run_cell  # noqa: E402

NEW_METRIC = '''"""Answers completed in the window (a count)."""


def read(run):
    return float(len(run.answers))
'''


def test_new_files_only(tmp_path):
    bench_json = smoke.bench_dir(tmp_path, BENCH_DIR)
    pb = tmp_path / "perfbench"
    (pb / "traffic" / "added_2u.json").write_text(json.dumps({
        "loop": "closed", "users": 2, "max_new_tokens": 3,
        "lookup_share": 0.3, "topical_words": [2, 4], "check_tokens": 12}))
    (pb / "workloads" / "smoke.qwen.added_2u.json").write_text(
        json.dumps({"limits": smoke.LIMITS}))
    (pb / "metrics" / "answers_completed.py").write_text(NEW_METRIC)
    bench = json.loads(bench_json.read_text())
    bench["workloads"].append({"name": "smoke.qwen.added_2u",
                               "config": "smoke.qwen", "traffic": "added_2u",
                               "chips": 1, "why": "added by files"})
    bench["per_layer"].append({
        "name": "answers_completed", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "generation",
        "moves": "answer_tokens_per_s", "workloads": ["smoke.qwen.added_2u"]})
    bench_json.write_text(json.dumps(bench))
    # nothing that was there changed: every file of the repository's
    # benchmark is in the copy, byte for byte
    for path in BENCH_DIR.rglob("*"):
        rel = path.relative_to(BENCH_DIR)
        if path.is_dir() or "cache" in rel.parts or "__pycache__" in rel.parts:
            continue
        assert filecmp.cmp(path, pb / rel, shallow=False), rel
    result, forbidden = run_cell(bench_json, "smoke.qwen.added_2u", 1)
    assert forbidden == [] and result["correct"] is True
    assert result["metrics"]["answers_completed"]["value"] >= 1
