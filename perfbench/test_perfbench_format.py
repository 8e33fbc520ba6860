"""``BENCHMARK.json`` against the format's rules on names, units and
lengths, and every name it gives found as a file."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert any(w.startswith(bench["paths"][0] + "/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_name_and_unit(bench):
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert PATH.match(c["file"])
    for w in bench["workloads"]:
        names.append(w["name"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for name in names:
        assert NAME.match(name), name
    assert len(set(names)) == len(names)


def test_metrics_follow_the_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_every_name_is_a_file(bench):
    used = set()
    for w in bench["workloads"]:
        used.add(w["config"])
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        workload = json.loads(
            (BENCH_DIR / "workloads" / f"{w['name']}.json").read_text())
        limits = workload["limits"]
        assert {"retrieval_gap", "boost_mismatch", "prompt_mismatch"} <= \
            set(limits) <= {"retrieval_gap", "boost_mismatch",
                            "prompt_mismatch", "logit_gap", "logit_gap_mean"}
        assert {"logit_gap", "logit_gap_mean"} & set(limits)
        assert limits["boost_mismatch"] == limits["prompt_mismatch"] == 0
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert (BENCH_DIR / "reference" / f"{cfg['model_type']}.py").is_file()
        assert (BENCH_DIR / "adapters" / f"{cfg['model_type']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            if "cache" in rel.split("/") or "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_config_keeps_every_published_number(bench):
    """The deepseek file holds the published config.json's numbers and
    its ``rope_scaling`` group whole (the program must implement the
    file's ``rope_scaling``: the adapter hands it over, and a program
    without it stops at construction); a file that ``BENCHMARK.json``
    names differs only in the keys its entry lists under ``reduced``."""
    published = {  # hf:deepseek-ai/DeepSeek-V2-Lite config.json
        "first_k_dense_replace": 1, "hidden_size": 2048,
        "intermediate_size": 10944, "kv_lora_rank": 512,
        "max_position_embeddings": 163840, "moe_intermediate_size": 1408,
        "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
        "n_shared_experts": 2, "num_attention_heads": 16,
        "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06, "rope_theta": 10000,
        "routed_scaling_factor": 1, "topk_group": 1, "v_head_dim": 128,
        "vocab_size": 102400,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}
    name = "rag.deepseek-v2-lite-16b"
    entry = next((c for c in bench["configs"] if c["name"] == name),
                 {"file": f"perfbench/configs/{name}.json", "reduced": []})
    cfg = json.loads((ROOT / entry["file"]).read_text())
    for key, value in published.items():
        assert key in entry["reduced"] or cfg[key] == value, key
