"""The control, put in the program's place, must come out not correct:
the references computed in the precision below the configuration's
(fp8 products for the bf16 language model, TF32 operands for the
float32 retrieval cosines), judged as the program is judged, on three
seeds at the CPU test size.  On the card the same readings come from
``calibrate.py`` at each cell's own size."""
from __future__ import annotations

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


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("control")
    bench_json = smoke.bench_dir(root, BENCH_DIR)
    return spec.load_cell("smoke.qwen.smoke_1u", bench_json,
                          root / "perfbench")


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_is_not_correct(cell, seed):
    cache = cell.bench_dir / "cache"
    harness.use_cache_dirs(cache)
    cache_dir = cache / corpus_mod.corpus_key(cell.config)
    corpus = corpus_mod.load_or_make(cell.config, cache_dir)
    kb = harness.container(cell, corpus, cache_dir)
    device = torch.device("cpu")
    weights = wts.make(spec.reference_module(cell).weight_specs(cell.config),
                       seed, device)
    served = harness.serve_window(cell, kb, weights, seed, 1.0, False,
                                  device, corpus)
    limits = cell.workload["limits"]
    program = harness.judge(cell, served, weights, corpus, cache_dir, device,
                            seed)
    assert chk.verdict(program, limits)[0], program
    control = harness.judge(cell, served, weights, corpus, cache_dir, device,
                            seed, control=True)
    ok, rows = chk.verdict(control, limits)
    assert not ok, rows
    assert control["retrieval_gap"] > limits["retrieval_gap"]
