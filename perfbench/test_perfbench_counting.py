"""The counting functions against hand counts at the cells' shapes."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import counting, peaks, spec  # noqa: E402

H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def _counts(config: str) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    mod = spec.load_module(BENCH_DIR / "reference" / f"{cfg['model_type']}.py",
                           f"pb_test_ref_{cfg['model_type']}")
    return mod.counts(cfg)


def test_mla_prefill_attention_hand_count():
    c = _counts("rag.deepseek-v2-lite-16b")
    n = 1941
    assert counting.attention_flops(c, n, n) == pytest.approx(
        27 * 16 * n * n * 320)
    # one decode token at context 2,000: 2 · 2,000 pairs · 16 heads · 320
    assert counting.attention_flops(c, 1, 2000) == pytest.approx(
        27 * 2 * 2000 * 16 * 320)


def test_flash_bounds_hand_count():
    ds = _counts("rag.deepseek-v2-lite-16b")
    n = 1941
    flops = 16 * n * n * 320                       # 19.29 GFLOP
    nbytes = 2 * n * 16 * (192 + 192 + 128 + 128)  # q, k, v, o in bf16
    assert counting.flash_bound_s(ds, n, H100) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert flops / 989e12 > nbytes / 3.35e12       # compute-bound
    qw = _counts("rag.qwen3-moe-30b-a3b")
    nbytes = 2 * n * (32 * 128 + 4 * 128 + 4 * 128 + 32 * 128)
    assert counting.flash_bound_s(qw, n, H100) == pytest.approx(
        max(32 * n * n * 256 / 989e12, nbytes / 3.35e12))


def test_hsf_bound_hand_count():
    # one query: the 1.07 GB doc matrix and 32 MB of signatures bound it
    got = counting.hsf_bound_s(65536, 4096, 128, 1, 16, H100)
    nbytes = 4 * 65536 * (4096 + 128) + 4 * (4096 + 128) + 16 * 8
    assert got == pytest.approx(nbytes / 3.35e12)
    assert got == pytest.approx(3.306e-4, rel=1e-3)
    # 2·B·N·D at the TF32 peak takes over only past ~450 queries
    assert counting.hsf_bound_s(65536, 4096, 128, 1024, 16, H100) == \
        pytest.approx(2 * 1024 * 65536 * 4096 / 495e12)


def test_active_parameters_hand_count():
    ds = _counts("rag.deepseek-v2-lite-16b")
    attn = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)
    moe = 2048 * 64 + 3 * 2048 * 1408 * (6 + 2)
    assert ds["layer_params"] == [attn + 3 * 2048 * 10944] + [attn + moe] * 26
    qw = _counts("rag.qwen3-moe-30b-a3b")
    attn = 2048 * (32 + 8) * 128 + 32 * 128 * 2048
    assert qw["layer_params"] == [attn + 2048 * 128 + 3 * 2048 * 768 * 8] * 48
    # the qwen3 model passes ~3 B parameters a token (3.3 B with the
    # embedding and the head, as published)
    assert 2.6e9 < sum(qw["layer_params"]) < 3.0e9


def test_answer_flops_hand_count():
    c = {"layer_params": [10, 20], "hq": 2, "hkv": 1, "dqk": 3, "dv": 5,
         "d_model": 4, "vocab": 7}
    # prompt 6, 3 tokens: 6 + 2 decoded tokens through the layers, the
    # head for 3, prefill attention 6²/2 pairs, decode at contexts 7, 8
    want = (2 * 30 * 8 + 2 * 4 * 7 * 3
            + 2 * (18 + 7 + 8) * 2 * 8 * 2)
    assert counting.answer_flops(c, 6, 3) == pytest.approx(want)
