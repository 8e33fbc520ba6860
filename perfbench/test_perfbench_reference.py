"""The plain references against the program at small sizes in float32:
the same weights, the same tokens, the program's full forward and the
reference's logits agree to float32 rounding (MLA with its shared RoPE
key and latent norm, DeepSeek's shared and unnormalized routed experts,
GQA with qk-norm and Qwen3's renormalized gates, the norm gains the
port parameterizes as 1 + w)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))

from pbkit import smoke, spec, weights as wts  # noqa: E402


@pytest.mark.parametrize("arch", [smoke.DEEPSEEK, smoke.QWEN],
                         ids=lambda a: a["model_type"])
def test_reference_matches_the_program_in_float32(arch):
    from repro_torch.models import transformer as T

    cfg = dict(arch, name="ref-check", torch_dtype="float32")
    mt = cfg["model_type"]
    ref = spec.load_module(BENCH_DIR / "reference" / f"{mt}.py",
                           f"pb_test_reference_{mt}")
    adapter = spec.load_module(BENCH_DIR / "adapters" / f"{mt}.py",
                               f"pb_test_adapter_{mt}")
    w = wts.make(ref.weight_specs(cfg), 2 ** 31 + 5, "cpu")
    model = T.LM(adapter.program_config(cfg), adapter.program_tree(w, cfg),
                 torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    seq = torch.randint(0, cfg["vocab_size"], (1, 37), generator=gen)
    with torch.no_grad():
        got, _ = T.forward(model, seq)
    want = ref.logits(w, cfg, [seq[0].tolist()], [list(range(37))])[0]
    scale = want.abs().max()
    assert torch.allclose(got[0], want, atol=2e-5 * scale, rtol=0), \
        float((got[0] - want).abs().max() / scale)


def test_yarn_tables_hand_values():
    """DeepSeek-V2-Lite's published YaRN (factor 40, mscale and
    mscale_all_dim 0.707, beta 32 and 1 in 4,096 positions, rope 64):
    frequency pairs 0-9 keep rope_theta's, 23-31 are divided by 40, the
    ramp lies between; cos and sin are not scaled; the softmax scale
    gains (0.1 · 0.707 · ln 40 + 1)^2."""
    import json
    import math

    cfg = json.loads((BENCH_DIR / "configs"
                      / "rag.deepseek-v2-lite-16b.json").read_text())
    ref = spec.load_module(BENCH_DIR / "reference" / "deepseek_v2.py",
                           "pb_test_reference_yarn")
    inv, cos_sin, softmax = ref.rope_tables(cfg)
    plain = 10000.0 ** (-torch.arange(32, dtype=torch.float64) / 32)
    # correction dims: 64 ln(4096 / (32 · 2π)) / (2 ln 10⁴) = 10.47 → 10,
    # 64 ln(4096 / 2π) / (2 ln 10⁴) = 22.5 → 23
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    assert torch.equal(inv[:11], plain[:11])
    assert torch.allclose(inv[23:], plain[23:] / 40, rtol=1e-15, atol=0)
    assert torch.allclose(inv, plain * (1 - ramp) + plain / 40 * ramp,
                          rtol=1e-15, atol=0)
    assert cos_sin == 1.0
    assert softmax == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2)
    assert softmax == pytest.approx(1.5896, abs=1e-4)
    assert ref.rope_tables(dict(cfg, rope_scaling=None))[1:] == (1.0, 1.0)


def test_yarn_reference_departs_from_plain_rope():
    """With the published ``rope_scaling`` the reference's logits are not
    plain RoPE's, so the check holds the program to the file's
    ``rope_scaling``: a program that ran plain RoPE in its place would
    have its answers refused.  The adapter hands the program the group,
    and a program without it stops at construction."""
    cfg = dict(smoke.DEEPSEEK, name="yarn-check", torch_dtype="float32")
    ref = spec.load_module(BENCH_DIR / "reference" / "deepseek_v2.py",
                           "pb_test_reference_yarn_smoke")
    yarn = dict(cfg, rope_scaling={
        "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"})
    w = wts.make(ref.weight_specs(yarn), 2 ** 31 + 5, "cpu")
    seq = torch.randint(0, cfg["vocab_size"], (37,),
                        generator=torch.Generator().manual_seed(3)).tolist()
    plain = ref.logits(w, cfg, [seq], [list(range(37))])[0]
    got = ref.logits(w, yarn, [seq], [list(range(37))])[0]
    gap = float((got - plain).abs().max() / plain.abs().max())
    assert gap > 1e-3, gap
