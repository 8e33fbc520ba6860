"""The adapters hand the program every key the references read: the
deepseek file's ``rope_scaling`` and ``routed_scaling_factor`` reach the
port's configuration under their published names when they state
something other than the identity, and nothing at all when they state
it, so a file of plain RoPE and unscaled experts builds the same
``LMConfig`` as it always did."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))

from pbkit import spec  # noqa: E402

DEEPSEEK = "rag.deepseek-v2-lite-16b"
QWEN = "rag.qwen3-moe-30b-a3b"


def _config(name: str) -> dict:
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def _adapter(model_type: str, tag: str):
    return spec.load_module(BENCH_DIR / "adapters" / f"{model_type}.py",
                            f"pb_test_adapters_{model_type}_{tag}")


def _recorded(cfg: dict) -> dict:
    """The keywords ``program_config`` gives ``LMConfig`` and
    ``MoEConfig``, with both replaced by recorders (so the reading holds
    whatever fields the port's classes have)."""
    adapter = _adapter("deepseek_v2", "recorded")
    calls = {}

    def recorder(name):
        def record(**kwargs):
            calls[name] = kwargs
            return name
        return record

    adapter.LMConfig = recorder("lm")
    adapter.MoEConfig = recorder("moe")
    adapter.program_config(cfg)
    return calls


def test_deepseek_file_rope_scaling_reaches_the_program():
    cfg = _config(DEEPSEEK)
    calls = _recorded(cfg)
    got = calls["lm"]["rope_scaling"]
    assert got == cfg["rope_scaling"]
    assert got["type"] == "yarn" and got["factor"] == 40
    assert type(got) is dict and got is not cfg["rope_scaling"]
    assert calls["lm"]["moe"] == "moe"
    # the published factor is 1: nothing to pass
    assert "routed_scaling_factor" not in calls["moe"]


def test_deepseek_routed_scaling_factor_reaches_the_program():
    cfg = dict(_config(DEEPSEEK), routed_scaling_factor=16)
    calls = _recorded(cfg)
    assert calls["moe"]["routed_scaling_factor"] == 16


@pytest.mark.parametrize("absent", [False, True], ids=["null", "absent"])
def test_deepseek_identity_passes_neither_keyword(absent):
    cfg = dict(_config(DEEPSEEK), rope_scaling=None, routed_scaling_factor=1)
    if absent:
        del cfg["rope_scaling"]
    calls = _recorded(cfg)
    assert "rope_scaling" not in calls["lm"]
    assert "routed_scaling_factor" not in calls["moe"]


def _qwen_today():
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig

    return LMConfig(
        name=QWEN, n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=768, vocab=151936, pattern=("global",),
        window=None, attn_softcap=None, final_softcap=None, qk_norm=True,
        post_norms=False, rope_base=1000000.0, rope_base_local=None,
        activation="silu", embed_scale=False, tie_embeddings=False,
        query_scale=None,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, n_shared=0,
                      norm_topk=True, router_dtype="float32",
                      aux_loss_weight=0.001),
        n_dense_head_layers=0, dense_d_ff=None, mla=None, dtype="bfloat16",
        remat=True, kv_repeat=1)


def _deepseek_plain_rope_today():
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig

    return LMConfig(
        name=DEEPSEEK, n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab=102400, pattern=("global",),
        window=None, attn_softcap=None, final_softcap=None, qk_norm=False,
        post_norms=False, rope_base=10000.0, rope_base_local=None,
        activation="silu", embed_scale=False, tie_embeddings=False,
        query_scale=None,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      norm_topk=False, router_dtype="float32",
                      aux_loss_weight=0.001),
        n_dense_head_layers=1, dense_d_ff=10944,
        mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                      v_head_dim=128, q_lora_rank=None),
        dtype="bfloat16", remat=True, kv_repeat=1)


@pytest.mark.parametrize("case", ["qwen3_moe", "deepseek_v2_plain_rope"])
def test_program_config_is_todays_field_for_field(case):
    """The qwen3 file as it stands, and the deepseek file with
    ``rope_scaling`` null, build exactly the configuration written out
    here, so the cell they run measures what it measured."""
    if case == "qwen3_moe":
        cfg, want = _config(QWEN), _qwen_today()
    else:
        cfg, want = (dict(_config(DEEPSEEK), rope_scaling=None),
                     _deepseek_plain_rope_today())
    got = _adapter(cfg["model_type"], "today").program_config(cfg)
    assert got == want
