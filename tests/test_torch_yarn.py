"""YaRN in the port (``LMConfig.rope_scaling``, ``layers.yarn_rope``,
MLA's scale × mscale²) against the benchmark's float32 plain reference
of DeepSeek-V2 (``perfbench/reference/deepseek_v2.py``), on the CPU.

(a) At the published group the inverse frequencies, the cos/sin factor
and the softmax factor are the reference's; (b) a group whose mscale
differs from mscale_all_dim scales cos and sin as the reference does;
(c) without ``rope_scaling`` the RoPE tables are today's bits, made by
the same ops; (d) the whole LM in float32 matches the reference's logits
within 2e-5 of their largest magnitude, the full forward and a prefill
followed by decode steps through the compressed cache, at SMOKE's widths
and at FULL's head widths (where the ramp covers the published pairs
10-23); (e) YaRN withheld, or the scale without mscale², fails that
tolerance; (f) the config stays hashable and refuses what the port does
not implement; (g) MLA's route counts and the ``generate`` span's args.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "perfbench"
sys.path.insert(0, str(BENCH_DIR))

from pbkit import lm_ref, smoke, spec, weights as wts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import deepseek_v2_lite_16b as DS  # noqa: E402
from repro_torch.core.engine import QueryEngine  # noqa: E402
from repro_torch.core.ingest import KnowledgeBase  # noqa: E402
from repro_torch.core.rag import RAGPipeline  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.models import layers, mla  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

PUBLISHED = json.loads((BENCH_DIR / "configs"
                        / "rag.deepseek-v2-lite-16b.json").read_text())
YARN = PUBLISHED["rope_scaling"]
REL_TOL = 2e-5  # test_reference_matches_the_program_in_float32's rule
PROMPT, DECODE_STEPS = 37, 4
# (nope, rope, v, kv_lora) and the rest of FULL's head widths at 2
# heads, a small d_model and 2 layers
FULL_HEADS = dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128, kv_lora_rank=512, num_attention_heads=2,
                  num_key_value_heads=2, hidden_size=64, num_hidden_layers=2)
SHAPES = {"smoke": {}, "full_heads": FULL_HEADS}


def _module(kind: str, tag: str):
    return spec.load_module(BENCH_DIR / kind / "deepseek_v2.py",
                            f"pb_test_yarn_{kind}_{tag}")


REF = _module("reference", "ref")
ADAPTER = _module("adapters", "adapter")


def _file(shape: str, rope_scaling=YARN) -> dict:
    """A float32 DeepSeek-V2 file at SMOKE's widths, or at FULL's head
    widths, with ``rope_scaling``."""
    return dict(smoke.DEEPSEEK, name=f"yarn-{shape}", torch_dtype="float32",
                rope_scaling=rope_scaling, **SHAPES[shape])


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    """(file, weights, tokens, the reference's logits at the prompt's
    positions and at each decoded one)."""
    cfg = _file(request.param)
    w = wts.make(REF.weight_specs(cfg), 2 ** 31 + 5, "cpu")
    seq = torch.randint(0, cfg["vocab_size"], (1, PROMPT + DECODE_STEPS),
                        generator=torch.Generator().manual_seed(3))
    want = REF.logits(w, cfg, [seq[0].tolist()],
                      [list(range(PROMPT + DECODE_STEPS))])[0]
    return cfg, w, seq, want


def _model(cfg: dict, w: dict) -> T.LM:
    return T.LM(ADAPTER.program_config(cfg), ADAPTER.program_tree(w, cfg),
                torch.device("cpu"))


def _gaps(model: T.LM, seq, want) -> dict:
    """Largest |program - reference| over the reference's largest
    magnitude: the full forward over the prompt, and the prefill's last
    position followed by each decode step through the cache."""
    scale = want.abs().max()
    with torch.no_grad():
        full, _ = T.forward(model, seq[:, :PROMPT])
        last, caches, lengths = T.prefill(
            model, seq[:, :PROMPT], max_len=PROMPT + DECODE_STEPS)
        steps = [last[0, -1]]
        for j in range(DECODE_STEPS - 1):
            lengths = lengths + 1
            logits, caches = T.decode_step(
                model, caches, seq[:, PROMPT + j:PROMPT + j + 1], lengths)
            steps.append(logits[0, 0])
    decoded = torch.stack(steps)
    return {"forward": float((full[0] - want[:PROMPT]).abs().max() / scale),
            "decode": float((decoded - want[PROMPT - 1:PROMPT + DECODE_STEPS
                                             - 1]).abs().max() / scale)}


# ---------------------------------------------------------------- (a), (b)

def test_published_group_matches_the_reference_tables():
    inv, cos_sin, softmax = layers.yarn_rope(64, 10000.0, YARN)
    want_inv, want_cos_sin, want_softmax = REF.rope_tables(PUBLISHED)
    assert torch.equal(inv.to(torch.float32), want_inv.to(torch.float32))
    assert cos_sin == want_cos_sin == 1.0
    assert softmax == want_softmax
    assert softmax == pytest.approx(1.5896, abs=1e-4)
    # pairs 0-9 keep rope_theta's frequencies, 23-31 are divided by 40
    plain_sin, plain_cos = layers.rope_table(torch.ones(1), 64, 10000.0)
    plain = torch.atan2(plain_sin, plain_cos)[0]  # the frequencies, f32
    got = inv.to(torch.float32)
    torch.testing.assert_close(got[:10], plain[:10], rtol=2e-7, atol=0)
    torch.testing.assert_close(got[23:], plain[23:] / 40, rtol=2e-7, atol=0)
    assert torch.all(got[10:23] <= plain[10:23])
    assert torch.all(got[10:23] >= plain[10:23] / 40)
    # the program's config gives the same scale and the same device tables
    cfg = ADAPTER.program_config(dict(PUBLISHED, name="published"))
    assert cfg.attn_scale == 192 ** -0.5 * want_softmax
    assert cfg.attn_scale / cfg.mla.scale == pytest.approx(1.5896, abs=1e-4)
    small = dataclasses.replace(DS.SMOKE, rope_scaling=YARN, mla=cfg.mla)
    model = T.init(small, torch.Generator().manual_seed(0))
    for lp in model.layers:
        assert lp.rope_inv.dtype == torch.float32
        assert torch.equal(lp.rope_inv, want_inv.to(torch.float32))


@pytest.mark.parametrize("mscale,all_dim", [(1.0, 0.707), (0.707, 0.0),
                                            (0.9, 0.4)])
def test_mscale_apart_from_all_dim_scales_cos_and_sin(mscale, all_dim):
    group = dict(YARN, mscale=mscale, mscale_all_dim=all_dim)
    inv, cos_sin, softmax = layers.yarn_rope(64, 10000.0, group)
    want_inv, want_cos_sin, want_softmax = REF.rope_tables(
        dict(PUBLISHED, rope_scaling=group))
    assert torch.equal(inv, want_inv)
    assert cos_sin == want_cos_sin != 1.0
    assert softmax == want_softmax
    x = torch.randn(1, 3, 50, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(50)[None]
    got = layers.apply_rope(x, pos, 10000.0, inv.to(torch.float32), cos_sin)
    want = lm_ref.rope(x[0].transpose(0, 1), pos[0], 10000.0, want_inv) \
        * want_cos_sin
    torch.testing.assert_close(got[0].transpose(0, 1), want, rtol=0,
                               atol=2e-5 * float(want.abs().max()))


# ---------------------------------------------------------------- (c)

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _rope_table_before_yarn(positions, head_dim, base):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(base), exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.sin(angles), torch.cos(angles)


@pytest.mark.parametrize("base", [10_000.0, 1_000_000.0])
def test_no_rope_scaling_keeps_todays_bits_and_ops(base):
    pos = torch.arange(2050)[None].expand(2, 2050)
    with _Ops() as today:
        want = _rope_table_before_yarn(pos, 128, base)
    with _Ops() as now:
        got = layers.rope_table(pos, 128, base)
    assert now.names == today.names
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.randn(2, 4, 2050, 128, generator=torch.Generator()
                    .manual_seed(2)).to(torch.bfloat16)
    sin, cos = want
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    plain = torch.cat([x1 * cos[:, None] - x2 * sin[:, None],
                       x2 * cos[:, None] + x1 * sin[:, None]], dim=-1)
    assert torch.equal(layers.apply_rope(x, pos, base),
                       plain.to(torch.bfloat16))
    cfg = DS.SMOKE
    assert cfg.rope_scaling is None and cfg.yarn is None
    assert cfg.attn_scale == cfg.mla.scale
    model = T.init(cfg, torch.Generator().manual_seed(0))
    assert all(lp.rope_inv is None for lp in model.layers)


# ---------------------------------------------------------------- (d), (e)

def test_lm_matches_the_yarn_reference_in_float32(case):
    cfg, w, seq, want = case
    gaps = _gaps(_model(cfg, w), seq, want)
    assert max(gaps.values()) <= REL_TOL, gaps


@pytest.mark.parametrize("fault", ["plain_rope", "scale_without_mscale2"])
def test_faults_fail_the_tolerance(case, fault, monkeypatch):
    cfg, w, seq, want = case
    if fault == "plain_rope":
        model = _model(dict(cfg, rope_scaling=None), w)
    else:
        monkeypatch.setattr(T.LMConfig, "attn_scale",
                            property(lambda self: self.mla.scale))
        model = _model(cfg, w)
    gaps = _gaps(model, seq, want)
    assert min(gaps.values()) > REL_TOL, gaps


# ---------------------------------------------------------------- (f)

def test_config_with_the_group_is_hashable_and_comparable():
    cfg = dataclasses.replace(DS.FULL, rope_scaling=dict(YARN))
    copy = dataclasses.replace(cfg)
    assert cfg == copy and hash(cfg) == hash(copy)
    assert {cfg: 1}[copy] == 1
    assert dict(cfg.rope_scaling) == YARN
    assert cfg != dataclasses.replace(cfg, rope_scaling=None)


@pytest.mark.parametrize("arch,group", [
    ("deepseek-v2-lite-16b", dict(YARN, type="linear")),
    ("deepseek-v2-lite-16b", {"factor": 8.0, "rope_type": "dynamic"}),
    ("llama3.2-3b", YARN),
    ("qwen3-moe-30b-a3b", YARN),
])
def test_unimplemented_rope_scaling_raises_naming_the_key(arch, group):
    cfg = configs.get(arch).smoke_config
    with pytest.raises(ValueError, match="rope_scaling"):
        dataclasses.replace(cfg, rope_scaling=group)


# ---------------------------------------------------------------- (g)

@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "prefill_unpadded"),  # FULL's heads: the 192/128 design
    (torch.float32, "prefill_padded"),
])
def test_mla_counts_one_bump_a_layer_call(dtype, route):
    mcfg = DS.FULL.mla
    params = {k: v.to(dtype) if v.dim() == 2 else v for k, v in mla.init(
        torch.Generator().manual_seed(0), mcfg, 64, 2).items()}
    x = torch.randn(1, 9, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(9)[None]
    mla.reset_counts()
    mla.apply(params, x.to(dtype), mcfg, 2, pos, 10_000.0)
    assert mla.counts == {"prefill_unpadded": 0, "prefill_padded": 0,
                          "decode_absorbed": 0, route: 1}
    c_kv = torch.zeros(1, 12, mcfg.kv_lora_rank, dtype=dtype)
    k_rope = torch.zeros(1, 1, 12, mcfg.rope_head_dim, dtype=dtype)
    for n in (10, 11):
        mla.decode_absorbed(params, x[:, :1].to(dtype), mcfg, 2, c_kv,
                            k_rope, torch.tensor([n]),
                            torch.tensor([[n - 1]]), 10_000.0)
    assert mla.counts["decode_absorbed"] == 2 and mla.counts[route] == 1


@pytest.fixture(scope="module")
def rag():
    docs, _ = make_corpus(n_docs=24, n_entities=2, seed=11)
    kb = KnowledgeBase(dim=256)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    cfg = dataclasses.replace(DS.SMOKE, rope_scaling=YARN)
    model = T.init(cfg, torch.Generator().manual_seed(0))
    return RAGPipeline(kb, model, cfg, max_context_tokens=96,
                       engine=QueryEngine(kb, device="cpu"))


@pytest.mark.parametrize("n_tokens", [1, 3])
def test_generate_span_carries_the_route_counts(rag, n_tokens):
    question = "invoice payment schedule"
    results = rag.engine.query_batch([question], k=3)[0]
    layers_n = rag.cfg.n_layers
    tracer = obs_trace.get()
    tracer.drain()
    obs_trace.enable()
    try:
        traced = rag.generate(question, results, n_tokens)
        spans = tracer.drain()
    finally:
        obs_trace.disable()
    (gen,) = [s for s in spans if s.name == "generate"]
    # SMOKE's 24/16 heads have no flash design: every prefill layer pads
    assert gen.args["mla_prefill_padded"] == layers_n
    assert gen.args["mla_prefill_unpadded"] == 0
    assert gen.args["mla_decode_layers"] == layers_n * n_tokens
    decode_steps = [s for s in spans if s.name == "step_launch"
                    and s.args.get("step") == "decode"]
    assert gen.args["mla_decode_layers"] == layers_n * len(decode_steps)
    before = dict(mla.counts)
    plain = rag.generate(question, results, n_tokens)
    assert len(tracer) == 0
    assert plain.token_ids == traced.token_ids
    assert mla.counts["decode_absorbed"] - before["decode_absorbed"] \
        == layers_n * n_tokens
