"""The port's generation plane (`models/`, `configs/`, `core/rag.py`)
against the JAX package's, on the CPU.

Weights are the JAX package's own ``T.init(PRNGKey(0), cfg)``, carried
across with ``params_from_numpy``.  Logits are compared scaled by their
largest magnitude at 5e-4, the tolerance `tests/test_models_lm.py` holds
the reference's own prefill/decode to (f32, summation order).  The
SMOKE configs of the five LM archs cover GQA, the sliding window and
its ring cache, both softcaps, qk-norm, sandwich norms, embedding and
query scales (llama3.2-3b, gemma2-9b, gemma3-27b), MoE routing with and
without renormalised gates and shared experts (qwen3-moe-30b-a3b,
deepseek-v2-lite-16b) and MLA with its compressed cache and absorbed
decode (deepseek-v2-lite-16b).  End to end, the port's ``RAGPipeline``
on the CPU serves the same doc ids, scores and greedy tokens as the JAX
package's on one container, with each arch as its generator."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.ingest import KnowledgeBase as RefKB
from repro.core.rag import RAGPipeline as RefRAG
from repro.core.rag import text_to_tokens as ref_text_to_tokens
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.core.engine import QueryEngine
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.rag import RAGPipeline, text_to_tokens
from repro_torch.data.corpus import make_corpus
from repro_torch.models import layers, transformer as T

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

LM_ARCHS = [a for a, s in ref_configs.ARCHS.items() if s.family == "lm"]
TOL = 5e-4


def port_config(rc) -> T.LMConfig:
    """The JAX package's config, field by field, as the port's."""
    fields = {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)}
    if rc.moe is not None:
        fields["moe"] = T.MoEConfig(**dataclasses.asdict(rc.moe))
    if rc.mla is not None:
        fields["mla"] = T.MLAConfig(**dataclasses.asdict(rc.mla))
    return T.LMConfig(**fields)


# the reference's entry points, compiled once per config and shape
_ref_forward = jax.jit(RT.forward, static_argnums=(2,))
_ref_prefill = jax.jit(RT.prefill, static_argnums=(2, 3))
_ref_decode = jax.jit(RT.decode_step, static_argnums=(4,))


@functools.cache
def _carried(arch):
    """(JAX config, JAX params, port config, port model)."""
    rc = ref_configs.ARCHS[arch].smoke_config
    params = jax.jit(RT.init, static_argnums=(1,))(jax.random.PRNGKey(0), rc)
    cfg = port_config(rc)
    model = T.params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    return rc, params, cfg, model


@pytest.fixture(params=LM_ARCHS)
def carried(request):
    return _carried(request.param)


def _close(got, want, label=""):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=TOL, err_msg=label)


def _close_caches_flat(caches, ref_caches, cfg, slots, label):
    """Every layer's cache entries against the reference's pytree (head,
    scan units stacked per pattern position, tail), the first ``slots``
    slots of a cache that holds the whole horizon; a ring (fewer slots)
    whole."""
    nh, p = cfg.n_dense_head_layers, len(cfg.pattern)
    for i, c in enumerate(caches):
        if i < nh:
            ref = ref_caches["head"][i]
        elif i < nh + cfg.n_units * p:
            u, j = divmod(i - nh, p)
            ref = {n: t[u] for n, t in ref_caches["scan"][f"l{j}"].items()}
        else:
            ref = ref_caches["tail"][i - nh - cfg.n_units * p]
        assert set(c) == set(ref), (i, sorted(c))
        for name, t in c.items():
            got, want = T.slots_view(t), T.slots_view(
                torch.tensor(np.asarray(ref[name])))
            n = min(slots, got.shape[2])
            _close(got[:, :, :n].numpy(), want[:, :, :n].numpy(),
                   f"{label} layer {i} {name}")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm_matches_jax(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    w = rng.normal(size=(32,)).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                          unit_offset=unit_offset)
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(w),
                       unit_offset=unit_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got = layers.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("base", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(base):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(100, 140)]).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), base)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_apply_matches_jax(activation):
    """gelu is the tanh approximation on both sides."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    p = {name: rng.normal(size=shape).astype(np.float32) * 0.2
         for name, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                             ("w_down", (64, 32)))}
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), activation=activation)
    want = RL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ring_slot_positions_floor_divide_like_jax():
    lengths = np.array([0, 1, 5, 16, 17, 40], np.int32)
    for n_slots in (1, 7, 16):
        got = T._ring_slot_positions(n_slots, torch.from_numpy(lengths))
        want = RT._ring_slot_positions(n_slots, jnp.asarray(lengths))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got < 0).any() or n_slots == 1
    seq = torch.arange(30, dtype=torch.float32).view(1, 1, 30, 1)
    got = T._fill_cache_from_seq(seq, 16, 30)
    want = RT._fill_cache_from_seq(jnp.asarray(seq.numpy()), 16, 30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the whole model, with the reference's weights
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_jax(carried):
    rc, params, cfg, model = carried
    b, l, max_len = 2, 31, 40
    toks = _tokens(cfg.vocab, (b, l), seed=cfg.n_layers)
    want_full, want_aux = _ref_forward(params, jnp.asarray(toks), rc)
    got_full, aux = T.forward(model, torch.from_numpy(toks), cfg)
    assert got_full.shape == (b, l, cfg.vocab)
    _close(got_full.numpy(), want_full, f"{cfg.name} forward")
    # the summed MoE load-balance loss (0 without MoE layers)
    assert (float(aux) == 0.0) == (cfg.moe is None)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6)

    want_pre, ref_caches, ref_lengths = _ref_prefill(
        params, jnp.asarray(toks[:, :l - 2]), rc, max_len)
    got_pre, caches, lengths = T.prefill(
        model, torch.from_numpy(toks[:, :l - 2]), cfg, max_len)
    _close(got_pre.numpy(), want_pre, f"{cfg.name} prefill")
    if cfg.window is not None:  # local layers keep a window-sized ring
        local = cfg.layer_kinds.index("local")
        assert caches[local]["k"].shape[2] == cfg.window
    _close_caches_flat(caches, ref_caches, cfg, l - 2, f"{cfg.name} prefill")
    for t in range(l - 2, l):
        lengths, ref_lengths = lengths + 1, ref_lengths + 1
        logits, caches = T.decode_step(
            model, caches, torch.from_numpy(toks[:, t:t + 1]), lengths, cfg)
        want, ref_caches = _ref_decode(params, ref_caches,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       ref_lengths, rc)
        _close(logits[:, 0].numpy(), np.asarray(want)[:, 0],
               f"{cfg.name} decode step {t}")
        _close(logits[:, 0].numpy(), np.asarray(want_full)[:, t],
               f"{cfg.name} decode step {t} against forward")
    _close_caches_flat(caches, ref_caches, cfg, l, f"{cfg.name} decode")


def test_port_prefill_plus_decode_equals_port_forward(carried):
    _, _, cfg, model = carried
    b, l = 1, 30
    toks = torch.from_numpy(_tokens(cfg.vocab, (b, l + 3), seed=7))
    full, _ = T.forward(model, toks, cfg)
    pre, caches, lengths = T.prefill(model, toks[:, :l], cfg, l + 3)
    _close(pre[:, -1].numpy(), full[:, l - 1].numpy())
    for t in range(l, l + 3):
        lengths = lengths + 1
        logits, caches = T.decode_step(model, caches, toks[:, t:t + 1],
                                       lengths, cfg)
        _close(logits[:, 0].numpy(), full[:, t].numpy(), f"step {t}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_init_draws_the_reference_shapes_and_dtypes(arch):
    cfg = dataclasses.replace(configs.get(arch).smoke_config,
                              dtype="bfloat16")
    a = T.init(cfg, torch.Generator().manual_seed(0))
    b = T.init(cfg, torch.Generator().manual_seed(0))
    n = 0
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
        leaf = name.rsplit(".", 1)[-1]
        want = torch.bfloat16 if leaf in T._MATRICES else torch.float32
        assert pa.dtype == want and not pa.requires_grad, name
        n += pa.numel()
    assert n == cfg.param_count()
    # the bf16 model runs the plain paths on the CPU
    toks = torch.from_numpy(_tokens(cfg.vocab, (1, 12), seed=3))
    logits, _ = T.forward(a, toks, cfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_param_counts_match_jax(arch):
    spec = ref_configs.ARCHS[arch]
    for rc in (spec.config, spec.smoke_config):
        cfg = port_config(rc)
        assert cfg.param_count() == rc.param_count()
        assert cfg.active_param_count() == rc.active_param_count()
        assert (cfg.active_param_count() < cfg.param_count()) == \
            (cfg.moe is not None)
        assert cfg.layer_kinds == (
            (rc.pattern[0],) * rc.n_dense_head_layers
            + rc.pattern * rc.n_units + rc.tail_kinds)
        assert cfg.attn_scale == rc.attn_scale


PORTED = list(ref_configs.ARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_registered_config_equals_jax(arch):
    """FULL and SMOKE field for field (the LM configs' MoE and MLA parts
    too), from the port's own config module."""
    spec, ref = configs.get(arch), ref_configs.get(arch)
    assert spec.family == ref.family
    assert spec.module == f"repro_torch.configs.{ref.module.split('.')[-1]}"
    for name in ("config", "smoke_config"):
        got, want = getattr(spec, name), getattr(ref, name)
        if spec.family == "lm":
            assert got == port_config(want)
            assert isinstance(got, T.LMConfig)
        else:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert type(got).__module__.startswith("repro_torch.")


def test_registry_resolves_every_arch_to_the_port():
    """Every arch of the JAX package's registry resolves to a config
    module of the port, llama3.2-3b's configs equal to the JAX
    package's, and an unknown arch raises KeyError."""
    for name in ("config", "smoke_config"):
        got = getattr(configs.get("llama3.2-3b"), name)
        want = getattr(ref_configs.get("llama3.2-3b"), name)
        assert got == port_config(want)
    assert configs.get("llama3.2-3b").config.compute_dtype == torch.bfloat16
    assert set(configs.ARCHS) == set(ref_configs.ARCHS)
    for arch in configs.ARCHS:
        assert configs.get(arch).module.startswith("repro_torch.")
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


def test_init_cache_shapes_follow_the_layer_kinds():
    cfg = port_config(ref_configs.ARCHS["gemma3-27b"].smoke_config)
    caches = T.init_cache(cfg, 2, 40)
    assert len(caches) == cfg.n_layers
    for kind, c in zip(cfg.layer_kinds, caches):
        s = cfg.window if kind == "local" else 40
        assert c["k"].shape == c["v"].shape == (2, cfg.n_kv_heads, s, 16)
        assert c["k"].dtype == torch.float32 and not c["k"].any()


def test_mla_cache_is_the_compressed_latent_and_rope_key():
    cfg = port_config(ref_configs.ARCHS["deepseek-v2-lite-16b"].smoke_config)
    caches = T.init_cache(cfg, 2, 40)
    want = RT.init_cache(ref_configs.ARCHS["deepseek-v2-lite-16b"]
                         .smoke_config, 2, 40)
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert set(c) == {"c_kv", "k_rope"}
        assert c["c_kv"].shape == want["head"][0]["c_kv"].shape == (2, 40, 32)
        assert c["k_rope"].shape == want["head"][0]["k_rope"].shape \
            == (2, 1, 40, 8)
        assert T.slots_view(c["c_kv"]).shape == (2, 1, 40, 32)
        assert not any(t.any() for t in c.values())


# ---------------------------------------------------------------------------
# end to end: retrieval + generation
# ---------------------------------------------------------------------------

def _greedy_agrees(params, rc, prompt, want, got):
    """Equal token ids, except that from the first step where the JAX
    logits' top two lie within tolerance either token is accepted (the
    sequences may then part)."""
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        seq = jnp.asarray([prompt + want[:i]], jnp.int32)
        logits = np.asarray(_ref_forward(params, seq, rc)[0][0, -1])
        top2 = np.sort(logits)[-2:]
        scale = np.abs(logits).max()
        return (top2[1] - top2[0]) <= TOL * scale and \
            logits[g] >= top2[1] - TOL * scale
    return len(want) == len(got)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rag_pipeline_matches_jax_end_to_end(tmp_path, arch):
    docs, entities = make_corpus(n_docs=40, n_entities=3, seed=5)
    kb = KnowledgeBase(dim=512)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    path = str(tmp_path / "kb.ragdb")
    kb.save(path)
    kb, ref_kb = KnowledgeBase.load(path), RefKB.load(path)

    rc, params, cfg, model = _carried(arch)
    assert cfg == configs.get(arch).smoke_config
    rag = RAGPipeline(kb, model, cfg,
                      engine=QueryEngine(kb, device="cpu"))
    ref = RefRAG(ref_kb, params, rc)
    questions = [next(iter(entities)), "invoice payment schedule"]
    got = rag.answer_batch(questions, max_new_tokens=4, top_k_docs=3)
    want = ref.answer_batch(questions, max_new_tokens=4, top_k_docs=3)
    for q, g, w in zip(questions, got, want):
        assert [(r.doc_id, r.score, r.boosted) for r in g.retrieved] == \
            [(r.doc_id, r.score, r.boosted) for r in w.retrieved], q
        prompt = rag._pack_context(g.retrieved) + text_to_tokens(q, cfg.vocab)
        assert prompt == ref._pack_context(w.retrieved) + ref_text_to_tokens(
            q, rc.vocab)
        assert g.prompt_len == w.prompt_len == len(prompt[-512:])
        assert len(g.token_ids) == 4 and g.prefill_s > 0 and g.decode_s > 0
        assert _greedy_agrees(params, rc, prompt[-512:], w.token_ids,
                              g.token_ids), (q, w.token_ids, g.token_ids)
    code, doc = next(iter(entities.items()))
    assert got[0].retrieved[0].doc_id == f"doc_{doc:05d}.txt"


def test_rag_pipeline_checks_its_engine():
    cfg = configs.get("llama3.2-3b").smoke_config
    model = T.init(cfg, torch.Generator().manual_seed(0))
    kb = KnowledgeBase(dim=256)
    kb.add_text("a.txt", "alpha beta")
    other = KnowledgeBase(dim=256)
    with pytest.raises(ValueError, match="different KnowledgeBase"):
        RAGPipeline(kb, model, cfg, engine=QueryEngine(other, device="cpu"))
    rag = RAGPipeline(kb, model, cfg)  # builds its engine on the model's device
    assert rag.engine.device.type == "cpu"
    out = rag.answer("alpha", max_new_tokens=2, top_k_docs=1)
    assert out.retrieved[0].doc_id == "a.txt" and len(out.token_ids) == 2
    empty = rag.generate("", [], 1)  # no context, no question: token 0
    assert empty.prompt_len == 1
