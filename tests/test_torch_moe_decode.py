"""The MoE decode layer (`kernels/moe_decode`) on the CPU, and on a card.

Its plain version (``ref.py``) is ``moe.route`` + ``moe.dispatch`` without
the aux loss: on the CPU it gives their bits at qwen3-moe's routing (128
experts, top 8, renormalised gates) and deepseek-v2-lite's (64, top 6,
raw gates) at small widths, T = 1, 2 and 4, with ``norm_topk`` on and
off.  The kernel's arithmetic (per slot: gate and up products summed in
f32 and rounded to bf16, SiLU and the product rounded to bf16, the down
product rounded, gated and rounded, the slots summed in f32 in order and
rounded once) written out in PyTorch is held to the grouped path within
2^-8 of the output's largest magnitude (0 read).  Exact ties in the router's
probabilities go to the lower expert id.

The decode step routes the operands the kernel has a design for to the
wrapper (on CPU tensors it runs ``ref.py`` and counts ``plain``), the
rest to ``moe.route`` + ``moe.dispatch``, with the same bits, and neither
computes the aux loss; a SMOKE decode step both ways agrees with the JAX
package's.  The ``generate`` span carries ``moe_decode_layers`` for MoE
models.  Tests marked ``card`` hold the CUDA kernel to ``ref.py`` at both
benchmark models' full widths and a graph replay to the eager bits; they
skip on a host without a CUDA device.  This file imports no JAX at its
top (the card's host has none): the JAX comparison imports it itself.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_v2_lite_16b as DS
from repro_torch.configs import llama3_2_3b as LL
from repro_torch.configs import qwen3_moe_30b_a3b as QW
from repro_torch.core.engine import QueryEngine
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.rag import RAGPipeline
from repro_torch.data.corpus import make_corpus
from repro_torch.kernels import counters
from repro_torch.kernels.moe_decode import ops, ref
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace

torch.set_num_threads(1)

# (n_experts, top_k, d_ff_expert, norm_topk): the two benchmark models'
# routing; small widths on the CPU, the published ones on a card
SHAPES = {"qwen3": (128, 8, 768, True), "deepseek": (64, 6, 1408, False)}
FULL_D = 2048


def _cfg(name, norm_topk=None, f=None):
    e, k, full_f, norm = SHAPES[name]
    return moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f or full_f,
                         norm_topk=norm if norm_topk is None else norm_topk)


def _params(cfg, d, seed, device="cpu", dtype=torch.bfloat16):
    """A layer's routed experts as the serving model holds them: bf16
    experts (``moe.init``'s distributions), a float32 router; no shared
    experts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe.init(gen, cfg, d, device=device)
    params.pop("shared", None)
    return {n: (w if n == "router" else w.to(dtype))
            for n, w in params.items()}


def _x(t, d, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def kernel_arithmetic(x, params, cfg):
    """The kernel's roundings over ``moe.route``'s choice, one (token,
    slot) at a time, in float32 (bf16 where the kernel rounds)."""
    _, gates, ids = moe.route(params, x, cfg)
    xf = x.float()
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(ids[t, j])
            g = _bf16(xf[t] @ params["w_gate"][e].float())
            u = _bf16(xf[t] @ params["w_up"][e].float())
            h = _bf16(_bf16(g / (1 + torch.exp(-g))) * u)
            y = _bf16(h @ params["w_down"][e].float())
            out[t] += _bf16(y * _bf16(gates[t, j]))
    return out.to(x.dtype)


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ref_is_route_and_dispatch(name, t, norm_topk):
    cfg = _cfg(name, norm_topk, f=128)
    params = _params(cfg, 64, seed=t)
    x = _x(t, 64, seed=10 + t)
    _, gates, ids = moe.route(params, x, cfg)
    want = moe.dispatch(x, ids, gates, params, cfg)
    got = ref.moe_decode_ref(x, params, cfg)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    before = dict(ops.counts)
    assert torch.equal(ops.moe_decode(x, params, cfg), want)
    assert ops.counts == {"launches": before["launches"],
                          "plain": before["plain"] + 1}
    # the kernel's roundings land within 2^-8 of the output's scale
    scale = want.float().abs().max()
    err = (kernel_arithmetic(x, params, cfg).float() - want.float()).abs()
    assert err.max() <= scale * 2 ** -8, float(err.max() / scale)


def _tied(params, d, x_rows):
    """Experts 3, 9, 17 and 40 share one router column and 5 and 6 another,
    of powers of two, and x is all ones (times ``x_rows``): their logits
    are exact in any summation order (16 and 8 at D = 2,048; 32 and 16 at
    64), above every other expert's."""
    router = params["router"]
    for e in (3, 9, 17, 40):
        router[:, e] = 2.0 ** -7 if d > 64 else 0.5
    for e in (5, 6):
        router[:, e] = 2.0 ** -8 if d > 64 else 0.25
    ones = torch.ones((len(x_rows), d), device=router.device)
    return (ones * torch.tensor(x_rows, device=router.device)[:, None]) \
        .to(torch.bfloat16)


def test_exact_ties_go_to_the_lower_expert_id():
    """Equal probabilities are chosen in id order, as a stable descending
    sort and ``jax.lax.top_k`` choose them."""
    cfg = _cfg("qwen3", f=64)
    params = _params(cfg, 64, seed=2)
    x = _tied(params, 64, [1.0, 1.0])
    probs, gates, ids = moe.route(params, x, cfg)
    for t in range(2):
        assert ids[t, :6].tolist() == [3, 9, 17, 40, 5, 6]
        assert len(set(probs[t, [3, 9, 17, 40]].tolist())) == 1
        order = sorted(range(cfg.n_experts),
                       key=lambda e: (-float(probs[t, e]), e))
        assert ids[t].tolist() == order[:cfg.top_k]
    assert torch.equal(ref.moe_decode_ref(x, params, cfg),
                       moe.dispatch(x, ids, gates, params, cfg))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_non_finite_row_routes_to_the_first_experts(bad):
    """A NaN or inf in a token's row makes all its probabilities NaN; the
    stable sort ranks NaN above every number, so the token goes to experts
    0 .. k-1 with NaN gates and a NaN output row, and the other tokens
    are as with that row zeroed.  The kernel's rank keeps this order (NaN as 2, above every
    probability), so its ids always lie in [0, E)."""
    cfg = _cfg("deepseek", f=64)
    params = _params(cfg, 64, seed=6)
    x = _x(3, 64, seed=7)
    x[1, 5] = bad
    probs, gates, ids = moe.route(params, x, cfg)
    assert torch.isnan(probs[1]).all()
    assert ids[1].tolist() == list(range(cfg.top_k))
    assert torch.isnan(gates[1]).all()
    got = ref.moe_decode_ref(x, params, cfg)
    assert torch.isnan(got[1]).all()
    rest, clean = [0, 2], x.clone()
    clean[1] = 0
    assert torch.equal(got[rest], ref.moe_decode_ref(clean, params, cfg)[rest])


def _design_case(**change):
    """(x, params, cfg) of a qwen3-routed layer the kernel takes, with
    ``change`` applied: x_dtype, w_dtype, router_dtype, t, d, f, e, k."""
    e = change.get("e", 128)
    cfg = moe.MoEConfig(n_experts=e, top_k=change.get("k", 8),
                        d_ff_expert=change.get("f", 128))
    d = change.get("d", 64)
    params = _params(cfg, d, seed=0, dtype=change.get("w_dtype",
                                                      torch.bfloat16))
    params["router"] = params["router"].to(change.get("router_dtype",
                                                      torch.float32))
    x = _x(change.get("t", 1), d, seed=1).to(change.get("x_dtype",
                                                         torch.bfloat16))
    return x, params, cfg


DESIGN_TABLE = {
    "designed": ({}, True),
    "t at the threshold": ({"t": ops.MAX_TOKENS}, True),
    "t above the threshold": ({"t": ops.MAX_TOKENS + 1}, False),
    "deepseek's routing": ({"e": 64, "k": 6}, True),
    "x float32": ({"x_dtype": torch.float32}, False),
    "x float16": ({"x_dtype": torch.float16}, False),
    "experts float32": ({"w_dtype": torch.float32}, False),
    "router bf16": ({"router_dtype": torch.bfloat16}, False),
    "d not a tile multiple": ({"d": 96}, False),
    "f not a tile multiple": ({"f": 32}, False),
    "e not a multiple of 4": ({"e": 126}, False),
    "e above 256": ({"e": 260}, False),
    "k above 8": ({"k": 9}, False),
}


@pytest.mark.parametrize("case", sorted(DESIGN_TABLE))
def test_has_design_truth_table(case):
    change, want = DESIGN_TABLE[case]
    assert ops.has_design(*_design_case(**change)) is want


def test_has_design_refuses_what_autograd_would_record():
    x, params, cfg = _design_case()
    assert ops.has_design(x.requires_grad_(), params, cfg) is False
    with torch.no_grad():
        assert ops.has_design(x, params, cfg) is True
    x, params, cfg = _design_case()
    params["w_up"].requires_grad_()
    assert ops.has_design(x, params, cfg) is False
    with torch.no_grad():
        assert ops.has_design(x, params, cfg) is True
    # the SMOKE configs' widths (and dtype) take the grouped path
    for smoke in (QW.SMOKE, DS.SMOKE):
        m = smoke.moe
        params = _params(m, smoke.d_model, seed=0)
        assert ops.has_design(_x(1, smoke.d_model, seed=1), params,
                              m) is False


def test_counts_and_replayed_counts():
    """A call on CPU tensors counts ``plain``; a captured step's replays
    (``counters.recording`` + ``tally``/``add``, as ``CapturedStep``
    counts them) add what the captured pass counted."""
    x, params, cfg = _design_case(t=2)
    ops.reset_counts()
    with counters.recording() as records:
        ops.moe_decode(x, params, cfg)
        ops.moe_decode(x, params, cfg)
    assert ops.counts == {"launches": 0, "plain": 2}
    assert counters.tally(records) == {("moe_decode", "plain"): 2}
    counters.add(counters.tally(records, times=3))  # three replays
    assert ops.counts == {"launches": 0, "plain": 8}
    ops.reset_counts()
    assert ops.counts == {"launches": 0, "plain": 0}


def _bf16_moe_config(**kw):
    """A qwen3-like bf16 config whose MoE widths the kernel tiles."""
    base = dict(name="moe-bf16", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, qk_norm=True,
                tie_embeddings=False, dtype="bfloat16",
                moe=moe.MoEConfig(n_experts=32, top_k=4, d_ff_expert=64))
    return T.LMConfig(**{**base, **kw})


@pytest.mark.parametrize("shared", [0, 2])
def test_decode_step_routes_designed_layers_to_the_wrapper(shared,
                                                           monkeypatch):
    cfg = _bf16_moe_config(moe=moe.MoEConfig(n_experts=32, top_k=4,
                                             d_ff_expert=64, n_shared=shared,
                                             norm_topk=not shared))
    model = T.init(cfg, torch.Generator().manual_seed(3))
    tokens = torch.tensor([[3, 7, 11, 5, 9, 2], [1, 4, 4, 8, 30, 6]])
    _, caches, lengths = T.prefill(model, tokens, cfg, max_len=12)
    tok, lengths = torch.tensor([[4], [9]]), lengths + 1

    calls, aux_calls = [], []
    wrapper = ops.moe_decode

    def spy(x, params, m):
        calls.append(tuple(x.shape))
        return wrapper(x, params, m)

    monkeypatch.setattr(ops, "moe_decode", spy)
    monkeypatch.setattr(moe, "aux_loss",
                        lambda *a, **kw: aux_calls.append(1))
    routed = [{k: v.clone() for k, v in c.items()} for c in caches]
    before = dict(ops.counts)
    got, _ = T.decode_step(model, routed, tok, lengths, cfg)
    assert calls == [(2, cfg.d_model)] * cfg.n_layers
    assert ops.counts["plain"] == before["plain"] + cfg.n_layers
    assert ops.counts["launches"] == before["launches"]
    assert aux_calls == []  # decode computes no aux loss

    # the grouped path (no design) gives the wrapper's plain version's bits
    monkeypatch.setattr(ops, "has_design", lambda *a, **kw: False)
    want, _ = T.decode_step(model, caches, tok, lengths, cfg)
    assert len(calls) == cfg.n_layers and aux_calls == []
    assert torch.equal(got, want)


def test_prefill_and_training_keep_the_grouped_path(monkeypatch):
    """Prefill and the forward (training's) call ``moe.apply`` and its aux
    loss as before, never the wrapper."""
    cfg = _bf16_moe_config()
    model = T.init(cfg, torch.Generator().manual_seed(4))
    monkeypatch.setattr(ops, "moe_decode", lambda *a: pytest.fail(
        "prefill reached the MoE decode wrapper"))
    tokens = torch.tensor([[3, 7, 11, 5]])
    T.prefill(model, tokens, cfg, max_len=8)
    with torch.no_grad():
        _, aux = T.forward(model, tokens, cfg)
    assert float(aux) > 0.0


def _port_config(rc) -> T.LMConfig:
    fields = {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)}
    fields["moe"] = T.MoEConfig(**dataclasses.asdict(rc.moe))
    if rc.mla is not None:
        fields["mla"] = T.MLAConfig(**dataclasses.asdict(rc.mla))
    return T.LMConfig(**fields)


def _close(got, want, tol, label=""):
    """``tests/test_torch_moe_mla.py``'s comparison: within ``tol`` of the
    largest magnitude."""
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=tol, rtol=0, err_msg=label)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
def test_smoke_decode_step_with_and_without_the_route_matches_jax(
        arch, monkeypatch):
    """A SMOKE decode step (float32) sent through the wrapper (its plain
    version on the CPU) and through the grouped path: the same bits, and
    the JAX package's decode step's logits within ``tests/test_torch_lm``'s
    5e-4 of their largest magnitude; the MoE layer alone at T = 1 and 2
    within ``tests/test_torch_moe_mla``'s 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import moe as ref_moe
    from repro.models import transformer as RT

    rc = ref_configs.ARCHS[arch].smoke_config
    params = jax.jit(RT.init, static_argnums=(1,))(jax.random.PRNGKey(0), rc)
    cfg = _port_config(rc)
    model = T.params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    _, ref_caches, ref_lengths = RT.prefill(params, jnp.asarray(toks[:, :8]),
                                            rc, 12)
    _, caches, lengths = T.prefill(model, torch.from_numpy(toks[:, :8]), cfg,
                                   12)
    want, _ = RT.decode_step(params, ref_caches, jnp.asarray(toks[:, 8:]),
                             ref_lengths + 1, rc)
    tok = torch.from_numpy(toks[:, 8:])

    monkeypatch.setattr(ops, "has_design", lambda *a, **kw: True)
    routed = [{k: v.clone() for k, v in c.items()} for c in caches]
    before = ops.counts["plain"]
    got, _ = T.decode_step(model, routed, tok, lengths + 1, cfg)
    n_moe = sum(lp.moe for lp in model.layers)
    assert ops.counts["plain"] == before + n_moe
    monkeypatch.setattr(ops, "has_design", lambda *a, **kw: False)
    plain, _ = T.decode_step(model, caches, tok, lengths + 1, cfg)
    assert torch.equal(got, plain)
    _close(got[:, 0].numpy(), np.asarray(want)[:, 0], 5e-4, arch)

    layer = next(lp for lp in model.layers if lp.moe)
    ref_layer = {k: jnp.asarray(v.detach().numpy())
                 for k, v in layer.mlp.tree().items() if k != "shared"}
    m = dataclasses.replace(rc.moe, n_shared=0)
    for t in (1, 2):
        x = np.random.default_rng(t).normal(size=(t, rc.d_model)) \
            .astype(np.float32)
        layer_want, _ = ref_moe.apply(ref_layer, jnp.asarray(x), m)
        got_layer = ref.moe_decode_ref(torch.from_numpy(x), layer.mlp,
                                       cfg.moe)
        _close(got_layer.numpy(), layer_want, 1e-5, f"{arch} T={t}")


@pytest.fixture(scope="module")
def corpus_kb():
    docs, _ = make_corpus(n_docs=24, n_entities=2, seed=11)
    kb = KnowledgeBase(dim=256)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    return kb


def _traced_generate(rag, question, n_tokens):
    results = rag.engine.query_batch([question], k=3)[0]
    tracer = obs_trace.get()
    tracer.drain()
    obs_trace.enable()
    try:
        rag.generate(question, results, n_tokens)
        spans = tracer.drain()
    finally:
        obs_trace.disable()
    (gen,) = [s for s in spans if s.name == "generate"]
    decodes = [s for s in spans if s.name == "step_launch"
               and s.args.get("step") == "decode"]
    return gen, len(decodes)


@pytest.mark.parametrize("name", ["moe-bf16", "qwen3-smoke", "llama-smoke"])
def test_generate_span_carries_moe_decode_layers(corpus_kb, name):
    """MoE models: the answer's MoE decode layer calls (layers × decode
    steps where the design holds, 0 where it does not: the float32
    SMOKE); dense models: no such arg."""
    cfg = {"moe-bf16": _bf16_moe_config(vocab=512),
           "qwen3-smoke": QW.SMOKE, "llama-smoke": LL.SMOKE}[name]
    model = T.init(cfg, torch.Generator().manual_seed(0))
    rag = RAGPipeline(corpus_kb, model, cfg, max_context_tokens=96,
                      engine=QueryEngine(corpus_kb, device="cpu"))
    gen, decodes = _traced_generate(rag, "invoice payment schedule", 3)
    assert decodes == 3
    if cfg.moe is None:
        assert "moe_decode_layers" not in gen.args
    else:
        n_moe = cfg.n_layers - cfg.n_dense_head_layers
        want = n_moe * decodes if name == "moe-bf16" else 0
        assert gen.args["moe_decode_layers"] == want


# ---------------------------------------------------------------------------
# on a card: the CUDA kernel against ref.py
# ---------------------------------------------------------------------------

# kernel vs ref.py, of the largest |out|: another summation order in the
# products, which can move a bf16 rounding of g, u, h or y by one ulp
CARD_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _full_case(name, t, cuda, seed):
    cfg = _cfg(name)
    params = _params(cfg, FULL_D, seed=seed, device=cuda)
    return _x(t, FULL_D, seed + 1, device=cuda), params, cfg


@pytest.mark.card
@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_card_kernel_matches_ref_at_full_width(cuda, name, t):
    x, params, cfg = _full_case(name, t, cuda, seed=5 + t)
    assert ops.has_design(x, params, cfg)
    before = ops.counts["launches"]
    got, gates, ids = ops._launch(x, params, cfg)
    _, want_gates, want_ids = moe.route(params, x, cfg)
    want = ref.moe_decode_ref(x, params, cfg)
    torch.cuda.synchronize()
    assert ops.counts["launches"] == before + 1
    assert torch.equal(ids.long(), want_ids)
    torch.testing.assert_close(gates, want_gates, rtol=1e-5, atol=1e-7)
    scale = want.float().abs().max()
    err = (got.float() - want.float()).abs().max() / scale
    assert err <= CARD_TOL, float(err)


@pytest.mark.card
def test_card_ties_and_graph_replay(cuda):
    from repro_torch.launch import steps

    x, params, cfg = _full_case("qwen3", 2, cuda, seed=31)
    x = _tied(params, FULL_D, [1.0, 1.0])
    _, _, ids = ops._launch(x, params, cfg)
    _, _, want_ids = moe.route(params, x, cfg)
    assert ids[:, :6].tolist() == [[3, 9, 17, 40, 5, 6]] * 2
    assert torch.equal(ids.long(), want_ids)

    x, params, cfg = _full_case("deepseek", 1, cuda, seed=41)
    fn = lambda xx: ops.moe_decode(xx, params, cfg)  # noqa: E731
    step = steps.CapturedStep(fn, (x.clone(),), "cuda")
    for seed in (42, 43):
        xi = _x(1, FULL_D, seed, device=cuda)
        assert torch.equal(step(xi), fn(xi))


@pytest.mark.card
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_card_non_finite_row_keeps_ids_in_range(cuda, bad):
    """A NaN or inf in one token's row: no fault, every id in [0, E), the
    token routed to experts 0 .. k-1 (as ``moe.route``) with NaN gates and
    a NaN output row; the other tokens as with that row zeroed."""
    x, params, cfg = _full_case("qwen3", 4, cuda, seed=51)
    x[2, 100] = bad
    got, gates, ids = ops._launch(x, params, cfg)
    torch.cuda.synchronize()
    assert ((ids >= 0) & (ids < cfg.n_experts)).all()
    assert ids[2].tolist() == list(range(cfg.top_k))
    assert torch.isnan(gates[2]).all() and torch.isnan(got[2]).all()
    rest, clean = [0, 1, 3], x.clone()
    clean[2] = 0
    want, _, want_ids = ops._launch(clean, params, cfg)
    assert torch.equal(ids[rest], want_ids[rest])
    assert torch.equal(ids[rest].long(),
                       moe.route(params, clean, cfg)[2][rest])
    assert torch.equal(got[rest], want[rest])
    # the card is still usable: a later call runs and matches ref.py
    y, params, cfg = _full_case("qwen3", 1, cuda, seed=52)
    want = ref.moe_decode_ref(y, params, cfg)
    err = (ops.moe_decode(y, params, cfg).float() - want.float()).abs().max()
    assert err <= CARD_TOL * want.float().abs().max()


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_card_many_replays_at_eight_tokens(cuda, name):
    """The down kernel reads ids and gates before its wait on the gate/up
    kernel (see ``moe_decode_launch``): 50 replays of a captured call at
    T = 8, each on a new input, give the eager call's bits."""
    from repro_torch.launch import steps

    x, params, cfg = _full_case(name, 8, cuda, seed=61)
    fn = lambda xx: ops.moe_decode(xx, params, cfg)  # noqa: E731
    step = steps.CapturedStep(fn, (x.clone(),), "cuda")
    for seed in range(62, 112):
        xi = _x(8, FULL_D, seed, device=cuda)
        assert torch.equal(step(xi), fn(xi)), seed
