"""The port's serving steps and cells (`launch/steps.py`) against the
JAX package's, on the CPU, where each step runs eagerly (on the card the
same functions are captured into CUDA graphs and replayed, which
``chip_smoke.py`` holds to the eager steps bit for bit).

- ``make_lm_prefill_step``/``make_lm_decode_step`` against the JAX
  package's steps (``make_host_mesh(1)``, ``jax.jit``) on the SMOKE
  configs of the five LM archs (MoE and MLA included), logits and caches
  within 5e-4 of the largest (``tests/test_torch_lm.py``'s tolerance:
  f32, summation order);
- a right-padded prefill against the unpadded one in the port, ring
  layers, MoE routing of the padding and MLA caches included (window
  16, prompts of 30 and 17 padded to 64);
- ``GenerationSteps`` over GQA, MoE and MLA caches;
- ``build_cell`` against the JAX package's cell ``fn`` on the same
  concrete arrays (llama3.2-3b, qwen3-moe-30b-a3b and
  deepseek-v2-lite-16b SMOKE prefill_32k and decode_32k, cut in batch
  and seq; dlrm-rm2 and deepfm SMOKE serve_p99 and retrieval_cand at
  their full shapes, rtol/atol 1e-5 as `tests/test_torch_recsys.py`);
- the GNN kinds' cells, built and stepped (the steps are held in
  ``tests/test_torch_gnn.py``, the other train kinds in
  ``tests/test_torch_train.py``), and the launch-count arithmetic a
  captured step applies.
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models.recsys import deepfm as ref_deepfm
from repro.models.recsys import dlrm as ref_dlrm
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.kernels import counters
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.recsys import base
from repro_torch.optim import tree as tree_lib

from test_torch_lm import LM_ARCHS, _carried, _close, _tokens, port_config

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

RECSYS_TOL = dict(rtol=1e-5, atol=1e-5)
REF_RECSYS = {"dlrm-rm2": ref_dlrm, "deepfm": ref_deepfm}


@functools.cache
def _mesh():
    return ref_mesh.make_host_mesh(1)


def _ref_caches(caches, cfg):
    """The port's per-layer cache list as the JAX package's pytree (head,
    scan units stacked per pattern position, tail), numpy leaves."""
    flat = [{k: v.numpy() for k, v in c.items()} for c in caches]
    nh, p = cfg.n_dense_head_layers, len(cfg.pattern)
    out = {"head": flat[:nh], "tail": flat[nh + cfg.n_units * p:]}
    if cfg.n_units:
        out["scan"] = {
            f"l{j}": {name: np.stack([flat[nh + u * p + j][name]
                                      for u in range(cfg.n_units)])
                      for name in flat[0]}
            for j in range(p)}
    return out


def _close_caches(got, want, cfg, slots, label):
    """The first ``slots`` slots of every layer, scaled as logits are."""
    got = _ref_caches(got, cfg)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        w = np.asarray(w)
        _close(g[..., :slots, :], w[..., :slots, :],
               f"{label} cache {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# the LM steps against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_steps_match_jax(arch):
    rc, params, cfg, model = _carried(arch)
    b, l, max_len = 2, 24, 40
    toks = _tokens(cfg.vocab, (b, l + 2), seed=11)
    want, ref_caches, ref_lengths = jax.jit(
        ref_steps.make_lm_prefill_step(rc, _mesh(), max_len))(
            params, jnp.asarray(toks[:, :l]))
    got, caches, lengths = steps.make_lm_prefill_step(cfg, max_len)(
        model, torch.from_numpy(toks[:, :l]))
    assert got.shape == (b, cfg.vocab) and lengths.tolist() == [l] * b
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_lengths))
    _close(got.numpy(), want, f"{arch} prefill step")
    _close_caches(caches, ref_caches, cfg, l, f"{arch} prefill step")

    decode = steps.make_lm_decode_step(cfg)
    ref_decode = jax.jit(ref_steps.make_lm_decode_step(rc, _mesh()))
    for t in range(l, l + 2):
        lengths, ref_lengths = lengths + 1, ref_lengths + 1
        logits, caches = decode(model, caches,
                                torch.from_numpy(toks[:, t:t + 1]), lengths)
        want, ref_caches = ref_decode(params, ref_caches,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      ref_lengths)
        assert logits.shape == (b, 1, cfg.vocab)
        _close(logits.numpy(), want, f"{arch} decode step {t}")
    _close_caches(caches, ref_caches, cfg, l + 2, f"{arch} decode steps")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_padded_prefill_equals_unpadded_prefill(arch):
    """Prompts of 30 and 17 tokens right-padded to 64 in one batch: the
    logits at each row's last real position, the cache slots of its real
    positions (a ring layer's every slot: both prompts pass its window of
    16) and one decode step after it equal each prompt prefilled alone
    (MoE layers route the padding too, and each token on its own)."""
    _, _, cfg, model = _carried(arch)
    real, bucket, max_len = (30, 17), 64, 70
    toks = _tokens(cfg.vocab, (2, bucket + 1), seed=12)
    caches = T.init_cache(cfg, 2, max_len)
    lengths = torch.tensor(real, dtype=torch.int32)
    logits, caches, _ = steps.make_lm_prefill_step(cfg, max_len)(
        model, torch.from_numpy(toks[:, :bucket]), lengths, caches)
    alone = []
    for r, n in enumerate(real):
        one = torch.from_numpy(toks[r:r + 1, :n])
        want, a, want_len = T.prefill(model, one, cfg, max_len)
        alone.append((a, want_len))
        _close(logits[r].numpy(), want[0, -1].numpy(), f"row {r} logits")
        for i, (kind, c, w) in enumerate(zip(cfg.layer_kinds, caches, a)):
            assert set(c) == set(w)
            for name in c:
                got, ref = T.slots_view(c[name]), T.slots_view(w[name])
                ring = ref.shape[2] < max_len
                assert ring == (kind == "local") == (got.shape[2] < max_len)
                slots = ref.shape[2] if ring else n
                _close(got[r, :, :slots].numpy(), ref[0, :, :slots].numpy(),
                       f"row {r} layer {i} {kind} {name}")
    nxt = torch.from_numpy(np.stack([toks[r, n:n + 1]
                                     for r, n in enumerate(real)]))
    step_logits, _ = steps.make_lm_decode_step(cfg)(model, caches, nxt,
                                                    lengths + 1)
    for r, (a, want_len) in enumerate(alone):
        want, _ = T.decode_step(model, a, nxt[r:r + 1], want_len + 1, cfg)
        _close(step_logits[r].numpy(), want[0].numpy(),
               f"row {r} decode after the padded prefill")


def test_prompt_buckets_are_powers_of_two_up_to_the_context():
    assert [steps.prompt_bucket(n, 512) for n in (1, 64, 65, 129, 300, 512)] \
        == [64, 64, 128, 256, 512, 512]
    assert steps.prompt_bucket(40, 48) == 48
    assert steps.prompt_bucket(300, 400) == 400
    for bad in (0, 513):
        with pytest.raises(ValueError):
            steps.prompt_bucket(bad, 512)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_generation_steps_reuse_one_cache_and_step_per_bucket(arch):
    """On the CPU the steps run eagerly on their static buffers; two
    prompts of one bucket share its step, and each gives its own
    unpadded prefill's logits (GQA, MoE and MLA caches alike)."""
    _, _, cfg, model = _carried(arch)
    gs = steps.GenerationSteps(model, cfg, max_context=100, max_new_tokens=3)
    assert gs.max_len == 103
    assert all(T.slots_view(t).shape[2] == 103
               for c in gs.caches for t in c.values())
    for n, seed in ((70, 1), (90, 2), (20, 3)):
        prompt = _tokens(cfg.vocab, (1, n), seed=seed)
        bucket = gs.bucket(n)
        padded = np.zeros((1, bucket), np.int64)
        padded[:, :n] = prompt
        logits, _, _ = gs.prefill(bucket)(torch.from_numpy(padded),
                                          torch.tensor([n], dtype=torch.int32))
        want, _, _ = T.prefill(model, torch.from_numpy(prompt), cfg, n + 3)
        _close(logits[0].numpy(), want[0, -1].numpy(), f"prompt of {n}")
    assert sorted(gs._prefill) == [64, 100]
    assert gs.captures == 0 and gs.capture_s == 0.0  # nothing is captured
    assert len(gs.steps()) == 3


@pytest.mark.parametrize("max_context", [512, 400, 100, 48])
def test_generation_steps_list_and_capture_every_prompt_bucket(max_context):
    """``buckets()`` is every bucket ``prompt_bucket`` gives a prompt of
    1 … max_context tokens; ``capture_all`` makes each bucket's step and
    the decode step (capturing nothing on the CPU), and every step is
    registered with the capture guard under its bucket's name."""
    from repro_torch.analysis import sanitizers

    _, _, cfg, model = _carried("llama3.2-3b")
    gs = steps.GenerationSteps(model, cfg, max_context, max_new_tokens=2)
    want = sorted({steps.prompt_bucket(n, max_context)
                   for n in range(1, max_context + 1)})
    assert gs.buckets() == want
    gs.capture_all()
    assert sorted(gs._prefill) == want and gs.captures == 0
    counts = sanitizers.capture_counts()
    assert {f"{cfg.name}.prefill[{b}]" for b in want} | {
        f"{cfg.name}.decode"} <= set(counts)


# ---------------------------------------------------------------------------
# cells against the JAX package's cells
# ---------------------------------------------------------------------------

def _load_lm_weights(model, params):
    """The JAX package's weights, copied into the cell's own model."""
    cfg = model.cfg
    ref = T.params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    model.load_state_dict(ref.state_dict())


@pytest.mark.parametrize("shape_id,cuts", [
    ("prefill_32k", dict(batch=2, seq=48)),
    ("decode_32k", dict(batch=3, seq=40)),
])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_lm_cells_match_the_jax_cells(arch, shape_id, cuts):
    rc, params, _, _ = _carried(arch)
    cell = steps.build_cell(arch, shape_id, smoke=True, device="cpu",
                            seed=4, **cuts)
    ref_cell = ref_steps.build_cell(arch, shape_id, _mesh(), smoke=True)
    spec = ref_configs.ARCHS[arch]
    assert (cell.arch_id, cell.shape_id) == (arch, shape_id)
    assert cell.meta["kind"] == ref_cell.meta["kind"]
    full = {"prefill_32k": (32, 32768), "decode_32k": (128, 32768)}[shape_id]
    assert cell.meta["reduced"] == [f"batch {full[0]} -> {cuts['batch']}",
                                    f"seq {full[1]} -> {cuts['seq']}"]
    cfg = cell.args[0].cfg
    assert cfg == port_config(spec.smoke_config)
    _load_lm_weights(cell.args[0], params)
    b, s = cuts["batch"], cuts["seq"]
    if shape_id == "prefill_32k":
        _, tokens, lengths, caches = cell.args
        assert tokens.shape == (b, s) and lengths.tolist() == [s] * b
        want, want_caches, want_len = ref_cell.fn(
            params, jnp.asarray(tokens.numpy().astype(np.int32)))
        logits, out_caches, out_len = cell.fn(*cell.args)
        assert out_caches is caches
        _close(logits.numpy(), want, "prefill cell logits")
        np.testing.assert_array_equal(out_len.numpy(), np.asarray(want_len))
        _close_caches(caches, want_caches, cfg, s, "prefill cell")
    else:
        _, caches, tokens, lengths = cell.args
        assert tokens.shape == (b, 1) and lengths.tolist() == [s] * b
        if cfg.mla is None:
            assert caches[0]["k"].shape == (b, cfg.n_kv_heads, s,
                                            cfg.head_dim)
        else:
            assert caches[0]["c_kv"].shape == (b, s, cfg.mla.kv_lora_rank)
        assert all(t.abs().sum() > 0
                   for c in caches for t in c.values())  # seeded, full
        want, want_caches = ref_cell.fn(
            params, jax.tree.map(jnp.asarray, _ref_caches(caches, cfg)),
            jnp.asarray(tokens.numpy().astype(np.int32)),
            jnp.asarray(lengths.numpy()))
        logits, out_caches = cell.fn(*cell.args)
        assert out_caches is caches
        _close(logits.numpy(), want, "decode cell logits")
        _close_caches(caches, want_caches, cfg, s, "decode cell")


def test_cells_draw_their_inputs_from_the_seed():
    a = steps.build_cell("llama3.2-3b", "decode_32k", smoke=True,
                         device="cpu", batch=2, seq=16, seed=7)
    b = steps.build_cell("llama3.2-3b", "decode_32k", smoke=True,
                         device="cpu", batch=2, seq=16, seed=7)
    c = steps.build_cell("llama3.2-3b", "decode_32k", smoke=True,
                         device="cpu", batch=2, seq=16, seed=8)
    assert torch.equal(a.args[1][2]["v"], b.args[1][2]["v"])
    assert torch.equal(a.args[0].embed, b.args[0].embed)
    assert not torch.equal(a.args[1][2]["v"], c.args[1][2]["v"])
    assert a.meta["max_len"] == 16
    uncut = steps.build_cell("dlrm-rm2", "serve_p99", smoke=True,
                             device="cpu")
    assert uncut.meta["reduced"] == []


def _load_recsys_weights(params, jparams):
    ref = base.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    def copy(dst, src):
        if isinstance(dst, dict):
            assert set(dst) == set(src)
            for k in dst:
                copy(dst[k], src[k])
        else:
            dst.copy_(src)

    copy(params, ref)


@pytest.mark.parametrize("shape_id", ["serve_p99", "retrieval_cand"])
@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm"])
def test_recsys_cells_match_the_jax_cells(arch, shape_id):
    cell = steps.build_cell(arch, shape_id, smoke=True, device="cpu", seed=5)
    ref_cell = ref_steps.build_cell(arch, shape_id, _mesh(), smoke=True)
    assert cell.meta["kind"] == ref_cell.meta["kind"]
    assert cell.meta["reduced"] == []
    rc = ref_configs.get(arch).smoke_config
    jparams = REF_RECSYS[arch].init(jax.random.PRNGKey(0), rc)
    params, inputs = cell.args
    _load_recsys_weights(params, jparams)
    batch = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()
             if isinstance(v, torch.Tensor)}
    want = ref_cell.fn(jparams, batch)
    got = cell.fn(*cell.args)
    if shape_id == "serve_p99":
        assert got.shape == (512,) and inputs["sparse_idx"].shape[0] == 512
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **RECSYS_TOL)
    else:
        assert inputs["candidate_ids"].shape == (1_000_448,)
        assert inputs["n_real_candidates"] == 1_000_000
        assert not inputs["candidate_ids"][1_000_000:].any()
        (v, i), (jv, ji) = got, want
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **RECSYS_TOL)
        assert (i < 1_000_000).all()


def test_a_captured_step_takes_new_inputs_into_its_buffers():
    """On the CPU a call copies its inputs into the static buffers and
    runs the step on them: numpy arrays are taken, shapes and constants
    are held."""
    cell = steps.build_cell("dlrm-rm2", "serve_p99", smoke=True,
                            device="cpu", seed=1)
    params, inputs = cell.args
    static = inputs["sparse_idx"]
    first = cell.fn(*cell.args).clone()
    new = {"sparse_idx": np.zeros_like(static.numpy()),
           "dense": inputs["dense"].numpy() * 0}
    got = cell.fn(params, new)
    assert inputs["sparse_idx"] is static and not static.any()
    assert torch.equal(got, torch.full_like(got, float(got[0])))
    assert not torch.equal(got, first)
    with pytest.raises(ValueError, match="shape"):
        cell.fn(params, {"sparse_idx": np.zeros((3, 2), np.int32),
                         "dense": new["dense"]})
    with pytest.raises(ValueError, match="keys"):
        cell.fn(params, {"sparse_idx": new["sparse_idx"]})
    retrieval = steps.build_cell("dlrm-rm2", "retrieval_cand", smoke=True,
                                 device="cpu")
    params, inputs = retrieval.args
    with pytest.raises(ValueError, match="constant"):
        retrieval.fn(params, {**inputs, "n_real_candidates": 5})


@pytest.mark.parametrize("arch,shape_id,item", [
    ("mace", "full_graph_sm", "gnn_train"),
    ("mace", "minibatch_lg", "gnn_train_sampled"),
    ("mace", "molecule", "gnn_train_batched"),
])
def test_gnn_kinds_build_and_step(arch, shape_id, item):
    """The GNN kinds build and step: ``build_cell`` gives the cell of its
    kind, uncut, and one step (lr 0) returns a finite loss with the
    params' bits unchanged (``tests/test_torch_gnn.py`` holds the steps
    to the JAX package's)."""
    cell = steps.build_cell(arch, shape_id, smoke=True, device="cpu")
    assert cell.meta["kind"] == item and cell.meta["reduced"] == []
    params = [t.clone() for t in tree_lib.leaves(cell.args[0])]
    _, opt, loss = cell.fn(*cell.args)
    assert np.isfinite(float(loss)) and int(opt["step"]) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(params, tree_lib.leaves(cell.args[0])))


@pytest.mark.parametrize("shape_id,n_shards", [("pod_16m", None),
                                               ("edge_1k", 4)])
def test_ragdb_cell_runs_on_the_cpu(shape_id, n_shards):
    """The ragdb_retrieve cells: the SMOKE cell over
    ``docs_per_device × n_shards`` docs, gemm and kernel legs, gives the
    JAX package's oracle's ids on the same arrays."""
    from repro.core.retrieval import single_device_reference as ref_oracle

    for use_kernel in (False, True):
        cell = steps.build_cell("ragdb", shape_id, smoke=True, device="cpu",
                                n_shards=n_shards, use_kernel=use_kernel)
        spec = shapes.shapes_for_family("ragdb")[shape_id]
        n_docs = spec.meta["docs_per_device"] * (n_shards or 1)
        assert cell.meta["n_docs"] == n_docs
        assert cell.meta["reduced"] == [f"shards 256 -> {n_shards or 1}"]
        vals, ids = cell.fn(*cell.args)
        cfg = configs.get("ragdb").smoke_config
        assert vals.shape == ids.shape == (spec.meta["query_batch"],
                                           cfg.top_k)
        rv, ri = ref_oracle(*(a.numpy() for a in cell.args), n_docs,
                            cfg.top_k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="no batch"):
        steps.build_cell("ragdb", shape_id, smoke=True, device="cpu",
                         batch=2)


def test_cell_cuts_are_checked():
    with pytest.raises(ValueError, match="no seq"):
        steps.build_cell("dlrm-rm2", "serve_p99", smoke=True, device="cpu",
                         seq=8)
    with pytest.raises(ValueError, match="no batch"):
        steps.build_cell("dlrm-rm2", "retrieval_cand", smoke=True,
                         device="cpu", batch=8)
    with pytest.raises(KeyError):
        steps.build_cell("llama3.2-3b", "serve_p99", smoke=True,
                         device="cpu")


# ---------------------------------------------------------------------------
# launch counts under capture and replay
# ---------------------------------------------------------------------------

@pytest.fixture
def table():
    counts = {"launches": 0, "plain": 0}
    counters.register("test.table", counts, threading.Lock())
    yield counts
    counters._TABLES.pop("test.table")


def test_tally_and_add_are_the_replay_arithmetic(table):
    recs = [("test.table", "launches")] * 28 + [("test.table", "plain")]
    assert counters.tally(recs) == {("test.table", "launches"): 28,
                                    ("test.table", "plain"): 1}
    assert counters.tally(recs, times=-2) == {("test.table", "launches"): -56,
                                              ("test.table", "plain"): -2}
    assert counters.tally([]) == {}
    counters.add({("test.table", "launches"): 5})
    counters.add({("test.table", "launches"): -2, ("test.table", "plain"): 1})
    assert table == {"launches": 3, "plain": 1}


def test_capture_accounting_counts_each_replay_once(table):
    """What ``CapturedStep.capture`` and each replay do to the counts: the
    warm-up and capture passes are taken back out, and every replay adds
    the captured pass's launches."""
    def one_pass():  # a step whose wrapper launches 28 kernels
        for _ in range(28):
            counters.bump("test.table", "launches")

    table["launches"] = 7  # launches made before, outside any step
    with counters.recording() as setup:
        for _ in range(steps.WARMUP_RUNS):
            one_pass()
        with counters.recording() as captured:
            one_pass()
    assert len(setup) == 28 * (steps.WARMUP_RUNS + 1) and len(captured) == 28
    counters.add(counters.tally(setup, times=-1))
    per_replay = counters.tally(captured)
    assert table["launches"] == 7
    for _ in range(3):
        counters.add(per_replay)
    assert table["launches"] == 7 + 3 * 28


def test_recording_sees_only_its_own_thread(table):
    """A serving runtime's thread launching kernels while a step is
    captured is counted, and neither taken out nor replayed."""
    with counters.recording() as mine:
        counters.bump("test.table", "launches")
        t = threading.Thread(
            target=lambda: counters.bump("test.table", "plain"))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert mine == [("test.table", "launches")]
    assert table == {"launches": 1, "plain": 1}


def test_wrappers_count_through_the_shared_tables():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hsf_score import ops as hsf_ops
    from repro_torch.kernels.topk import ops as topk_ops

    for name, table in (("flash_attention", fa_ops.counts),
                        ("decode_attention", da_ops.counts),
                        ("topk", topk_ops.counts),
                        ("hsf_score", hsf_ops.counts),
                        ("hsf_score.single", hsf_ops.single_counts),
                        ("embedding_bag", bag_ops.counts)):
        assert counters._TABLES[name][0] is table
    q = torch.zeros((1, 2, 4, 16))
    before = fa_ops.counts["plain"]
    with counters.recording() as recs:
        fa_ops.flash_attention(q, q[:, :1], q[:, :1])
        topk_ops.top_k(torch.arange(8.0), 2)  # a CPU call: no launch
    assert recs == [("flash_attention", "plain")]
    assert fa_ops.counts["plain"] == before + 1
