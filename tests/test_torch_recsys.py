"""The port's recsys serving plane against the JAX package: the four
archs' ``forward`` and ``retrieval_scores`` with weights carried from
the JAX package's ``init`` (``params_from_numpy``), the serve and
retrieval steps, ``lookup_bags`` with and without the EmbeddingBag
module, the data pipeline, configs and registry.

Sizes: each arch's SMOKE config, and its FULL widths (MLPs up to 1,024
wide, E up to 128) with every vocabulary cut to at most 300 rows.
Tolerance rtol 1e-5, atol 1e-5: both sides run the same f32 products,
summed in another order.  Top-16 ids must be equal, ties by id asc."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.data import pipeline as ref_pipeline
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models.recsys import autoint as ref_autoint
from repro.models.recsys import base as ref_base
from repro.models.recsys import deepfm as ref_deepfm
from repro.models.recsys import dlrm as ref_dlrm
from repro.models.recsys import embedding as ref_embedding
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models.recsys import autoint, base, deepfm, dlrm, embedding

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["dlrm-rm2", "dlrm-mlperf", "deepfm", "autoint"]
MODULES = {"dlrm-rm2": (dlrm, ref_dlrm), "dlrm-mlperf": (dlrm, ref_dlrm),
           "deepfm": (deepfm, ref_deepfm), "autoint": (autoint, ref_autoint)}
CUT_VOCAB = 300


def _configs(arch, size):
    """(port config, JAX config) at SMOKE, or at FULL widths with the
    vocabularies cut to CUT_VOCAB rows."""
    if size == "smoke":
        return (configs.get(arch).smoke_config,
                ref_get(arch).smoke_config)
    cut = tuple(min(v, CUT_VOCAB) for v in ref_get(arch).config.vocab_sizes)
    return (dataclasses.replace(configs.get(arch).config, vocab_sizes=cut),
            dataclasses.replace(ref_get(arch).config, vocab_sizes=cut))


def _carried(arch, jcfg):
    """The JAX package's init(PRNGKey(0)) and the same weights as the
    port's tensors."""
    jparams = MODULES[arch][1].init(jax.random.PRNGKey(0), jcfg)
    return jparams, base.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _query(cfg, rng):
    if cfg.n_dense:
        return rng.normal(size=(1, cfg.n_dense)).astype(np.float32)
    return np.stack([rng.integers(0, v, size=1) for v in cfg.vocab_sizes],
                    axis=1).astype(np.int32)


def _jax_batch(batch):
    return {k: (v if np.isscalar(v) else jnp.asarray(v))
            for k, v in batch.items() if v is not None}


@pytest.mark.parametrize("size", ["smoke", "full-width"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_retrieval_scores_match_jax(arch, size):
    cfg, jcfg = _configs(arch, size)
    mod, ref_mod = MODULES[arch]
    jparams, params = _carried(arch, jcfg)
    dense, sparse, _ = ref_pipeline.recsys_batch(
        ref_pipeline.DataCursor(seed=1), 16, jcfg.vocab_sizes, jcfg.n_dense)
    want = ref_mod.forward(jparams, None if dense is None
                           else jnp.asarray(dense), jnp.asarray(sparse), jcfg)
    got = mod.forward(params, None if dense is None
                      else torch.from_numpy(dense), torch.from_numpy(sparse),
                      cfg)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    rng = np.random.default_rng(2)
    q = _query(jcfg, rng)
    cand = rng.integers(0, jcfg.vocab_sizes[0], size=100).astype(np.int32)
    want = ref_mod.retrieval_scores(jparams, jnp.asarray(q),
                                    jnp.asarray(cand), jcfg)
    got = mod.retrieval_scores(params, torch.from_numpy(q),
                               torch.from_numpy(cand), cfg)
    assert got.shape == (100,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_retrieval_steps_match_jax(arch):
    cfg, jcfg = _configs(arch, "smoke")
    jparams, params = _carried(arch, jcfg)
    mesh = ref_mesh.make_host_mesh()
    dense, sparse, _ = pipeline.recsys_batch(
        pipeline.DataCursor(seed=3), 32, cfg.vocab_sizes, cfg.n_dense)
    batch = {"dense": dense, "sparse_idx": sparse}
    want = ref_steps.make_recsys_step(arch, jcfg, mesh, "recsys_serve")(
        jparams, _jax_batch(batch))
    got = steps.make_recsys_step(arch, cfg, "recsys_serve", device="cpu")(
        params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # 90 real candidates, ten of them twice (exact ties: the lower
    # position must come first), then 12 padding slots that must lose
    rng = np.random.default_rng(4)
    real = rng.integers(0, cfg.vocab_sizes[0], size=80).astype(np.int32)
    cand = np.concatenate([real, real[:10], np.full(12, 5, np.int32)])
    batch = {"query": _query(cfg, rng), "candidate_ids": cand,
             "n_real_candidates": 90}
    jv, ji = ref_steps.make_recsys_step(arch, jcfg, mesh, "recsys_retrieval")(
        jparams, _jax_batch(batch))
    v, i = steps.make_recsys_step(arch, cfg, "recsys_retrieval",
                                  device="cpu")(params, batch)
    assert v.shape == (16,) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    assert (i < 90).all()
    # exact ties (a candidate and its copy) are in the top 16, ids asc
    vals, ids = v.tolist(), i.tolist()
    tied = [p for p in range(1, 16) if vals[p] == vals[p - 1]]
    assert tied and all(ids[p] > ids[p - 1] for p in tied)


def test_steps_need_a_device_or_a_card(monkeypatch):
    cfg = configs.get("dlrm-rm2").smoke_config
    with pytest.raises(ValueError, match="kind"):
        steps.make_recsys_step("dlrm-rm2", cfg, "recsys_dream", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_recsys_step("dlrm-rm2", cfg, "recsys_serve")


def test_sharding_ctx_raises_naming_its_roadmap_item():
    """The row-sharded lookup is ported: under ``sharding_ctx`` over S
    shards, ``lookup`` and ``lookup_scores`` give the unsharded bits and
    the JAX package's values (its sharded lookup on a one-device mesh
    too); a mesh axis the shard mesh does not have raises."""
    from repro_torch.launch.mesh import make_shard_mesh

    vocabs = (100, 200, 50)
    table = np.array(ref_embedding.init_tables(jax.random.PRNGKey(0),
                                               vocabs, 16)["table"])
    idx = np.random.default_rng(0).integers(0, 50, size=(24, 3)).astype(
        np.int32)
    q = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    offs = embedding.field_offsets(vocabs)
    t = torch.from_numpy(table)
    flat = torch.from_numpy(idx) + offs[None, :]
    plain = embedding.lookup(t, offs, torch.from_numpy(idx))
    scores = embedding.lookup_scores(t, flat.reshape(-1), torch.from_numpy(q))
    ref_offs = ref_embedding.field_offsets(vocabs)
    want = np.asarray(ref_embedding.lookup(jnp.asarray(table), ref_offs,
                                           jnp.asarray(idx)))
    np.testing.assert_array_equal(plain.numpy(), want)
    with ref_embedding.sharding_ctx(
            jax.make_mesh((1,), ("model",),
                          axis_types=(jax.sharding.AxisType.Auto,)), "model"):
        ref_sharded = np.asarray(ref_embedding.lookup(
            jnp.asarray(table), ref_offs, jnp.asarray(idx)))
    np.testing.assert_array_equal(ref_sharded, want)
    for n_shards in (1, 2, 4, 7):
        with embedding.sharding_ctx(make_shard_mesh(n_shards, "cpu")):
            got = embedding.lookup(t, offs, torch.from_numpy(idx))
            got_scores = embedding.lookup_scores(t, flat.reshape(-1),
                                                 torch.from_numpy(q))
        assert torch.equal(got, plain), n_shards
        assert torch.equal(got_scores, scores), n_shards
    np.testing.assert_allclose(scores.numpy(), want.reshape(-1, 16) @ q,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="axes"):
        with embedding.sharding_ctx(make_shard_mesh(2, "cpu"), "model"):
            pass


def _bag_case():
    """The JAX package's own case (tests/test_models_gnn_recsys.py):
    one index per field, summed per sample."""
    vocabs = (20, 30)
    table = np.array(ref_embedding.init_tables(jax.random.PRNGKey(0),
                                               vocabs, 16)["table"])
    idx = np.array([[3, 7], [11, 2]], np.int32)
    return (vocabs, table, idx.reshape(-1), np.array([0, 1, 0, 1], np.int32),
            np.array([0, 0, 1, 1], np.int32), 2, None)


def _multi_hot_case():
    rng = np.random.default_rng(5)
    vocabs = (13, 50, 7, 29)
    table = rng.normal(size=(embedding.padded_rows(vocabs), 24)
                       ).astype(np.float32)
    n, bags = 90, 11
    field = rng.integers(0, 4, size=n).astype(np.int32)
    idx = np.array([rng.integers(0, vocabs[f]) for f in field], np.int32)
    bag = rng.integers(0, bags, size=n).astype(np.int32)
    return (vocabs, table, idx, field, bag, bags,
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("case", [_bag_case, _multi_hot_case])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_lookup_bags_matches_jax(case, use_kernel):
    vocabs, table, idx, field, bag, bags, w = case()
    want = ref_embedding.lookup_bags(
        jnp.asarray(table), ref_embedding.field_offsets(vocabs),
        jnp.asarray(idx), jnp.asarray(field), jnp.asarray(bag), bags,
        None if w is None else jnp.asarray(w), use_kernel=use_kernel)
    bag_ops.reset_counts()
    got = embedding.lookup_bags(
        torch.from_numpy(table), embedding.field_offsets(vocabs),
        torch.from_numpy(idx), torch.from_numpy(field),
        torch.from_numpy(bag), bags,
        None if w is None else torch.from_numpy(w), use_kernel=use_kernel)
    assert bag_ops.counts["plain"] == int(use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case is _bag_case:
        rows = embedding.lookup(torch.from_numpy(table),
                                embedding.field_offsets(vocabs),
                                torch.from_numpy(idx.reshape(2, 2)))
        np.testing.assert_allclose(got.numpy(), rows.sum(1).numpy(), **TOL)


def test_recsys_and_lm_batches_equal_the_jax_package_in_process():
    vocabs = ref_get("dlrm-rm2").config.vocab_sizes
    for step in range(3):
        want = ref_pipeline.recsys_batch(
            ref_pipeline.DataCursor(seed=11, step=step), 64, vocabs, 13)
        got = pipeline.recsys_batch(pipeline.DataCursor(seed=11, step=step),
                                    64, vocabs, 13)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    d, s, _ = pipeline.recsys_batch(pipeline.DataCursor(0), 4, (5, 6), 0)
    assert d is None and s.dtype == np.int32 and s.shape == (4, 2)
    cur, ref_cur = pipeline.DataCursor(2), ref_pipeline.DataCursor(2)
    for a, b in zip(pipeline.lm_batch(cur, 3, 9, 50),
                    ref_pipeline.lm_batch(ref_cur, 3, 9, 50)):
        np.testing.assert_array_equal(a, b)
    assert cur.step == ref_cur.step == 1


def test_full_vocabulary_offsets_and_rows_without_allocation():
    for vocabs in (base.CRITEO_VOCABS, base.DEEPFM_VOCABS):
        assert vocabs == getattr(ref_base, "CRITEO_VOCABS"
                                 if len(vocabs) == 26 else "DEEPFM_VOCABS")
        np.testing.assert_array_equal(
            embedding.field_offsets(vocabs).numpy(),
            np.asarray(ref_embedding.field_offsets(vocabs)))
        assert embedding.padded_rows(vocabs) == \
            ref_embedding.padded_rows(vocabs)
    assert embedding.padded_rows(base.CRITEO_VOCABS) == 187_767_808
    assert embedding.padded_rows(base.DEEPFM_VOCABS) == 7_112_192
    assert embedding.field_offsets(base.CRITEO_VOCABS).dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_configs_and_param_counts_equal_the_jax_package(arch):
    spec = configs.get(arch)
    assert spec.family == "recsys"
    for mine, ref in ((spec.config, ref_get(arch).config),
                      (spec.smoke_config, ref_get(arch).smoke_config)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
    assert steps.RECSYS_MODULES[arch] is MODULES[arch][0]
    assert steps.RECSYS_MODULES[spec.smoke_config.name] is MODULES[arch][0]


def test_gnn_arch_resolves_to_the_port():
    """The GNN arch resolves to the port's own config module
    (``tests/test_torch_gnn.py`` holds the model)."""
    spec = configs.get("mace")
    assert spec.family == "gnn"
    assert spec.module == "repro_torch.configs.mace"
    assert type(spec.config).__module__ == "repro_torch.models.gnn.mace"


def test_shape_tables_equal_the_jax_package():
    from repro.configs import shapes as ref_shapes

    for fam in ("lm", "gnn", "recsys", "ragdb"):
        mine, ref = (shapes.shapes_for_family(fam),
                     ref_shapes.shapes_for_family(fam))
        assert list(mine) == list(ref)
        for k in mine:
            assert (mine[k].kind, mine[k].meta) == (ref[k].kind, ref[k].meta)
    assert shapes.RECSYS_SHAPES["retrieval_cand"].meta["pad_candidates"] \
        == 1_000_448


def test_interaction_pairs_are_row_major_like_jnp_triu_indices():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(3, 7, 5)).astype(np.float32)
    got = dlrm._interact_dot(torch.from_numpy(feats))
    want = ref_dlrm._interact_dot(jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    iu, ju = torch.triu_indices(7, 7, 1)
    riu, rju = jnp.triu_indices(7, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(riu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(rju))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree_and_distributions(arch):
    cfg, jcfg = _configs(arch, "full-width")
    params = MODULES[arch][0].init(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    ref_shape = jax.eval_shape(
        lambda: MODULES[arch][1].init(jax.random.PRNGKey(0), jcfg))
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: tuple(t.shape), params,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, tuple))[0]
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda s: tuple(s.shape), ref_shape),
        is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [(jax.tree_util.keystr(p), s) for p, s in mine] == \
        [(jax.tree_util.keystr(p), s) for p, s in ref]
    table = params["table"]
    assert table.shape == (embedding.padded_rows(cfg.vocab_sizes),
                           cfg.embed_dim)
    assert abs(table.std().item() * cfg.embed_dim ** 0.5 - 1) < 0.05
    for name, leaf in params.get("bot", {}).items():
        if name.startswith("b"):
            assert torch.count_nonzero(leaf) == 0
    if "first_order" in params:
        assert abs(params["first_order"].std().item() / 0.01 - 1) < 0.05
        assert params["bias"].shape == ()


def test_dense_mlp_and_bce_match_jax():
    from repro.models import layers as ref_layers

    rng = np.random.default_rng(7)
    jp = ref_layers.dense_mlp_init(jax.random.PRNGKey(1), (13, 32, 8))
    p = base.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(5, 13)).astype(np.float32)
    for final in (False, True):
        np.testing.assert_allclose(
            layers.dense_mlp_apply(p, torch.from_numpy(x), 2, final).numpy(),
            np.asarray(ref_layers.dense_mlp_apply(jp, jnp.asarray(x), 2,
                                                  final)), **TOL)
    mine = layers.dense_mlp_init(torch.Generator().manual_seed(0), (13, 32, 8))
    assert sorted(mine) == sorted(jp)
    logits = (rng.normal(size=64) * 20).astype(np.float32)
    labels = (rng.random(64) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        base.bce_with_logits(torch.from_numpy(logits),
                             torch.from_numpy(labels)).item(),
        float(ref_base.bce_with_logits(jnp.asarray(logits),
                                       jnp.asarray(labels))), rtol=1e-6)


def test_params_from_numpy_copies_and_casts():
    tree = {"table": np.ones((4, 2), np.float32),
            "layers": [{"w": np.zeros((2, 2), np.float32)}],
            "bias": np.float32(0.5), "ids": np.arange(3, dtype=np.int32)}
    out = base.params_from_numpy(tree, "cpu", torch.bfloat16)
    assert out["table"].dtype == torch.bfloat16
    assert out["layers"][0]["w"].dtype == torch.bfloat16
    assert out["bias"].shape == () and out["ids"].dtype == torch.int32
    tree["table"][0, 0] = 7.0
    assert out["table"][0, 0] == 1.0


def test_recsys_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.launch.steps, repro_torch.data.pipeline\n"
        "import repro_torch.configs.shapes, repro_torch.models.recsys.base\n"
        "import repro_torch.kernels.embedding_bag.ops\n"
        "from repro_torch import configs\n"
        "for a in ('dlrm-rm2', 'dlrm-mlperf', 'deepfm', 'autoint'):\n"
        "    configs.get(a).config\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
