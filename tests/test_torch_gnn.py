"""The port's GNN (``models/gnn/{mace,sampler}.py``, ``configs/mace.py``,
``data/pipeline.gnn_graph``, the GNN train step and cells of
``launch/steps.py``) against the JAX package's, on the CPU at the SMOKE
widths.  Weights are the JAX package's ``mace.init`` carried across
with ``mace.params_from_numpy``; inputs are numpy arrays from a seed.
Tolerances, each stated where it is used:

- ``bessel_rbf``, ``real_sph_harm``, ``_products``: rtol 1e-6 (f32, the
  same elementwise formulas);
- ``forward``: node logits and energies within rtol = atol = 1e-5 (f32
  products and segment sums in other orders);
- ``energy_and_forces``: the energy within 1e-5, the forces within 1e-4
  (rtol and atol: the gradient adds the same terms in another order);
- one train step of each kind from carried params and state (two
  steps of the reference from init): the bounds
  ``tests/test_torch_train.py`` holds the recsys step to — the loss
  within rtol 1e-5, every parameter and moment within rtol 1e-5, atol
  1e-6 (the carried moments keep Adam's step smooth in the gradient);
- ``gnn_graph`` and ``sample_subgraph``: arrays exactly equal.

Then the contracts of ``tests/test_models_gnn_recsys.py`` (E(3)
invariance, force equivariance, the edge mask, independent batched
graphs, the sampler's shapes and determinism) run on the port as they
stand there, and ``build_cell`` steps each of the four GNN shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import shapes as ref_shapes
from repro.data import pipeline as ref_pipeline
from repro.launch import steps as ref_steps
from repro.models.gnn import mace as RM
from repro.models.gnn import sampler as ref_sampler
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.models.gnn import mace as M
from repro_torch.models.gnn.sampler import CSRGraph, sample_subgraph
from repro_torch.optim import tree as tree_lib

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
BASIS_RTOL = 1e-6
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
ENERGY_TOL, FORCE_TOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs():
    return configs.get("mace").smoke_config, REF_ARCHS["mace"].smoke_config


def _params(seed=0, d_feat=None):
    """(port cfg, ref cfg, ref params, port params): the JAX package's
    init carried across."""
    cfg, rcfg = _cfgs()
    if d_feat is not None:
        cfg = dataclasses.replace(cfg, d_feat=d_feat)
        rcfg = dataclasses.replace(rcfg, d_feat=d_feat)
    rp = RM.init(jax.random.PRNGKey(seed), rcfg)
    tp = M.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return cfg, rcfg, rp, tp


def _graph(rng, cfg, n=24, e=80):
    return (rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32) * 2,
            rng.integers(0, n, size=e).astype(np.int32),
            rng.integers(0, n, size=e).astype(np.int32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _random_rotation(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_config_and_params_tree_equal_the_jax_package():
    """FULL and SMOKE field for field; ``init`` gives the reference's
    tree (keys, shapes, dtypes) from a torch generator."""
    spec = configs.get("mace")
    for got, want in ((spec.config, REF_ARCHS["mace"].config),
                      (spec.smoke_config, REF_ARCHS["mace"].smoke_config)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_sh == want.n_sh
    cfg, rcfg = _cfgs()
    mine = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = RM.init(jax.random.PRNGKey(0), rcfg)
    got = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in tree_lib.paths(mine)]
    want = [(p, tuple(t.shape), str(t.dtype))
            for p, t in tree_lib.paths(jax.tree.map(np.asarray, ref))]
    assert got == want


def test_bases_and_products_equal_the_jax_package():
    """``bessel_rbf`` (inside and past the cutoff, and at r → 0),
    ``real_sph_harm`` and ``_products`` within rtol 1e-6."""
    cfg, rcfg = _cfgs()
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.uniform(0, 6, size=200), [0.0, 1e-12, 5.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        M.bessel_rbf(torch.from_numpy(r), cfg.n_rbf, cfg.r_cut).numpy(),
        np.asarray(RM.bessel_rbf(jnp.asarray(r), rcfg.n_rbf, rcfg.r_cut)),
        rtol=BASIS_RTOL, atol=0)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    unit = v / np.linalg.norm(v, axis=1, keepdims=True)
    for l_max in (0, 1, 2):
        np.testing.assert_allclose(
            M.real_sph_harm(torch.from_numpy(unit), l_max).numpy(),
            np.asarray(RM.real_sph_harm(jnp.asarray(unit), l_max)),
            rtol=BASIS_RTOL, atol=0)
    a = rng.normal(size=(10, cfg.d_hidden, cfg.n_sh)).astype(np.float32)
    np.testing.assert_allclose(
        M._products(torch.from_numpy(a), cfg).numpy(),
        np.asarray(RM._products(jnp.asarray(a), rcfg)),
        rtol=BASIS_RTOL, atol=0)


@pytest.mark.parametrize("case", ["plain", "edge_mask", "batched"])
def test_forward_equals_the_jax_package(case):
    """Node logits and energies within rtol = atol = 1e-5: one graph,
    with padding edges masked, and three graphs by ``graph_ids``."""
    cfg, rcfg, rp, tp = _params(2)
    rng = np.random.default_rng(3)
    feats, pos, snd, rcv = _graph(rng, cfg, n=30, e=120)
    kw_t, kw_j = {}, {}
    if case == "edge_mask":
        mask = (rng.random(120) < 0.7).astype(np.float32)
        kw_t["edge_mask"], kw_j["edge_mask"] = torch.from_numpy(mask), \
            jnp.asarray(mask)
    if case == "batched":
        gid = (np.arange(30) // 10).astype(np.int32)
        kw_t.update(graph_ids=torch.from_numpy(gid), n_graphs=3)
        kw_j.update(graph_ids=jnp.asarray(gid), n_graphs=3)
    got = M.forward(tp, *_t(feats, pos, snd, rcv), cfg, **kw_t)
    want = RM.forward(rp, *_j(feats, pos, snd, rcv), rcfg, **kw_j)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_energy_and_forces_equal_the_jax_package():
    """The energy within 1e-5, the forces within 1e-4 (rtol and atol)."""
    cfg, rcfg, rp, tp = _params(4)
    feats, pos, snd, rcv = _graph(np.random.default_rng(5), cfg)
    e, f = M.energy_and_forces(tp, *_t(feats, pos, snd, rcv), cfg)
    je, jf = jax.jit(lambda *a: RM.energy_and_forces(*a, rcfg))(
        rp, *_j(feats, pos, snd, rcv))
    np.testing.assert_allclose(float(e), float(je), rtol=ENERGY_TOL,
                               atol=ENERGY_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    assert float(np.abs(np.asarray(jf)).max()) > 1e-3


def _batch(kind, cfg, seed):
    """A padded batch of ``kind`` (numpy), ``shapes.input_specs``' keys,
    and its graph count: 40 nodes in 48 slots, 150 edges in 160."""
    g = pipeline.gnn_graph(pipeline.DataCursor(seed=seed), 40, 150,
                           cfg.d_feat, n_graphs=4 if kind ==
                           "gnn_train_batched" else 1)

    def pad(a, n):
        out = np.zeros((n,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        return out

    b = {"node_feats": pad(g["node_feats"], 48),
         "positions": pad(g["positions"], 48),
         "senders": pad(g["senders"], 160), "receivers": pad(g["receivers"], 160),
         "labels": pad(g["labels"], 48),
         "edge_mask": pad(np.ones(150, np.float32), 160),
         "node_mask": pad(np.ones(40, np.float32), 48)}
    if kind == "gnn_train_sampled":
        b["seed_mask"] = (np.arange(48) < 12).astype(np.float32)
    if kind == "gnn_train_batched":
        b["graph_ids"] = pad(g["graph_ids"], 48)
        b["energy_targets"] = g["energy_targets"]
    return b, 4 if kind == "gnn_train_batched" else 1


@pytest.mark.parametrize("kind", steps.GNN_KINDS)
def test_train_step_equals_the_jax_package(kind):
    """Two steps of the reference's ``make_gnn_train_step`` from init,
    its params and AdamW state carried across, then one step on each
    side on a new batch: the loss within rtol 1e-5, every parameter and
    moment within rtol 1e-5, atol 1e-6, the step count equal."""
    cfg, rcfg, rp, _ = _params(6)
    n_graphs = _batch(kind, cfg, 0)[1]
    step_fn = ref_steps.make_gnn_train_step(rcfg, None, kind)
    ref = jax.jit(lambda p, o, b: step_fn(p, o, {**b, "n_graphs_static":
                                                  n_graphs}))
    jo = ref_adamw_init(rp)
    for s in range(2):
        rp, jo, _ = ref(rp, jo, _j_dict(_batch(kind, cfg, s)[0]))
    tp = M.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    to = {k: M.params_from_numpy(jax.tree.map(np.asarray, jo[k]), "cpu")
          for k in ("m", "v")}
    to["step"] = torch.tensor(int(jo["step"]), dtype=torch.int32)
    b, _ = _batch(kind, cfg, 7)
    rp, jo, jl = ref(rp, jo, _j_dict(b))
    step = steps.make_gnn_train_step(cfg, kind)
    tp, to, loss = step(tp, to, {**b, "n_graphs_static": n_graphs})
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for got, want in ((tp, rp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for (path, g), w in zip(tree_lib.paths(got), tree_lib.leaves(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, **STEP_TOL,
                                       err_msg=str(path))
    assert int(to["step"]) == int(jo["step"]) == 3


def _j_dict(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("n_graphs", [1, 5])
def test_gnn_graph_equals_the_jax_package(n_graphs):
    """The same ``DataCursor`` stream gives the reference's arrays
    exactly (within one process: ``hash(stream)`` is salted per
    process), two steps in a row."""
    mine, ref = pipeline.DataCursor(seed=3), ref_pipeline.DataCursor(seed=3)
    for _ in range(2):
        got = pipeline.gnn_graph(mine, 57, 203, 6, n_graphs=n_graphs)
        want = ref_pipeline.gnn_graph(ref, 57, 203, 6, n_graphs=n_graphs)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mine.step == ref.step == 2


def test_sampler_equals_the_jax_package():
    """The same ``np.random.Generator`` gives the reference's subgraph
    exactly: node ids, masks, senders, receivers (nodes with no
    neighbours and fewer neighbours than the fanout included)."""
    rng = np.random.default_rng(8)
    n = 300
    snd = rng.integers(0, n, size=900)
    rcv = rng.integers(0, n - 20, size=900)  # the last 20 have none
    seeds = np.concatenate([rng.choice(n - 20, 14, replace=False),
                            [n - 1, n - 2]])
    got = sample_subgraph(CSRGraph(n, snd, rcv), seeds, (6, 4),
                          np.random.default_rng(9))
    want = ref_sampler.sample_subgraph(ref_sampler.CSRGraph(n, snd, rcv),
                                       seeds, (6, 4),
                                       np.random.default_rng(9))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert not got.node_mask.all()


# ---------------------------------------------------------------------------
# the reference's contracts (tests/test_models_gnn_recsys.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mace_setup():
    cfg = configs.get("mace").smoke_config
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    n, e = 24, 80
    feats = torch.from_numpy(rng.normal(size=(n, cfg.d_feat)).astype(
        np.float32))
    pos = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 2)
    snd = torch.from_numpy(rng.integers(0, n, size=e).astype(np.int32))
    rcv = torch.from_numpy(rng.integers(0, n, size=e).astype(np.int32))
    return cfg, params, feats, pos, snd, rcv


def _invariance(seed):
    cfg = configs.get("mace").smoke_config
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(seed)
    n, e = 16, 40
    feats = torch.from_numpy(rng.normal(size=(n, cfg.d_feat)).astype(
        np.float32))
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd = torch.from_numpy(rng.integers(0, n, size=e).astype(np.int32))
    rcv = torch.from_numpy(rng.integers(0, n, size=e).astype(np.int32))
    rot = _random_rotation(seed)
    t = rng.normal(size=(1, 3)).astype(np.float32)
    _, e0 = M.forward(params, feats, torch.from_numpy(pos), snd, rcv, cfg)
    _, e1 = M.forward(params, feats, torch.from_numpy(pos @ rot.T + t), snd,
                      rcv, cfg)
    np.testing.assert_allclose(float(e0[0]), float(e1[0]), rtol=2e-4,
                               atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_mace_e3_invariance(seed):
    """Energy invariant under any rotation + translation (exact property
    of the invariant product basis)."""
    _invariance(seed)


@pytest.mark.parametrize("seed", [0, 17, 9_999])
def test_mace_e3_invariance_at_fixed_seeds(seed):
    """The same property at three fixed seeds."""
    _invariance(seed)


def test_mace_force_equivariance(mace_setup):
    cfg, params, feats, pos, snd, rcv = mace_setup
    rot = torch.from_numpy(_random_rotation(3))
    e1, f1 = M.energy_and_forces(params, feats, pos, snd, rcv, cfg)
    e2, f2 = M.energy_and_forces(params, feats, pos @ rot.T, snd, rcv, cfg)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)
    np.testing.assert_allclose(f2.numpy(), (f1 @ rot.T).numpy(), rtol=1e-3,
                               atol=1e-3)


def test_mace_edge_mask_drops_edges(mace_setup):
    cfg, params, feats, pos, snd, rcv = mace_setup
    mask = torch.ones(snd.shape[0])
    mask[10:] = 0.0
    _, e_masked = M.forward(params, feats, pos, snd, rcv, cfg,
                            edge_mask=mask)
    _, e_trunc = M.forward(params, feats, pos, snd[:10], rcv[:10], cfg)
    np.testing.assert_allclose(float(e_masked[0]), float(e_trunc[0]),
                               rtol=1e-5)


def test_mace_batched_graphs_independent(mace_setup):
    """Energies of disjoint graphs don't leak into each other."""
    cfg, params, feats, pos, snd, rcv = mace_setup
    n = feats.shape[0]
    gid = torch.from_numpy((np.arange(n) >= n // 2).astype(np.int32))
    snd2, rcv2 = snd % (n // 2), rcv % (n // 2)
    _, both = M.forward(params, feats, pos, snd2, rcv2, cfg, graph_ids=gid,
                        n_graphs=2)
    _, first = M.forward(params, feats[: n // 2], pos[: n // 2], snd2, rcv2,
                         cfg)
    np.testing.assert_allclose(float(both[0]), float(first[0]), rtol=1e-5)


def test_sampler_shapes_and_validity():
    rng = np.random.default_rng(0)
    n, e = 200, 1200
    g = CSRGraph(n, rng.integers(0, n, size=e), rng.integers(0, n, size=e))
    sub = sample_subgraph(g, np.arange(16), (5, 3), np.random.default_rng(1))
    assert sub.node_ids.shape == (16 * (1 + 5 + 15),)
    assert sub.senders.shape == (16 * (5 + 15),)
    # every valid edge points at a valid node slot
    ok = sub.edge_mask
    assert (sub.receivers[ok] < len(sub.node_mask)).all()
    assert sub.node_mask[sub.receivers[ok]].all()
    assert sub.node_mask[sub.senders[ok]].all()
    assert sub.seed_mask.sum() == 16


def test_sampler_deterministic():
    rng = np.random.default_rng(0)
    g = CSRGraph(50, rng.integers(0, 50, 300), rng.integers(0, 50, 300))
    s1 = sample_subgraph(g, np.arange(4), (3, 2), np.random.default_rng(7))
    s2 = sample_subgraph(g, np.arange(4), (3, 2), np.random.default_rng(7))
    np.testing.assert_array_equal(s1.node_ids, s2.node_ids)
    np.testing.assert_array_equal(s1.senders, s2.senders)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_id,cut", [("full_graph_sm", None),
                                          ("minibatch_lg", None),
                                          ("molecule", None),
                                          ("ogb_products", 1024)])
def test_gnn_cell_steps_on_the_cpu(shape_id, cut):
    """``build_cell("mace", shape, smoke=True)``: the batch has
    ``input_specs``' keys, shapes and dtypes at the cell's slot counts,
    padded nodes have zero features and energy, two steps give finite
    losses (the first at lr 0 leaves the params' bits, the second moves
    every leaf); ``meta["reduced"]`` lists a cut and only a cut."""
    cell = steps.build_cell("mace", shape_id, smoke=True, device="cpu",
                            graph_cut=cut)
    spec = shapes.GNN_SHAPES[shape_id]
    params, opt, batch = cell.args
    m = cell.meta
    assert m["kind"] == spec.kind
    if cut is None:
        assert m["reduced"] == []
        assert (m["pad_nodes"], m["pad_edges"]) == (spec.meta["pad_nodes"],
                                                    spec.meta["pad_edges"])
    else:
        n, e = spec.meta["n_nodes"] // cut, spec.meta["n_edges"] // cut
        assert m["reduced"] == [f"n_nodes {spec.meta['n_nodes']} -> {n}",
                                f"n_edges {spec.meta['n_edges']} -> {e}"]
        assert m["pad_nodes"] % 512 == 0 and m["pad_nodes"] >= n
    cfg = dataclasses.replace(configs.get("mace").smoke_config,
                              d_feat=spec.meta["d_feat"])
    specs = shapes.input_specs(cfg, dataclasses.replace(spec, meta={
        **spec.meta, "pad_nodes": m["pad_nodes"],
        "pad_edges": m["pad_edges"]}))
    assert list(batch) == list(specs)
    for k, t in specs.items():
        assert batch[k].shape == t.shape and batch[k].dtype == t.dtype, k
    pad = batch["node_mask"] == 0
    assert not batch["node_feats"][pad].any()
    kw = {"edge_mask": batch["edge_mask"]}
    if "graph_ids" in batch:
        kw.update(graph_ids=batch["graph_ids"],
                  n_graphs=spec.meta["n_graphs"])
    _, energies = M.forward(params, batch["node_feats"], batch["positions"],
                            batch["senders"], batch["receivers"], cfg, **kw)
    assert torch.isfinite(energies).all()
    before = [t.clone() for t in tree_lib.leaves(params)]
    _, _, l0 = cell.fn(*cell.args)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_lib.leaves(params)))
    _, opt, l1 = cell.fn(*cell.args)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     tree_lib.leaves(params)))
    assert int(opt["step"]) == 2


def test_padded_nodes_carry_zero_energy():
    """A node slot with zero features and no edges keeps h = 0 through
    every layer, so its energy is exactly 0 and a graph's energy does
    not change when such slots are added to it."""
    cfg, _, _, tp = _params(9)
    feats, pos, snd, rcv = _graph(np.random.default_rng(10), cfg)
    node_logits, e = M.forward(tp, *_t(feats, pos, snd, rcv), cfg)
    pf = np.concatenate([feats, np.zeros((8, cfg.d_feat), np.float32)])
    pp = np.concatenate([pos, np.zeros((8, 3), np.float32)])
    gid = np.concatenate([np.zeros(24, np.int32), np.ones(8, np.int32)])
    logits2, e2 = M.forward(tp, *_t(pf, pp, snd, rcv), cfg,
                            graph_ids=torch.from_numpy(gid), n_graphs=2)
    assert float(e2[1]) == 0.0
    assert torch.equal(logits2[24:], torch.zeros_like(logits2[24:]))
    np.testing.assert_allclose(float(e2[0]), float(e[0]), rtol=1e-6)


def test_graph_cut_only_cuts_whole_graph_shapes():
    with pytest.raises(ValueError, match="graph_cut"):
        steps.build_cell("mace", "molecule", smoke=True, device="cpu",
                         graph_cut=2)
    with pytest.raises(ValueError, match="no graph"):
        steps.build_cell("dlrm-rm2", "serve_p99", smoke=True, device="cpu",
                         graph_cut=2)


def test_cell_inputs_match_the_reference_specs():
    """Every GNN cell's batch has the reference's ``input_specs`` keys,
    shapes and dtypes (on ``meta``, no data made)."""
    cfg, rcfg = _cfgs()
    for shape_id, spec in shapes.GNN_SHAPES.items():
        cell = steps.build_cell("mace", shape_id, device="meta")
        want = ref_shapes.input_specs(
            dataclasses.replace(rcfg, d_feat=spec.meta["d_feat"]),
            ref_shapes.GNN_SHAPES[shape_id])
        got = cell.args[2]
        assert list(got) == list(want)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, (shape_id, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
