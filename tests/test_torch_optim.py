"""The port's optimizers (`optim/`) against the JAX package's, on the CPU.

The contracts of ``tests/test_optim.py`` run through the port (the
hypothesis-driven one over fixed seeds, so it runs where hypothesis is
not installed).  Then the same numpy arrays go through both packages:

- elementwise float32 arithmetic is bit-equal to the JAX functions run
  op by op (eager): ``adamw_update`` with the clip inactive,
  ``warmup_cosine`` in its warm-up, ``quantize``/``dequantize``,
  ``ef_roundtrip``;
- where a reduction or a transcendental enters — the global norm, the
  cosine of the schedule, the row mean of row-wise Adagrad — or where
  XLA fuses a multiply-add into an FMA (the jitted update), within
  rtol 1e-6 (a few float32 ulps; the fused FMA differs in the last bit
  and Adam's normalised step carries that one ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import rowwise as ref_rowwise
from repro.optim import schedule as ref_schedule
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compress, rowwise, warmup_cosine
from repro_torch.optim import tree as tree_lib
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.compress import dequantize, ef_roundtrip, quantize

torch.set_num_threads(1)

RTOL = 1e-6


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the contracts of tests/test_optim.py, through the port
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        torch.sum(torch.square(w - 1.0)).backward()
        params, opt = adamw_update({"w": w.grad}, opt, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)
    assert int(opt["step"]) == 200 and opt["step"].dtype == torch.int32


def test_grad_clip():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    p2, _ = adamw_update({"w": torch.full((3,), 1e9)}, opt, params, cfg)
    assert p2["w"].abs().max() < 2.0  # clip kept it sane


def test_schedule_shape():
    lrs = [float(warmup_cosine(s, 1e-3, 10, 100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9  # peak at end of warmup
    assert lrs[99] < lrs[50] < lrs[11]
    assert lrs[99] >= 1e-4 * 0.99  # min_ratio floor


@pytest.mark.parametrize("seed", range(8))
def test_quantize_roundtrip_bound(seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=64)
                         .astype(np.float32) * 10)
    q, s = quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    err = (dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6  # half-ULP of the grid


def test_error_feedback_unbiased_over_time():
    """Accumulated compressed updates converge to accumulated true
    updates: the drift is the final residual, one quantization step."""
    rng = np.random.default_rng(0)
    g_true = [rng.normal(size=32).astype(np.float32) for _ in range(50)]
    err = {"g": torch.zeros(32)}
    acc_c = np.zeros(32)
    acc_t = np.zeros(32)
    for g in g_true:
        gq, err = ef_roundtrip({"g": torch.from_numpy(g)}, err)
        acc_c += gq["g"].numpy()
        acc_t += g
    drift = np.abs(acc_c - acc_t)
    assert drift.max() <= err["g"].abs().max().item() + 1e-5


def test_ef_training_matches_uncompressed_loss():
    target = torch.from_numpy(np.linspace(-2, 2, 16).astype(np.float32))

    def run(compressed: bool):
        params = {"w": torch.zeros(16)}
        opt = adamw_init(params)
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
        err = {"w": torch.zeros(16)}
        for _ in range(150):
            g = {"w": 2 * (params["w"] - target)}
            if compressed:
                g, err = ef_roundtrip(g, err)
            params, opt = adamw_update(g, opt, params, cfg)
        return float(torch.sum(torch.square(params["w"] - target)))

    assert run(True) < run(False) + 1e-2


# ---------------------------------------------------------------------------
# parity with the JAX package on the same arrays
# ---------------------------------------------------------------------------

def _trees(seed, bf16=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 33), "b": [(7,), (3, 5)]}
    p = {"a": rng.normal(size=shapes["a"]).astype(np.float32),
         "b": [rng.normal(size=s).astype(np.float32) for s in shapes["b"]]}
    g = {"a": rng.normal(size=shapes["a"]).astype(np.float32) * 1e-2,
         "b": [rng.normal(size=s).astype(np.float32) * 1e-2
               for s in shapes["b"]]}
    return p, g


def _port(tree):
    return tree_lib.map_(lambda a: torch.tensor(a), tree)


@pytest.mark.parametrize("jit,clip", [(False, 1e9), (False, 1.0),
                                      (True, 1.0)])
def test_adamw_update_matches_the_jax_package(jit, clip):
    """Five steps under the reference's schedule, weight decay on.  With
    the clip inactive and JAX run op by op, every parameter, moment and
    learning rate is bit-equal; the active clip (a global norm: a sum
    over leaves in another order) and the jitted update (FMA-fused) agree
    within rtol 1e-6 of each leaf's largest magnitude."""
    p, g = _trees(0)
    cfg = AdamWConfig(grad_clip=clip)
    rcfg = ref_adamw.AdamWConfig(grad_clip=clip)
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    jo = ref_adamw.adamw_init(jp)
    tp, tg = _port(p), _port(g)
    to = adamw_init(tp)
    ref_update = (jax.jit(ref_adamw.adamw_update, static_argnums=3) if jit
                  else ref_adamw.adamw_update)
    for _ in range(5):
        lr_j = ref_schedule.warmup_cosine(jo["step"], 3e-4, 2, 10)
        lr_t = warmup_cosine(to["step"], 3e-4, 2, 10)
        assert _bits(lr_j) == _bits(lr_t)
        jp, jo = ref_update(jg, jo, jp, rcfg, lr_j)
        tp, to = adamw_update(tg, to, tp, cfg, lr_t)
        assert int(jo["step"]) == int(to["step"])
        for name, jt, tt in (("p", jp, tp), ("m", jo["m"], to["m"]),
                             ("v", jo["v"], to["v"])):
            for a, b in zip(jax.tree.leaves(jt), tree_lib.leaves(tt)):
                a, b = np.asarray(a), b.numpy()
                if clip > 1e8 and not jit:
                    np.testing.assert_array_equal(_bits(a), _bits(b), name)
                else:
                    np.testing.assert_allclose(
                        b, a, rtol=0, atol=RTOL * np.abs(a).max(),
                        err_msg=name)


def test_adamw_keeps_bf16_leaves_and_f32_moments():
    p = {"w": torch.randn(4, 4, dtype=torch.float32).to(torch.bfloat16)}
    opt = adamw_init(p)
    assert opt["m"]["w"].dtype == opt["v"]["w"].dtype == torch.float32
    before = p["w"].clone()
    adamw_update({"w": torch.ones(4, 4, dtype=torch.bfloat16)}, opt, p,
                 AdamWConfig(lr=0.1))
    assert p["w"].dtype == torch.bfloat16 and not torch.equal(p["w"], before)


def test_global_norm_matches_the_jax_package():
    _, g = _trees(1)
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(global_norm(_port(g)))
    assert got == pytest.approx(want, rel=RTOL)


def test_warmup_cosine_matches_the_jax_package():
    """Bit-equal through the warm-up (a product and a quotient); the
    cosine branch within rtol 1e-6 (XLA's cos and torch's may differ in
    the last ulp)."""
    for s in list(range(0, 100)) + list(range(100, 10001, 37)):
        want = np.float32(ref_schedule.warmup_cosine(s, 3e-4, 100, 10000))
        got = warmup_cosine(torch.tensor(s, dtype=torch.int32), 3e-4, 100,
                            10000)
        assert got.dtype == torch.float32
        if s < 100:
            assert _bits(want) == _bits(got.numpy()), s
        else:
            assert float(got) == pytest.approx(float(want), rel=RTOL), s


@pytest.mark.parametrize("rows,dim", [(40, 16), (7, 1)])
def test_rowwise_update_matches_the_jax_package(rows, dim):
    """Two steps; rtol 1e-6 (each row's mean of squares is a reduction)."""
    rng = np.random.default_rng(rows)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    jt, js = jnp.asarray(table), ref_rowwise.rowwise_init(jnp.asarray(table))
    tt, ts = torch.tensor(table), rowwise.rowwise_init(torch.tensor(table))
    for _ in range(2):
        g = rng.normal(size=(rows, dim)).astype(np.float32)
        g[::3] = 0.0  # untouched rows
        jt, js = ref_rowwise.rowwise_update(
            jnp.asarray(g), js, jt, ref_rowwise.RowwiseAdagradConfig())
        tt, ts = rowwise.rowwise_update(torch.tensor(g), ts, tt,
                                        rowwise.RowwiseAdagradConfig())
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL)
        np.testing.assert_allclose(ts["g2"].numpy(), np.asarray(js["g2"]),
                                   rtol=RTOL)
        np.testing.assert_array_equal(tt.numpy()[::3], table[::3])


def test_rowwise_update_rows_equals_the_dense_update():
    """The touched-rows update gives the dense update's bits: touched
    rows from their gradient alone, every other row and g2 unchanged."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    g2 = torch.from_numpy(rng.random(50).astype(np.float32))
    rows = torch.tensor([3, 7, 8, 21, 49])
    g_rows = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    dense_g = torch.zeros_like(table).index_copy_(0, rows, g_rows)
    cfg = rowwise.RowwiseAdagradConfig()
    want_t, want = rowwise.rowwise_update(dense_g, {"g2": g2}, table, cfg)
    t, state = table.clone(), {"g2": g2.clone()}
    rowwise.rowwise_update_rows(rows, g_rows, state, t, cfg)
    assert torch.equal(t, want_t) and torch.equal(state["g2"], want["g2"])


def test_split_tree_matches_the_jax_package():
    params = {"table": 1, "first_order": 2, "deep": {"w0": 3}, "bias": 4}
    assert rowwise.split_tree(params) == ref_rowwise.split_tree(params)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_ef_roundtrip_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=257) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    x[::17] = 0.0
    jq, js = ref_compress.quantize(jnp.asarray(x))
    tq, ts = quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()) == _bits(js)
    np.testing.assert_array_equal(
        _bits(dequantize(tq, ts).numpy()),
        _bits(ref_compress.dequantize(jq, js)))
    # all zeros: scale 1, q 0
    zq, zs = quantize(torch.zeros(5))
    assert float(zs) == 1.0 and not zq.any()
    err_j, err_t = {"g": jnp.zeros(257)}, {"g": torch.zeros(257)}
    for step in range(3):
        g = (x * (step + 1)).astype(np.float32)
        gj, err_j = ref_compress.ef_roundtrip({"g": jnp.asarray(g)}, err_j)
        gt, err_t = ef_roundtrip({"g": torch.from_numpy(g)}, err_t)
        np.testing.assert_array_equal(_bits(gt["g"].numpy()),
                                      _bits(gj["g"]))
        np.testing.assert_array_equal(_bits(err_t["g"].numpy()),
                                      _bits(err_j["g"]))


def test_compressed_psum_over_logical_shards():
    """One shard gives the JAX package's ``compressed_psum`` over a
    one-device mesh bit for bit; over four shards the result is the
    mean of the shards within half a step of their shared grid."""
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(9)
    g = rng.normal(size=(4, 33)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("d",))
    ref = jax.jit(jax.shard_map(
        lambda t: ref_compress.compressed_psum(t, "d"), mesh=mesh,
        in_specs=P(), out_specs=P(), check_vma=False))
    want = np.asarray(ref({"g": jnp.asarray(g[0])})["g"])
    got = compress.compressed_psum([{"g": torch.from_numpy(g[0])}])["g"]
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    shards = [{"g": torch.from_numpy(row)} for row in g]
    got = compress.compressed_psum(shards)["g"].numpy()
    scale = np.abs(g).max() / 127.0
    assert np.abs(got - g.mean(axis=0)).max() <= scale * 0.5 + 1e-6
