"""The port's EmbeddingBag module (`kernels/embedding_bag`) against the
JAX package's kernel in interpret mode and its jnp oracle, over the
cases of the JAX package's own kernel tests and the edges of the
contract.  On the CPU the wrapper runs its plain version; the CUDA
kernel itself is held to that plain version on the card by
``chip_smoke.py``.

Tolerances: rtol 1e-5, atol 1e-6 in f32 (both sides add the same
products in another order); for a bf16 table one bf16 rounding of the
f32 sum (rtol 2⁻⁷).  A bag of one unweighted index equals its row bit
for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as ref_ops
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref
from repro.models.recsys import embedding as ref_embedding
from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models.recsys import embedding

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0**-7, atol=1e-6)


def _inputs(v, e, n, bags, rng, weighted=True):
    table = rng.normal(size=(v, e)).astype(np.float32)
    idx = rng.integers(0, v, size=n).astype(np.int32)
    seg = rng.integers(0, bags, size=n).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32) if weighted else None
    return table, idx, seg, w


def _port(table, idx, seg, bags, w, mode="sum", dtype=torch.float32):
    out = ops.embedding_bag(torch.from_numpy(table).to(dtype),
                            torch.from_numpy(idx), torch.from_numpy(seg),
                            bags, None if w is None else torch.from_numpy(w),
                            mode=mode)
    plain = embedding_bag_ref(torch.from_numpy(table).to(dtype),
                              torch.from_numpy(idx), torch.from_numpy(seg),
                              bags, None if w is None else torch.from_numpy(w),
                              mode=mode)
    assert torch.equal(out, plain)  # the CPU wrapper is the plain version
    return out


def _jax(table, idx, seg, bags, w, mode="sum", dtype=jnp.float32):
    return ref_ops.embedding_bag(
        jnp.asarray(table, dtype), jnp.asarray(idx), jnp.asarray(seg), bags,
        None if w is None else jnp.asarray(w), mode=mode, interpret=True)


def _f32(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("v,e,n,bags,mode", [
    (128, 128, 64, 16, "sum"), (1000, 64, 300, 50, "sum"),
    (64, 256, 40, 8, "mean"), (32, 128, 5, 10, "sum"),
])
def test_embedding_bag_sweep_matches_jax_kernel(v, e, n, bags, mode):
    table, idx, seg, w = _inputs(v, e, n, bags, np.random.default_rng(v + n))
    got = _port(table, idx, seg, bags, w, mode)
    assert got.shape == (bags, e) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, bags, w, mode)), **F32)
    order = np.argsort(seg, kind="stable")
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bag_ref(
        jnp.asarray(table), jnp.asarray(idx[order]),
        jnp.asarray(seg[order]), bags, jnp.asarray(w[order]), mode=mode)),
        **F32)


@pytest.mark.parametrize("seed", range(6))
def test_embedding_bag_matches_one_hot_product(seed):
    """bag(table, idx, seg) == one-hot counts @ table (the JAX package's
    property test, at fixed seeds)."""
    rng = np.random.default_rng(seed)
    bags = int(rng.integers(1, 13))
    table, idx, seg, _ = _inputs(20, 128, 30, bags, rng, weighted=False)
    dense = np.zeros((bags, 20), np.float32)
    for i, s in zip(idx, seg):
        dense[s, i] += 1
    got = _port(table, idx, seg, bags, None)
    np.testing.assert_allclose(got.numpy(), dense @ table, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, bags, None)), **F32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_empty_bags_are_zero(mode):
    rng = np.random.default_rng(3)
    table, idx, _, w = _inputs(50, 16, 12, 1, rng)
    seg = np.array([1, 1, 4, 4, 4, 6, 1, 6, 4, 1, 6, 6], np.int32)  # 0,2,3,5,7 empty
    got = _port(table, idx, seg, 8, w, mode)
    for b in (0, 2, 3, 5, 7):
        assert torch.equal(got[b], torch.zeros(16))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, 8, w, mode)), **F32)


def test_unsorted_and_duplicate_segments_and_rows():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(9, 32)).astype(np.float32)
    idx = np.array([3, 3, 8, 0, 3, 5, 5, 1, 8, 3], np.int32)
    seg = np.array([2, 0, 2, 1, 0, 2, 2, 0, 1, 1], np.int32)
    w = rng.normal(size=10).astype(np.float32)
    got = _port(table, idx, seg, 3, w)
    want = np.zeros((3, 32), np.float32)
    for i, s, x in zip(idx, seg, w):
        want[s] += x * table[i]
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, 3, w)), **F32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_no_weights_matches_jax(mode):
    table, idx, seg, _ = _inputs(40, 24, 50, 7, np.random.default_rng(5),
                                 weighted=False)
    got = _port(table, idx, seg, 7, None, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, 7, None, mode)), **F32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table_matches_jax(mode):
    table, idx, seg, w = _inputs(64, 64, 80, 9, np.random.default_rng(6))
    got = _port(table, idx, seg, 9, w, mode, dtype=torch.bfloat16)
    want = _jax(table, idx, seg, 9, w, mode, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("e", [10, 16])
def test_narrow_rows_match_jax(e):
    """deepfm's and autoint's widths (E = 10 and 16)."""
    table, idx, seg, w = _inputs(30, e, 60, 11, np.random.default_rng(e))
    got = _port(table, idx, seg, 11, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax(table, idx, seg, 11, w)), **F32)


def test_no_index_raises_like_the_jax_wrapper():
    table = np.ones((10, 8), np.float32)
    empty = np.zeros((0,), np.int32)
    with pytest.raises(TypeError):
        _jax(table, empty, empty, 3, None)
    with pytest.raises(TypeError, match="n = 0"):
        ops.embedding_bag(torch.ones(10, 8), torch.zeros(0, dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32), 3)
    # the plain version itself is total: three zero bags
    assert torch.equal(embedding_bag_ref(
        torch.ones(10, 8), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), 3), torch.zeros(3, 8))


def test_one_unweighted_index_per_bag_equals_lookup_bit_for_bit():
    rng = np.random.default_rng(7)
    vocabs = (37, 5, 101, 12)
    table = rng.normal(size=(sum(vocabs), 64)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=16) for v in vocabs],
                      axis=1).astype(np.int32)
    offs = embedding.field_offsets(vocabs)
    rows = embedding.lookup(torch.from_numpy(table), offs,
                            torch.from_numpy(sparse)).reshape(-1, 64)
    flat = (torch.from_numpy(sparse) + offs[None, :]).reshape(-1)
    n = flat.shape[0]
    perm = torch.from_numpy(rng.permutation(n))  # bags in any order
    got = ops.embedding_bag(torch.from_numpy(table), flat[perm], perm, n)
    assert torch.equal(got, rows)
    ref_rows = ref_embedding.lookup(jnp.asarray(table),
                                    ref_embedding.field_offsets(vocabs),
                                    jnp.asarray(sparse))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_rows).reshape(-1, 64))


def test_prepare_gives_stable_order_and_csr_offsets():
    """The kernel's operands, built by the same code on every device:
    ids and weights in a stable order by segment, offsets[b] the first
    position of bag b; segments outside [0, n_bags) fall outside every
    bag."""
    rng = np.random.default_rng(8)
    n, bags = 200, 13
    seg = rng.integers(-2, bags + 3, size=n).astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    w = rng.normal(size=n).astype(np.float32)
    p_idx, p_w, offsets = ops.prepare(torch.from_numpy(idx),
                                      torch.from_numpy(seg), bags,
                                      torch.from_numpy(w))
    order = np.argsort(seg, kind="stable")
    np.testing.assert_array_equal(p_idx.numpy(), idx[order])
    np.testing.assert_array_equal(p_w.numpy(), w[order])
    assert p_idx.dtype == torch.int32 and offsets.dtype == torch.int64
    assert offsets.shape == (bags + 1,)
    for b in range(bags):
        inside = p_idx[offsets[b]:offsets[b + 1]].numpy()
        np.testing.assert_array_equal(inside, idx[order][seg[order] == b])
    assert ops.prepare(torch.from_numpy(idx), torch.from_numpy(seg), bags
                       )[1] is None


def test_cpu_calls_count_as_plain_and_other_devices_raise():
    ops.reset_counts()
    table = torch.randn(6, 4)
    i = torch.tensor([1, 2, 3], dtype=torch.int32)
    ops.embedding_bag(table, i, torch.tensor([0, 0, 1]), 2)
    assert ops.counts == {"launches": 0, "plain": 1}
    with pytest.raises(ValueError, match="device"):
        ops.embedding_bag(table.to("meta"), i.to("meta"),
                          i.to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.launch(table, i, None, torch.tensor([0, 2, 3]))
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_ref(table, i, i, 4, mode="max")
    assert "embedding_bag" in sorted(p.stem for p in build.CSRC.glob("*.cu"))
