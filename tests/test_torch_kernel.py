"""The port's fused HSF top-k module (`kernels/hsf_score`) against the
JAX package's kernel in interpret mode, over the cases of the JAX
package's own kernel tests: the sweep, duplicate ties, empty and tiny
corpora, k beyond the kernel's width, sentinel ids and the n_valid
suffix mask.  On the CPU the wrapper runs its plain version (full
scores + stable sort); the CUDA kernel itself is checked against that
plain version on the card by ``chip_smoke.py``.

Ids must match exactly.  Scores agree to rtol 1e-5: both sides are f32
sums of the same products in a different order (an MXU-style blocked
product in the interpreted kernel, a BLAS gemm here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hsf_score import ops as ref_ops
from repro.kernels.hsf_score.hsf_score import ID_SENTINEL as REF_SENTINEL
from repro_torch.kernels import build
from repro_torch.kernels.hsf_score import ops
from repro_torch.kernels.hsf_score.ref import hsf_score_topk_ref

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)


def _hsf_corpus(n, d, w, b, rng):
    dv = rng.normal(size=(n, d)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True) + 1e-30
    ds = rng.integers(0, 2**31, size=(n, w)).astype(np.int32)
    qv = rng.normal(size=(b, d)).astype(np.float32)
    qs = np.stack(
        [ds[i % n] & ds[(i + 1) % n] for i in range(b)]
    ).astype(np.int32) if n else np.zeros((b, w), np.int32)
    return dv, ds, qv, qs


def _both(dv, ds, qv, qs, **kw):
    """(port vals, port ids), (JAX vals, JAX ids) as numpy."""
    block = kw.pop("block_docs", 512)
    pv, pi = ops.hsf_score_batched(
        *(torch.from_numpy(x) for x in (dv, ds, qv, qs)), **kw)
    jv, ji = ref_ops.hsf_score_batched(
        *(jnp.asarray(x) for x in (dv, ds, qv, qs)), block_docs=block,
        interpret=True, **kw)
    return (pv.numpy(), pi.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("n,k", [(64, 5), (100, 7), (1024, 16), (5, 3)])
@pytest.mark.parametrize("beta", [1.3, 0.0])
def test_batched_sweep_matches_jax_kernel(b, n, k, beta):
    dv, ds, qv, qs = _hsf_corpus(n, 256, 128, b, np.random.default_rng(n * b))
    (pv, pi), (jv, ji) = _both(dv, ds, qv, qs, k=k, alpha=0.9, beta=beta)
    assert pv.shape == pi.shape == (b, min(k, n))
    assert pv.dtype == np.float32 and pi.dtype == np.int32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)


def test_duplicate_ties_ascend_by_id():
    """An all-duplicate corpus ties every score exactly; both sides must
    list ascending doc ids (the JAX kernel across 6 merged blocks)."""
    n, d, w, b, k = 96, 128, 128, 4, 9
    rng = np.random.default_rng(7)
    row = rng.normal(size=(1, d)).astype(np.float32)
    sig = rng.integers(0, 2**31, size=(1, w)).astype(np.int32)
    dv, ds = np.tile(row, (n, 1)), np.tile(sig, (n, 1))
    qv = rng.normal(size=(b, d)).astype(np.float32)
    qs = np.tile(sig & sig[0], (b, 1))
    (pv, pi), (jv, ji) = _both(dv, ds, qv, qs, k=k, block_docs=16)
    np.testing.assert_array_equal(pi, np.tile(np.arange(k), (b, 1)))
    np.testing.assert_array_equal(pi, ji)
    for i in range(b):
        assert len(set(pv[i].tolist())) == 1


def test_empty_and_tiny():
    zf, zi = torch.zeros((0, 128)), torch.zeros((0, 128), dtype=torch.int32)
    qv, qs = torch.zeros((2, 128)), torch.zeros((2, 128), dtype=torch.int32)
    vals, ids = ops.hsf_score_batched(zf, zi, qv, qs, k=5)
    assert vals.shape == ids.shape == (2, 0)
    assert ids.dtype == torch.int32
    vals, ids = ops.hsf_score_batched(zf[:0], zi[:0], qv[:0], qs[:0], k=5)
    assert vals.shape == (0, 0)
    dv, ds, qv1, qs1 = _hsf_corpus(1, 128, 128, 2, np.random.default_rng(3))
    (pv, pi), (jv, ji) = _both(dv, ds, qv1, qs1, k=5)
    assert pv.shape == (2, 1)  # k clamps to the corpus
    np.testing.assert_array_equal(pi, np.zeros((2, 1)))
    np.testing.assert_array_equal(pi, ji)


def test_k_beyond_kernel_width_is_unfused_and_counted():
    """k > KPAD follows the JAX wrapper's rule: the unfused plain
    version, same order, counted apart from kernel launches."""
    n, b, k = 300, 2, 150
    dv, ds, qv, qs = _hsf_corpus(n, 128, 128, b, np.random.default_rng(5))
    before = dict(ops.counts)
    (pv, pi), (jv, ji) = _both(dv, ds, qv, qs, k=k, alpha=1.0, beta=1.0)
    assert ops.counts["unfused"] == before["unfused"] + 1
    assert ops.counts["launches"] == before["launches"]
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)


def test_unfillable_rows_get_sentinel_ids():
    n, b, k, keep = 64, 2, 6, 3
    dv, ds, qv, qs = _hsf_corpus(n, 128, 128, b, np.random.default_rng(13))
    (pv, pi), (jv, ji) = _both(dv, ds, qv, qs, k=k, n_valid=keep,
                               block_docs=16)
    assert ops.ID_SENTINEL == REF_SENTINEL
    np.testing.assert_array_equal(pi, ji)
    assert np.all(np.isfinite(pv[:, :keep])) and np.all(pi[:, :keep] < keep)
    assert np.all(np.isneginf(pv[:, keep:]))
    assert np.all(pi[:, keep:] == ops.ID_SENTINEL)


def test_n_valid_masks_suffix():
    n, keep, b, k = 64, 40, 3, 6
    dv, ds, qv, qs = _hsf_corpus(n, 128, 128, b, np.random.default_rng(11))
    (pv, pi), (jv, ji) = _both(dv, ds, qv, qs, k=k, n_valid=keep)
    tv, ti = ops.hsf_score_batched(
        *(torch.from_numpy(x) for x in (dv[:keep], ds[:keep], qv, qs)), k=k)
    np.testing.assert_array_equal(pi, ti.numpy())
    np.testing.assert_array_equal(pv, tv.numpy())
    np.testing.assert_array_equal(pi, ji)
    # a one-element tensor works as the count, as the engine passes ints
    mv, mi = ops.hsf_score_batched(
        *(torch.from_numpy(x) for x in (dv, ds, qv, qs)), k=k,
        n_valid=torch.tensor([keep]))
    np.testing.assert_array_equal(mi.numpy(), pi)


def test_plain_version_orders_ties_by_id():
    scores_src = np.zeros((6, 4), np.float32)
    sigs = np.zeros((6, 2), np.int32)
    q = np.zeros((1, 4), np.float32)
    qs = np.zeros((1, 2), np.int32)
    vals, ids = hsf_score_topk_ref(
        *(torch.from_numpy(x) for x in (scores_src, sigs, q, qs)),
        1.0, 1.0, 4, n_valid=5)
    assert ids.tolist() == [[0, 1, 2, 3]] and vals.tolist() == [[1.0] * 4]


def test_cpu_calls_do_not_count_as_launches():
    dv, ds, qv, qs = _hsf_corpus(50, 64, 8, 2, np.random.default_rng(1))
    before = dict(ops.counts)
    ops.hsf_score_batched(*(torch.from_numpy(x) for x in (dv, ds, qv, qs)),
                          k=4)
    assert ops.counts == before
    ops.reset_counts()
    assert ops.counts == {"launches": 0, "unfused": 0}


def test_other_devices_raise_instead_of_falling_back():
    meta = [torch.empty((8, 16), device="meta"),
            torch.empty((8, 4), dtype=torch.int32, device="meta"),
            torch.empty((2, 16), device="meta"),
            torch.empty((2, 4), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="device"):
        ops.hsf_score_batched(*meta, k=3)


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "device"])
def test_kernel_operand_checks_raise(bad):
    dv = torch.zeros((8, 16))
    ds = torch.zeros((8, 4), dtype=torch.int32)
    qv = torch.zeros((2, 16))
    qs = torch.zeros((2, 4), dtype=torch.int32)
    if bad == "dtype":
        dv, err = dv.double(), TypeError
    elif bad == "layout":
        dv, err = torch.zeros((16, 8)).T, ValueError
    elif bad == "shape":
        qv, err = torch.zeros((2, 15)), ValueError
    else:
        qs, err = qs.to("meta"), ValueError
    with pytest.raises(err):
        ops._check_operands(dv, ds, qv, qs)


def test_pad_docs_returns_operands_unchanged():
    dv, ds = torch.zeros((30, 16)), torch.zeros((30, 4), dtype=torch.int32)
    pv, ps = ops.pad_docs_for_kernel(dv, ds)
    assert pv is dv and ps is ds


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_build_targets_are_named_by_source_and_flags():
    target = build._target("hsf_topk")
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith("libhsf_topk.") and target.suffix == ".so"
    assert build._target("hsf_topk") == target
    assert (build.CSRC / "hsf_topk.cu").exists()
