"""The port's single-query HSF (`kernels/hsf_score` ``hsf_score``) and
streaming top-k (`kernels/topk`) modules against the JAX package's
kernels in interpret mode, over the cases of the JAX package's own
kernel tests.  On the CPU each wrapper runs its plain version; the CUDA
kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.

Tolerances are the JAX sweep's: 1e-5 in f32 (both sides sum the same
products in another order) and 3e-2 in bf16.  Top-k ids must match
exactly, and values too.  Where the JAX kernel and its oracle disagree
(a -inf entry in the top k surfaces as (-inf, 2³¹−1) from the kernel),
the port follows the kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hsf as ref_hsf
from repro.kernels.hsf_score import ops as ref_hsf_ops
from repro.kernels.hsf_score.ref import hsf_score_ref as jax_hsf_score_ref
from repro.kernels.topk import ops as ref_topk_ops
from repro.kernels.topk.ref import top_k_ref as jax_top_k_ref
from repro_torch.core import hsf
from repro_torch.kernels import build
from repro_torch.kernels.hsf_score import ops
from repro_torch.kernels.hsf_score.ref import hsf_score_ref
from repro_torch.kernels.topk import ops as tk_ops
from repro_torch.kernels.topk.ref import top_k_ref

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

_DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
           "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _corpus(n, d, w, rng):
    dv = rng.normal(size=(n, d)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True) + 1e-30
    ds = rng.integers(0, 2**31, size=(n, w)).astype(np.int32)
    qv = rng.normal(size=(d,)).astype(np.float32)
    qs = (ds[0] & ds[min(1, n - 1)]).astype(np.int32) if n \
        else np.zeros((w,), np.int32)
    return dv, ds, qv, qs


# ---------------------------------------------------------------------------
# hsf_score (single query)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,w", [
    (64, 256, 128), (100, 512, 128), (1024, 1024, 256), (5, 128, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hsf_score_sweep_matches_jax_kernel(n, d, w, dtype):
    tdt, jdt, tol = _DTYPES[dtype]
    dv, ds, qv, qs = _corpus(n, d, w, np.random.default_rng(n + d))
    got = ops.hsf_score(torch.from_numpy(dv).to(tdt), torch.from_numpy(ds),
                        torch.from_numpy(qv).to(tdt), torch.from_numpy(qs),
                        alpha=0.9, beta=1.3)
    jax_args = (jnp.asarray(dv, jdt), jnp.asarray(ds), jnp.asarray(qv, jdt),
                jnp.asarray(qs))
    want = ref_hsf_ops.hsf_score(*jax_args, alpha=0.9, beta=1.3,
                                 interpret=True)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_hsf_score_ref(*jax_args, 0.9, 1.3)),
        rtol=tol, atol=tol)


def test_hsf_score_boost_exactness():
    """The boost term is exactly β — never approximated."""
    n, d, w = 32, 128, 128
    ds = np.random.default_rng(0).integers(0, 2**31, size=(n, w)
                                           ).astype(np.int32)
    out = ops.hsf_score(torch.zeros((n, d)), torch.from_numpy(ds),
                        torch.zeros(d), torch.from_numpy(ds[7]),
                        alpha=1.0, beta=1.0)
    assert out[7].item() == 1.0
    assert set(out.tolist()) <= {0.0, 1.0}


def test_hsf_score_empty_corpus():
    out = ops.hsf_score(torch.zeros((0, 128)),
                        torch.zeros((0, 128), dtype=torch.int32),
                        torch.zeros(128), torch.zeros(128, dtype=torch.int32))
    assert out.shape == (0,) and out.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 3, 7, 9, 100])
def test_hsf_score_small_and_ragged_n(n):
    dv, ds, qv, qs = _corpus(n, 128, 128, np.random.default_rng(n))
    out = hsf.hsf_scores_kernel(*(torch.from_numpy(x) for x in
                                  (dv, ds, qv, qs)), 1.1, 0.7)
    assert out.shape == (n,)
    ref = ref_hsf.numpy_reference(dv, ds, qv, qs, 1.1, 0.7)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    want = ref_hsf_ops.hsf_score(*(jnp.asarray(x) for x in (dv, ds, qv, qs)),
                                 alpha=1.1, beta=0.7, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_hsf_score_containment_compares_unsigned_bit_patterns():
    """Words with the sign bit set contain and fail exactly like the
    JAX package's (and numpy's uint32) test."""
    ds = np.array([[-1, 5], [-2**31, 7], [3, -1]], np.int32)
    qs = np.array([-2**31, 5], np.int32)
    out = hsf_score_ref(torch.zeros((3, 4)), torch.from_numpy(ds),
                        torch.zeros(4), torch.from_numpy(qs), 1.0, 1.0)
    want = ref_hsf.numpy_reference(np.zeros((3, 4), np.float32), ds,
                                   np.zeros(4, np.float32), qs, 1.0, 1.0)
    np.testing.assert_array_equal(out.numpy(), want.astype(np.float32))
    assert out.tolist() == [1.0, 1.0, 0.0]


def test_hsf_score_operand_checks_raise():
    dv, ds = torch.zeros((8, 16)), torch.zeros((8, 4), dtype=torch.int32)
    qv, qs = torch.zeros(16), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops._check_single(dv.double(), ds, qv.double(), qs)
    with pytest.raises(TypeError):
        ops._check_single(dv, ds, qv.bfloat16(), qs)
    with pytest.raises(TypeError):
        ops._check_single(dv, ds.long(), qv, qs)
    with pytest.raises(ValueError):
        ops._check_single(torch.zeros((16, 8)).T, ds, qv, qs)
    with pytest.raises(ValueError):
        ops._check_single(dv, ds, torch.zeros(15), qs)
    with pytest.raises(ValueError, match="device"):
        ops.hsf_score(dv.to("meta"), ds.to("meta"), qv.to("meta"),
                      qs.to("meta"))


# ---------------------------------------------------------------------------
# top_k
# ---------------------------------------------------------------------------

def _both_topk(s, k):
    pv, pi = tk_ops.top_k(torch.from_numpy(s), k)
    jv, ji = ref_topk_ops.top_k(jnp.asarray(s), k, interpret=True)
    return (pv.numpy(), pi.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("n,k", [(512, 4), (3000, 17), (128, 128), (129, 1)])
def test_topk_sweep_matches_jax_kernel(n, k):
    s = np.random.default_rng(n).normal(size=n).astype(np.float32)
    (pv, pi), (jv, ji) = _both_topk(s, k)
    assert pv.dtype == np.float32 and pi.dtype == np.int32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    rv, ri = jax_top_k_ref(jnp.asarray(s), k)
    np.testing.assert_array_equal(pi, np.asarray(ri))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_topk_duplicate_ties_match_jax_kernel(seed):
    """The JAX suite's duplicate-heavy property (five distinct values),
    over fixed seeds: ties break toward the lower id on both sides."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 33))
    n = int(rng.integers(k, 2000))
    s = rng.integers(0, 5, size=n).astype(np.float32)
    (pv, pi), (jv, ji) = _both_topk(s, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)


def test_topk_neg_inf_entries_surface_as_sentinels():
    """The JAX kernel's own behaviour (its oracle gives ids 1, 3)."""
    s = np.array([1, -np.inf, 2, -np.inf, 1], np.float32)
    (pv, pi), (jv, ji) = _both_topk(s, 5)
    assert pi.tolist() == [2, 0, 4, 2**31 - 1, 2**31 - 1]
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    assert np.asarray(jax_top_k_ref(jnp.asarray(s), 5)[1]).tolist() == \
        [2, 0, 4, 1, 3]
    # one block of the JAX kernel with fewer finite entries than k
    s = np.full(300, -np.inf, np.float32)
    s[[5, 10]] = 1.0
    (pv, pi), (jv, ji) = _both_topk(s, 4)
    assert pi.tolist() == [5, 10, 2**31 - 1, 2**31 - 1]
    np.testing.assert_array_equal(pi, ji)


def test_topk_contract_raises_where_jax_asserts():
    s = torch.zeros(10)
    for k in (0, 11, 129):
        with pytest.raises(ValueError, match="k"):
            tk_ops.top_k(torch.zeros(200) if k == 129 else s, k)
    with pytest.raises(ValueError, match="1-D"):
        tk_ops.top_k(torch.zeros((2, 5)), 1)
    with pytest.raises(ValueError, match="device"):
        tk_ops.top_k(torch.zeros(10, device="meta"), 3)
    with pytest.raises(TypeError):
        tk_ops._launch(torch.zeros(10, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tk_ops._launch(torch.zeros((10, 2))[:, 0], 3)


def test_plain_versions_match_their_oracles():
    s = torch.tensor([0.5, 2.0, 2.0, -1.0, float("-inf")])
    v, i = top_k_ref(s, 5)
    assert i.tolist() == [1, 2, 0, 3, 2**31 - 1]
    assert v[:4].tolist() == [2.0, 2.0, 0.5, -1.0]


# ---------------------------------------------------------------------------
# dispatch: CPU calls are no launches, and the CUDA path never falls back
# ---------------------------------------------------------------------------

def test_cpu_calls_do_not_count_as_launches():
    dv, ds, qv, qs = _corpus(50, 64, 8, np.random.default_rng(1))
    before = (dict(ops.single_counts), dict(tk_ops.counts))
    scores = ops.hsf_score(*(torch.from_numpy(x) for x in (dv, ds, qv, qs)))
    tk_ops.top_k(scores, 4)
    assert (ops.single_counts, tk_ops.counts) == before
    ops.reset_counts()
    tk_ops.reset_counts()
    assert ops.single_counts == {"launches": 0}
    assert tk_ops.counts == {"launches": 0}


@pytest.mark.parametrize("which", ["hsf_score", "topk"])
def test_cuda_path_without_nvcc_raises(which, monkeypatch):
    """What a CUDA tensor meets on a host without the CUDA toolkit: the
    launch path builds its kernel first, and the build raises — no
    quiet fall back to the plain version."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    ops._single_lib.cache_clear()
    tk_ops._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if which == "hsf_score":
                ops._launch_single(torch.zeros((4, 8)),
                                   torch.zeros((4, 2), dtype=torch.int32),
                                   torch.zeros(8),
                                   torch.zeros(2, dtype=torch.int32), 1.0,
                                   1.0)
            else:
                tk_ops._launch(torch.zeros(10), 3)
    finally:
        ops._single_lib.cache_clear()
        tk_ops._lib.cache_clear()


def test_cuda_tensors_need_a_card():
    """On a host without a card, the CUDA tensors the wrappers launch on
    cannot exist; the entry points raise instead of serving from the
    CPU."""
    from repro_torch.core.engine import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


@pytest.mark.parametrize("name", ["hsf_score", "topk"])
def test_build_targets_for_the_new_sources(name):
    target = build._target(name)
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith(f"lib{name}.") and target.suffix == ".so"
    assert (build.CSRC / f"{name}.cu").exists()
