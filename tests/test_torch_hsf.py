"""`core/hsf.py` of the PyTorch port against the JAX package.

The port computes every product and every add of the pinned-order
``stable_rowdot`` as a separate IEEE f32 op, and so ``α·cos + β·ind``.
The JAX package's XLA-CPU build does not always: it fuses some
multiplies into the add that follows them as one FMA (seen at D = 2,
128, 384 and 1000 on dense inputs, on one row in 60 of a 1024-dim
hashed corpus, and in ``α·cos + β·ind`` for α ≠ 1 and β ≠ 0), which
rounds once where the port rounds twice.  So the port is held to a
numpy model of the separate-op formulation bit for bit, to JAX bit for
bit where XLA keeps the ops apart (containment; the engine's data at
D = 128 and 384), and to JAX within the rounding of one FMA elsewhere
(rtol 1e-6, atol 1e-6 · the row's magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hsf as ref_hsf
from repro_torch.core import hsf
from repro_torch.core import signature as sigmod
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.data.corpus import make_corpus

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)


def _numpy_rowdot(mat, vec):
    """The pinned-order tree with numpy f32 ops, each rounding once."""
    p = (mat.astype(np.float32) * vec.astype(np.float32)[None, :])
    d = p.shape[1]
    width = 1 << max(0, d - 1).bit_length() if d > 1 else 1
    p = np.pad(p, ((0, 0), (0, width - d)))
    while width > 1:
        width //= 2
        p = (p[:, :width] + p[:, width:]).astype(np.float32)
    return p[:, 0]


def _dense(n, d, w, seed):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(n, d)).astype(np.float32)
    vec = rng.normal(size=(d,)).astype(np.float32)
    # full int32 range: roughly half the words carry the sign bit
    sigs = rng.integers(-2**31, 2**31, size=(n, w), dtype=np.int64) \
        .astype(np.int32)
    qsig = sigs[3] & sigs[5]
    return mat, vec, sigs, qsig


def _corpus(dim):
    """The engine's data: doc matrix, signatures, and query arrays."""
    docs, entities = make_corpus(n_docs=60, n_entities=4, seed=dim)
    kb = KnowledgeBase(dim=dim)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    mat, sigs, _ = kb.materialize()
    queries = list(entities) + ["quarterly revenue forecast", "server audit"]
    return mat, sigs, [(kb.vectorizer.query_vector(q),
                        sigmod.query_signature(q, width_words=kb.sig_words))
                       for q in queries]


def _jax_rowdot(mat, vec):
    return np.asarray(jax.jit(ref_hsf.stable_rowdot)(jnp.asarray(mat),
                                                     jnp.asarray(vec)))


@pytest.mark.parametrize("dim,bitwise", [(128, True), (384, True),
                                         (1024, False)])
def test_stable_rowdot_and_scores_on_engine_data(dim, bitwise):
    mat, sigs, queries = _corpus(dim)
    for qv, qs in queries:
        got = hsf.stable_rowdot(torch.from_numpy(mat), torch.from_numpy(qv))
        assert got.dtype == torch.float32 and got.shape == (60,)
        np.testing.assert_array_equal(got.numpy(), _numpy_rowdot(mat, qv))
        for alpha, beta in ((1.0, 1.0), (0.9, 1.3), (1.0, 0.0)):
            want = np.asarray(ref_hsf.hsf_scores(
                jnp.asarray(mat), jnp.asarray(sigs), jnp.asarray(qv),
                jnp.asarray(qs), alpha=alpha, beta=beta))
            got = hsf.hsf_scores(
                torch.from_numpy(mat), torch.from_numpy(sigs),
                torch.from_numpy(qv), torch.from_numpy(qs),
                alpha=alpha, beta=beta).numpy()
            if bitwise:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 3, 100, 128, 384, 1000, 4096])
def test_stable_rowdot_dense_inputs(d):
    """Dense inputs: the port's bits are the separate-op tree's; JAX
    agrees within one FMA's rounding (module docstring)."""
    mat, vec, _, _ = _dense(50, d, 4, d)
    got = hsf.stable_rowdot(torch.from_numpy(mat), torch.from_numpy(vec))
    np.testing.assert_array_equal(got.numpy(), _numpy_rowdot(mat, vec))
    scale = float(np.abs(mat * vec).sum(axis=1).max())
    np.testing.assert_allclose(got.numpy(), _jax_rowdot(mat, vec),
                               rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("per_chunk", [1, 2, 7])
def test_batched_rowdot_is_stable_rowdot_in_any_chunk(monkeypatch,
                                                      per_chunk):
    """``batched_rowdot`` (the HSF top-k plain version's cosines) gives
    each query ``stable_rowdot``'s bits, whatever number of queries its
    chunks of products hold."""
    mat, _, _, _ = _dense(37, 100, 4, 4)
    vecs = np.random.default_rng(5).normal(size=(7, 100)).astype(np.float32)
    monkeypatch.setattr(hsf, "ROWDOT_CHUNK_BYTES", per_chunk * mat.nbytes)
    got = hsf.batched_rowdot(torch.from_numpy(mat), torch.from_numpy(vecs))
    assert got.shape == (7, 37)
    for i, v in enumerate(vecs):
        np.testing.assert_array_equal(got[i].numpy(), _numpy_rowdot(mat, v))


@pytest.mark.parametrize("w", [1, 4, 128])
def test_containment_bit_identical_with_sign_bit_words(w):
    _, _, sigs, qsig = _dense(64, 8, w, w)
    assert (sigs < 0).any()
    want = np.asarray(ref_hsf.containment(jnp.asarray(sigs),
                                          jnp.asarray(qsig)))
    got = hsf.containment(torch.from_numpy(sigs), torch.from_numpy(qsig))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3].item() == got[5].item() == 1.0  # qsig ⊆ both sources
    neg = np.full((2, w), -1, np.int32)  # every bit set, sign bit included
    assert hsf.containment(torch.from_numpy(neg),
                           torch.from_numpy(qsig)).tolist() == [1.0, 1.0]


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.9, 1.3), (1.0, 0.0)])
def test_hsf_scores_dense_inputs(alpha, beta):
    mat, vec, sigs, qsig = _dense(80, 256, 128, 7)
    want = np.asarray(ref_hsf.hsf_scores(
        jnp.asarray(mat), jnp.asarray(sigs), jnp.asarray(vec),
        jnp.asarray(qsig), alpha=alpha, beta=beta))
    got = hsf.hsf_scores(torch.from_numpy(mat), torch.from_numpy(sigs),
                         torch.from_numpy(vec), torch.from_numpy(qsig),
                         alpha=alpha, beta=beta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ind = np.all((sigs & qsig) == qsig, axis=-1).astype(np.float32)
    np.testing.assert_array_equal(
        got.numpy(),
        np.float32(alpha) * _numpy_rowdot(mat, vec) + np.float32(beta) * ind)


def test_hsf_scores_batched_matches_reference_gemm():
    mat, _, sigs, _ = _dense(60, 256, 128, 11)
    rng = np.random.default_rng(12)
    qv = rng.normal(size=(5, 256)).astype(np.float32)
    qs = np.stack([sigs[i] & sigs[i + 1] for i in range(5)])
    want = np.asarray(ref_hsf.hsf_scores_batched(
        jnp.asarray(mat), jnp.asarray(sigs), jnp.asarray(qv),
        jnp.asarray(qs), alpha=0.9, beta=1.3))
    got = hsf.hsf_scores_batched(
        torch.from_numpy(mat), torch.from_numpy(sigs), torch.from_numpy(qv),
        torch.from_numpy(qs), alpha=0.9, beta=1.3)
    # two BLAS libraries, two reduction orders: f32 tolerance
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_numpy_reference_and_top_k_order():
    mat, vec, sigs, qsig = _dense(30, 64, 8, 3)
    np.testing.assert_array_equal(
        hsf.numpy_reference(mat, sigs, vec, qsig, 0.9, 1.3),
        ref_hsf.numpy_reference(mat, sigs, vec, qsig, 0.9, 1.3))
    scores = np.array([[0.5, 2.0, 0.5, 2.0, -np.inf, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 5)
    tv, ti = hsf.top_k(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [[1, 3, 0, 2, 5]]


# ---------------------------------------------------------------------------
# the fused kernel's arithmetic: products as 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------

SCORE_ATOL = 1e-5  # chip_smoke.py's kernel-vs-plain score tolerance


def test_tf32_rna_rounds_to_nearest_with_ties_away():
    from repro_torch.kernels.hsf_score.ref import tf32_rna
    one_ulp = 2.0 ** -10  # TF32 ulp at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp * 1.5,
                      -(1.0 + one_ulp / 2), 1.0 + one_ulp * 0.49, 0.0,
                      3.0e38, 1e-30], dtype=torch.float32)
    got = tf32_rna(x)
    assert got.tolist()[:6] == [1.0, 1.0 + one_ulp, 1.0 + 2 * one_ulp,
                                -(1.0 + one_ulp), 1.0, 0.0]
    rng = np.random.default_rng(0)
    r = torch.from_numpy((rng.normal(size=4096) *
                          10.0 ** rng.integers(-20, 20, 4096)
                          ).astype(np.float32))
    h = tf32_rna(r)
    assert (h.view(torch.int32) & 0x1FFF).eq(0).all()
    # within half a TF32 ulp of x (2^-11 relative)
    rel = ((h.double() - r.double()).abs() / r.double().abs()).max()
    assert rel <= 2.0 ** -11


def test_tf32_split_recovers_f32():
    from repro_torch.kernels.hsf_score.ref import tf32_split
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 1000)).astype(np.float32))
    hi, lo = tf32_split(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("corpus", ["dense-256", "dense-4096", "engine-128",
                                    "engine-384", "engine-1024"])
def test_3xtf32_scores_match_float64_reference(corpus):
    """The kernel's product arithmetic against the float64 oracle, on
    the dense inputs and the engine's data of this file (unit rows, as
    served): within SCORE_ATOL, and far inside it."""
    from repro_torch.kernels.hsf_score.ref import hsf_score_3xtf32
    kind, d = corpus.split("-")
    d = int(d)
    if kind == "dense":
        mat, _, sigs, _ = _dense(120, d, 128, d)
        mat = _unit(mat)
        rng = np.random.default_rng(d + 1)
        qv = _unit(rng.normal(size=(6, d)))
        qs = np.stack([sigs[i] & sigs[i + 1] for i in range(6)])
    else:
        mat, sigs, queries = _corpus(d)
        qv = np.stack([q for q, _ in queries]).astype(np.float32)
        qs = np.stack([s for _, s in queries])
    got = hsf_score_3xtf32(*(torch.from_numpy(a) for a in (mat, sigs, qv, qs)),
                           0.9, 1.3).numpy()
    want = np.stack([hsf.numpy_reference(mat, sigs, q, s, 0.9, 1.3)
                     for q, s in zip(qv, qs)])
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= SCORE_ATOL / 10, err


@pytest.mark.parametrize("k", [5, 16])
def test_3xtf32_top_k_ids_match_the_plain_version(k):
    """Top k of the emulated kernel scores against the plain version's
    (full f32 gemm, stable sort): scores within SCORE_ATOL, ids equal
    wherever the plain scores are more than SCORE_ATOL apart."""
    from repro_torch.kernels.hsf_score.ref import (hsf_score_3xtf32,
                                                   hsf_score_topk_ref)
    mat, _, sigs, _ = _dense(400, 512, 16, 17)
    mat = _unit(mat)
    rng = np.random.default_rng(18)
    qv = _unit(rng.normal(size=(8, 512)))
    qs = np.stack([sigs[i] & sigs[i + 3] for i in range(8)])
    t = [torch.from_numpy(a) for a in (mat, sigs, qv, qs)]
    scores = hsf_score_3xtf32(*t, 1.0, 1.0)
    gv, gi = torch.sort(scores, dim=1, descending=True, stable=True)
    pv, pi = hsf_score_topk_ref(*t, 1.0, 1.0, 400)
    for row in range(8):
        for p in range(k):
            assert abs(float(gv[row, p]) - float(pv[row, p])) <= SCORE_ATOL
            if int(gi[row, p]) != int(pi[row, p]):
                near = pi[row][(pv[row] - pv[row, p]).abs() <= SCORE_ATOL]
                assert int(gi[row, p]) in near.tolist(), (row, p)
