"""The port's attention module (`kernels/flash_attention`,
`models/attention.py`) against the JAX package's, on the CPU.

On CPU tensors the flash wrapper runs its plain version (dense, f32);
it is held to the JAX kernel in interpret mode over the JAX package's
own kernel cases (rtol/atol 2e-3, bf16 5e-2, as `tests/test_kernels.py`
sets them: the interpreted kernel sums in 64-wide blocks), and over the
cases the serving path adds: a query chunk that is a suffix of the keys
(q_offset > 0, Lq < Lk), keys masked by kv_len, and fully masked rows,
which must be exactly 0.  At MLA's unpadded heads (q/k 192, v 128),
which the JAX kernel does not take, it is held to the JAX package's
XLA path (f32 1e-5, bf16 5e-2).  The plain blockwise, banded and decode paths
are held to their XLA counterparts at 2e-4 (f32, another summation
order).  The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as JA
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as A

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

# the reference's XLA paths, each compiled once instead of op by op
_xla_flash = jax.jit(JA.flash_attention_xla, static_argnames=(
    "scale", "causal", "window", "softcap", "q_offset", "block_k"))
_xla_local = jax.jit(JA.local_attention_xla,
                     static_argnames=("scale", "window", "softcap"))


def _qkv(b, hq, hkv, lq, dh, seed, lk=None):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return (rng.normal(size=(b, hq, lq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, dh)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


# ---------------------------------------------------------------------------
# the flash wrapper's plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,l,dh,causal,window,softcap", [
    (2, 4, 2, 128, 64, True, None, None),
    (1, 8, 1, 256, 32, True, None, None),
    (2, 4, 4, 128, 64, True, 32, None),
    (1, 2, 2, 160, 64, True, None, 50.0),
    (1, 4, 2, 96, 64, False, None, None),
    (1, 2, 1, 100, 32, True, 24, 30.0),
    # gemma2's head (Dh 256, softcap 50, GQA 2:1) at a ragged L, with a
    # window that masks and without one
    (1, 4, 2, 100, 256, True, 48, 50.0),
    (2, 2, 1, 100, 256, True, None, 50.0),
])
def test_flash_plain_matches_jax_kernel(b, hq, hkv, l, dh, causal, window,
                                        softcap):
    q, k, v = _qkv(b, hq, hkv, l, dh, seed=l + hq)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(*_t(q, k, v), **kw)
    want = ref_ops.flash_attention(*_j(q, k, v), block_q=64, block_k=64,
                                   **kw)
    assert got.shape == (b, hq, l, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_flash_plain_bf16_matches_jax_kernel():
    q, _, _ = _qkv(1, 2, 2, 128, 64, seed=3)
    got = ops.flash_attention(*_t(q, q, q, dtype=torch.bfloat16))
    want = ref_ops.flash_attention(*_j(q, q, q, dtype=jnp.bfloat16),
                                   block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("lq,lk,q_offset,window,dh,softcap,seed", [
    (40, 200, 160, None, 32, None, 200),   # chunked prefill: the last 40
    (64, 192, 128, 48, 32, None, 192),     # the same with a sliding window
    (1, 77, 76, None, 32, None, 77),       # one query, the decode position
    # gemma2's head: Dh 256, softcap 50
    (40, 140, 100, None, 256, 50.0, 141),  # the last 40 of 140 keys
    (64, 192, 128, 48, 256, 50.0, 193),    # the same with a sliding window
])
def test_flash_query_chunk_matches_jax_kernel(lq, lk, q_offset, window, dh,
                                              softcap, seed):
    """A query chunk (q_offset > 0, Lq < Lk), GQA 2:1."""
    q, k, v = _qkv(1, 4, 2, lq, dh, seed=seed, lk=lk)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    got = ops.flash_attention(*_t(q, k, v), **kw)
    want = ref_ops.flash_attention(*_j(q, k, v), block_q=64, block_k=64,
                                   **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


# deepseek-v2-lite's MLA heads: q/k nope 128 + rope 64, v 128
MLA_QK, MLA_V = 192, 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq,lk,q_offset,kv_len", [
    (2, 64, 64, 0, None),      # causal, one whole 64-row tile
    (1, 40, 40, 0, None),      # ragged L inside one tile
    (1, 130, 130, 0, None),    # ragged L across three tiles
    (1, 100, 611, 511, 555),   # kv_len ending mid-tile
    (1, 40, 200, 160, None),   # q_offset with Lq < Lk
])
def test_flash_plain_mla_heads_match_jax_xla(b, lq, lk, q_offset, kv_len,
                                             dtype):
    """The wrapper's plain route at MLA's unpadded heads (v narrower than
    q/k) against the JAX package's ``attention(..., backend="xla")`` on
    the same heads; keys past kv_len are cut from the JAX operands."""
    rng = np.random.default_rng(lq + lk)
    h = 3
    q = rng.normal(size=(b, h, lq, MLA_QK)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, MLA_QK)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, MLA_V)).astype(np.float32)
    scale = MLA_QK ** -0.5
    tdt, jdt, tol = {"float32": (torch.float32, jnp.float32, 1e-5),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}[dtype]
    got = ops.flash_attention(*_t(q, k, v, dtype=tdt), scale=scale,
                              q_offset=q_offset, kv_len=kv_len)
    kl = lk if kv_len is None else kv_len
    want = JA.attention(*_j(q, k[:, :, :kl], v[:, :, :kl], dtype=jdt),
                        scale=scale, causal=True, q_offset=q_offset,
                        backend="xla")
    assert got.shape == (b, h, lq, MLA_V) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("lq,lk,q_offset,window,softcap,gain", [
    (100, 100, 0, 48, 50.0, 12.0),      # gemma2's cap, logits ~N(0, 12^2)
    (100, 100, 0, None, 50.0, 12.0),
    (100, 100, 0, 48, 5.0, 1.0),        # a cap of 5 on N(0, 1) logits
    (40, 140, 100, None, 50.0, 12.0),   # a query chunk
    (64, 192, 128, 48, 5.0, 1.0),
])
def test_flash_softcap_reached_at_dh256_matches_jax_kernel(
        lq, lk, q_offset, window, softcap, gain):
    """gemma2's head (Dh 256, GQA 2:1) with logits that reach the
    softcap: on N(0, 1) logits a cap of 50 moves none by more than
    ~0.01, so q is scaled by ``gain`` (or the cap is 5).  The cap must
    move the result by far more than the tolerance."""
    q, k, v = _qkv(1, 4, 2, lq, 256, seed=lk + 2, lk=lk)
    kw = dict(scale=gain * 256 ** -0.5, causal=True, window=window,
              q_offset=q_offset)
    got = ops.flash_attention(*_t(q, k, v), softcap=softcap, **kw)
    want = ref_ops.flash_attention(*_j(q, k, v), block_q=64, block_k=64,
                                   softcap=softcap, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    uncapped = ops.flash_attention(*_t(q, k, v), **kw)
    assert (uncapped - got).abs().max().item() > 0.1


def test_flash_kv_len_masks_the_key_suffix():
    """Keys at or past kv_len count as absent: the result equals the
    JAX oracle on the truncated keys."""
    q, k, v = _qkv(2, 4, 2, 30, 16, seed=5, lk=90)
    kv_len = 70
    got = ops.flash_attention(*_t(q, k, v), q_offset=60, kv_len=kv_len)
    want = jax_ref(*_j(q, k[:, :, :kv_len], v[:, :, :kv_len]),
                   scale=16 ** -0.5, q_offset=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_fully_masked_rows_are_exactly_zero():
    """Rows whose window of keys is empty (positions before 0) give 0 in
    both packages, with no NaN from the all-masked softmax."""
    q, k, v = _qkv(1, 4, 2, 96, 32, seed=9)
    kw = dict(causal=True, q_offset=-20)
    got = ops.flash_attention(*_t(q, k, v), **kw).numpy()
    want = np.asarray(ref_ops.flash_attention(*_j(q, k, v), block_q=32,
                                              block_k=32, **kw))
    assert np.isfinite(got).all()
    assert not got[:, :, :20].any() and not want[:, :, :20].any()
    assert np.abs(got[:, :, 20:]).min() >= 0 and got[:, :, 20:].any()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_flash_no_keys_gives_zeros():
    q, k, v = _qkv(1, 2, 1, 8, 16, seed=1, lk=0)
    assert not ops.flash_attention(*_t(q, k, v)).any()
    q, k, v = _qkv(1, 2, 1, 8, 16, seed=1)
    assert not ops.flash_attention(*_t(q, k, v), kv_len=0).any()


# ---------------------------------------------------------------------------
# the wrapper's dispatch, counts and operand rules
# ---------------------------------------------------------------------------

def test_cpu_calls_count_as_plain_not_launches():
    q, k, v = _t(*_qkv(1, 2, 1, 16, 16, seed=2))
    before = dict(ops.counts)
    ops.flash_attention(q, k, v)
    assert ops.counts["launches"] == before["launches"]
    assert ops.counts["plain"] == before["plain"] + 1
    ops.reset_counts()
    assert ops.counts == {"launches": 0, "plain": 0}


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 2, 8, 16), device="meta")
    k = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, k, k)


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("mixed dtype", TypeError), ("head size", ValueError),
    ("groups", ValueError), ("shape", ValueError), ("device", ValueError),
    # unequal widths without a design of their own
    ("qk 192 v 64", ValueError), ("qk 128 v 192", ValueError),
    ("f32 qk 192 v 128", ValueError),
])
def test_kernel_operand_checks_raise(bad, err):
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    v = torch.zeros((1, 2, 8, 16))
    widths = {"qk 192 v 64": (192, 64, torch.bfloat16),
              "qk 128 v 192": (128, 192, torch.bfloat16),
              "f32 qk 192 v 128": (192, 128, torch.float32)}
    if bad in widths:
        dqk, dv, dtype = widths[bad]
        q, k = (torch.zeros(t.shape[:3] + (dqk,), dtype=dtype) for t in (q, k))
        v = torch.zeros(v.shape[:3] + (dv,), dtype=dtype)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed dtype":
        k = k.bfloat16()
    elif bad == "head size":
        q, k, v = (torch.zeros(t.shape[:3] + (24,)) for t in (q, k, v))
    elif bad == "groups":
        k = v = torch.zeros((1, 3, 8, 16))
    elif bad == "shape":
        v = torch.zeros((1, 2, 9, 16))
    else:
        k = k.to("meta")
    with pytest.raises(err):
        ops._check_operands(q, k, v)


def test_head_width_designs():
    """bf16 q/k 192 with v 128 (MLA's heads) has a design of its own;
    equal widths have one in either dtype; other pairs have none, and a
    kernel call with them raises before anything is built."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert ops.has_design(bf16, 192, 128)
    assert not ops.has_design(f32, 192, 128)
    assert not ops.has_design(bf16, 128, 192)
    assert all(ops.has_design(dt, d, d) for d in ops.HEAD_DIMS
               for dt in (bf16, f32))
    assert not ops.has_design(bf16, 192, 192)
    q = torch.zeros((1, 4, 8, 192), dtype=bf16)
    k = torch.zeros((1, 2, 8, 192), dtype=bf16)
    ops._check_operands(q, k, torch.zeros((1, 2, 8, 128), dtype=bf16))


@pytest.mark.parametrize("dqk,dv,dtype", [
    (192, 64, torch.bfloat16), (128, 192, torch.bfloat16),
    (192, 128, torch.float32),
])
def test_kernel_call_without_a_design_raises_before_the_build(
        dqk, dv, dtype, monkeypatch):
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(ops, "_lib", no_build)
    q = torch.zeros((1, 4, 8, dqk), dtype=dtype)
    k = torch.zeros((1, 2, 8, dqk), dtype=dtype)
    v = torch.zeros((1, 2, 8, dv), dtype=dtype)
    with pytest.raises(ValueError, match="no design"):
        ops._launch(q, k, v, dqk ** -0.5, True, None, None, 0, 8)


def test_strided_operands_are_read_in_place():
    """The projections' [B, L, H, Dh] → [B, H, L, Dh] views go to the
    kernel by their strides; a layout it cannot read is copied."""
    x = torch.zeros((2, 10, 4, 16))
    view = x.transpose(1, 2)
    assert ops._row_strides(view) == (640, 16, 64)
    t, strides = ops._readable(view)
    assert t is view and strides == (640, 16, 64)
    assert ops._row_strides(x[:1].transpose(1, 2)) == (0, 16, 64)
    odd = torch.zeros((1, 2, 8, 17))[..., :16]  # rows not 16-byte aligned
    assert ops._row_strides(odd) is None
    t, strides = ops._readable(odd)
    assert t.is_contiguous() and strides == (0, 128, 16)
    assert ops._row_strides(x.transpose(2, 3)) is None  # inner stride != 1


def test_build_target_for_the_flash_source():
    target = build._target("flash_attention")
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith("libflash_attention.")
    assert (build.CSRC / "flash_attention.cu").exists()


# ---------------------------------------------------------------------------
# the plain paths against the JAX package's XLA paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap,q_offset,lq,block_k", [
    (True, 48, None, 0, 128, 64),
    (True, None, 50.0, 0, 100, 32),
    (False, None, None, 0, 96, 1024),
    (True, 24, 30.0, 50, 50, 16),
])
def test_blockwise_matches_xla_flash(causal, window, softcap, q_offset, lq,
                                     block_k):
    lk = lq + q_offset
    q, k, v = _qkv(2, 4, 2, lq, 32, seed=lq + block_k, lk=lk)
    kw = dict(scale=32 ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, block_k=block_k)
    got = A.flash_attention_blockwise(*_t(q, k, v), **kw)
    want = _xla_flash(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("l,window,softcap", [(64, 16, None), (70, 16, 50.0)])
def test_local_attention_matches_xla_banded(l, window, softcap):
    q, k, v = _qkv(1, 4, 2, l, 16, seed=l)
    kw = dict(scale=16 ** -0.5, window=window, softcap=softcap)
    got = A.local_attention(*_t(q, k, v), **kw)
    want = _xla_local(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window,softcap", [(None, None), (12, 30.0)])
def test_decode_attention_matches_jax(window, softcap):
    q, k, v = _qkv(3, 4, 2, 1, 16, seed=7, lk=40)
    lengths = np.array([40, 17, 1], np.int32)
    kw = dict(scale=16 ** -0.5, window=window, softcap=softcap)
    got = A.decode_attention(*_t(q, k, v), torch.from_numpy(lengths), **kw)
    want = JA.decode_attention(*_j(q, k, v), jnp.asarray(lengths), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    got = A.decode_attention(*_t(q, k, v), 25, **kw)
    want = JA.decode_attention(*_j(q, k, v), 25, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_masked_decode_attention_matches_jax():
    q, k, v = _qkv(2, 4, 2, 1, 16, seed=8, lk=24)
    mask = np.random.default_rng(8).random((2, 24)) < 0.5
    mask[1] = False  # a sequence with no valid slot gives 0
    got = A.masked_decode_attention(*_t(q, k, v), torch.from_numpy(mask),
                                    scale=0.25, softcap=20.0)
    want = JA.masked_decode_attention(*_j(q, k, v), jnp.asarray(mask),
                                      scale=0.25, softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert not got[1].any()


def test_dispatch_follows_the_reference():
    """"blockwise" takes the banded path exactly where the reference's
    "xla" does; "auto" is blockwise on the CPU; "kernel" goes through
    the flash wrapper."""
    q, k, v = _t(*_qkv(1, 4, 2, 40, 16, seed=4))
    kw = dict(scale=0.25, causal=True, window=16)
    np.testing.assert_array_equal(
        A.attention(q, k, v, backend="blockwise", **kw).numpy(),
        A.local_attention(q, k, v, scale=0.25, window=16).numpy())
    np.testing.assert_array_equal(
        A.attention(q, k, v, backend="auto", **kw).numpy(),
        A.attention(q, k, v, backend="blockwise", **kw).numpy())
    np.testing.assert_array_equal(
        A.attention(q, k, v, backend="blockwise", q_offset=3, **kw).numpy(),
        A.flash_attention_blockwise(q, k, v, q_offset=3, **kw).numpy())
    before = ops.counts["plain"]
    out = A.attention(q, k, v, backend="kernel", **kw)
    assert ops.counts["plain"] == before + 1
    np.testing.assert_allclose(
        out.numpy(), A.attention(q, k, v, **kw).numpy(), rtol=2e-4,
        atol=2e-4)
    assert A.resolve_backend("auto", "cuda") == "kernel"
    with pytest.raises(ValueError, match="backend"):
        A.attention(q, k, v, backend="pallas", **kw)


# ---------------------------------------------------------------------------
# the wgmma kernel's softmax: base 2, tile by tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap,q_offset,kv_len,lq,lk", [
    (True, None, None, 0, None, 200, 200),
    (True, None, 50.0, 0, None, 130, 130),
    (False, None, None, 0, None, 96, 150),
    (True, 40, 30.0, 0, None, 160, 160),
    (True, None, None, 512, 590, 100, 612),
    (True, None, None, -40, None, 128, 128),  # rows 0..39 see no key
    (True, 16, None, -70, None, 100, 100),    # and a window past them
])
def test_base2_tile_softmax_matches_attention_ref(causal, window, softcap,
                                                  q_offset, kv_len, lq, lk):
    """The kernel's per-tile update (logits × log2 e, exp2, -1e30
    masking, p × mask, rescale by 2^(m - m')) equals the dense softmax,
    and a row with no key in the mask is exactly 0, never NaN."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_base2_tiles, attention_ref)
    q, k, v = _t(*_qkv(1, 6, 2, lq, 32, lq + lk, lk=lk))
    kw = dict(scale=32 ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    got = attention_base2_tiles(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()
