"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

Keeps the JAX package's ``flash_attention`` contract: q [B, Hq, Lq, Dh]
against k, v [B, Hkv, Lk, Dh], output [B, Hq, Lq, Dh] in q's type; GQA,
causal, sliding window, tanh softcap, ``q_offset`` for a query chunk
that is a suffix of the keys, keys at or past ``kv_len`` masked, zeros
for rows with no key in the mask.  The TPU tiling knobs (``block_q``,
``block_k``, ``interpret``) are gone, and nothing is padded: the kernel
masks the ragged edges itself.

v may be narrower than q and k (the JAX package's XLA path takes any
v width; the output has v's): the kernel has a design for equal widths
in ``HEAD_DIMS`` and for the pairs in ``PAIR_DESIGNS`` (MLA's q/k 192
with v 128, in bf16), and ``has_design`` says which a call gets.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises — wrong dtype, device, shape or head
sizes without a design, a failed build, a launch error); a CPU tensor
takes the plain version in ``ref.py``, counted apart as ``plain``.

The kernel is forward-only (as the reference's, which has no
``custom_vjp``): where autograd would need its backward — a CUDA
operand that requires grad while grad is enabled — the wrapper raises
(``refuse_grad``) instead of returning a result with no gradient, and
never falls back to the plain version.  Training runs the attention's
``"blockwise"`` backend.  On the CPU the plain version, which has a
gradient, runs as before.

Operands are passed by their (batch, head, row) strides, so transposed
projections are read in place.  An operand whose innermost stride is
not 1, or whose rows are not 16-byte aligned, is copied to a contiguous
tensor first (a layout copy, not another path).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.flash_attention.ref import attention_ref

# head sizes with a design when q, k and v are equally wide (either dtype)
HEAD_DIMS = (16, 32, 64, 128, 256)
# (q/k width, v width) pairs of unequal widths with a design, by dtype
PAIR_DESIGNS = {torch.bfloat16: ((192, 128),)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1

_counts_lock = threading.Lock()
# launches: kernel launches; plain: calls served by ref.py (CPU tensors)
counts = {"launches": 0, "plain": 0}
counters.register("flash_attention", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str) -> None:
    counters.bump("flash_attention", key)


def has_design(dtype: torch.dtype, d_qk: int, d_v: int) -> bool:
    """Whether the kernel has a design for q/k heads ``d_qk`` and v heads
    ``d_v`` wide in ``dtype``."""
    if d_qk == d_v:
        return dtype in _DTYPES and d_qk in HEAD_DIMS
    return (d_qk, d_v) in PAIR_DESIGNS.get(dtype, ())


def refuse_grad(device_type: str, requires_grad, grad_enabled: bool) -> None:
    """Raise where the kernel's missing backward would be needed: on
    ``cuda``, with grad enabled and any operand (``requires_grad``, one
    flag per operand) requiring grad."""
    if device_type == "cuda" and grad_enabled and any(requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward, and an "
            "operand requires grad; train with the blockwise attention "
            "(backend='blockwise') or call under torch.no_grad()")


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p, strides as
    64-bit ints)."""
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p] + [i] * 8 + [ll] * 9 + [f, i, i, i, i, f, i, i, p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_design.argtypes = [i, i, i, p]
    lib.flash_attention_design.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(q, k, v) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B, H, L, Dh], got "
                             f"{tuple(t.shape)}")
    b, hq, lq, dh = q.shape
    dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group onto {hkv} kv heads")
    if not has_design(q.dtype, dh, dv):
        pairs = PAIR_DESIGNS.get(q.dtype, ())
        raise ValueError(
            f"no design for {str(q.dtype)[6:]} heads of q/k {dh}, v {dv}: "
            f"equal widths take {HEAD_DIMS}, unequal ones {pairs}")
    if max(b, hq, lq, k.shape[2]) > _INT_MAX or b > 65535 or hq > 65535:
        raise ValueError("dimensions exceed the kernel's grid")


def _row_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(batch, head, row) strides in elements, or None when the kernel
    cannot read ``t`` in place (innermost stride not 1, rows not 16-byte
    aligned).  Dims of size 1 are never stepped, so their stride is 0."""
    if t.stride(3) != 1 or t.data_ptr() % 16:
        return None
    out = []
    for dim in range(3):
        stride = t.stride(dim) if t.shape[dim] > 1 else 0
        if (stride * t.element_size()) % 16:
            return None
        out.append(stride)
    return tuple(out)


def _readable(t: torch.Tensor):
    strides = _row_strides(t)
    if strides is None:
        t = t.clone(memory_format=torch.contiguous_format)
        strides = _row_strides(t)
    return t, strides


def _launch(q, k, v, scale, causal, window, softcap, q_offset, kv_len):
    _check_operands(q, k, v)
    b, hq, lq, dh = q.shape
    dv = v.shape[3]
    hkv, lk = k.shape[1], k.shape[2]
    for name, val in (("q_offset", q_offset), ("window", window or 0)):
        if abs(val) > _INT_MAX // 2:
            raise ValueError(f"{name}={val} exceeds the kernel's int32 range")
    kv_len = max(0, min(kv_len, lk))
    lib = _lib()
    q, qs = _readable(q)
    k, ks = _readable(k)
    v, vs = _readable(v)
    out = torch.empty((b, hq, lq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, lq, lk, dh, dv, *qs, *ks, *vs,
            float(scale), int(bool(causal)), int(window is not None),
            int(window or 0), int(softcap is not None),
            float(softcap or 0.0), int(q_offset), kv_len, stream)
    if err != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    _bump("launches")
    return out


def design(dtype: torch.dtype, d_qk: int, d_v: int) -> dict:
    """The kernel design that serves (dtype, d_qk, d_v) on the current
    card: its dynamic shared memory per CTA (``smem``, bytes), threads
    per CTA and the CTAs that fit on one SM (the occupancy calculator).
    Builds the library; raises where there is no design."""
    if not has_design(dtype, d_qk, d_v):
        raise ValueError(f"no design for {dtype} heads {d_qk}/{d_v}")
    lib = _lib()
    out = (ctypes.c_int * 3)()
    err = lib.flash_attention_design(_DTYPES[dtype], d_qk, d_v, out)
    if err != 0:
        raise RuntimeError(
            "flash_attention_design failed: "
            f"{lib.flash_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    return {"smem": out[0], "threads": out[1], "ctas_per_sm": out[2]}


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Lq, Dh]
    k: torch.Tensor,  # [B, Hkv, Lk, Dh]
    v: torch.Tensor,  # [B, Hkv, Lk, Dv]
    *,
    scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Blockwise attention, [B, Hq, Lq, Dv] in q's type.

    ``scale`` defaults to Dh^-1/2.  ``q_offset`` is the absolute
    position of q[..., 0, :] (a query chunk that is a suffix of the
    keys); ``kv_len`` (default Lk) masks the keys from that position on.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lk = k.shape[2]
    kv_len = lk if kv_len is None else int(kv_len)
    refuse_grad(q.device.type, (q.requires_grad, k.requires_grad,
                                 v.requires_grad), torch.is_grad_enabled())
    if q.device.type == "cuda":
        if q.shape[0] == 0 or q.shape[1] == 0 or q.shape[2] == 0:
            _check_operands(q, k, v)
            return q.new_empty(q.shape[:3] + v.shape[3:])
        return _launch(q, k, v, scale, causal, window, softcap, q_offset,
                       kv_len)
    if q.device.type == "cpu":
        _bump("plain")
        if lk == 0:
            return q.new_zeros(q.shape[:3] + v.shape[3:])
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap,
                             q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"no flash_attention for device {q.device}")
