"""Wrapper of the decode attention core (``csrc/decode_attention.cu``).

One new token a row after its q/k/v projections: qk-norm and RoPE at
position length - 1, the new k and v written into slot (length - 1) % S
of the bf16 cache in place, one-token attention over the slots below the
fill; [B, Hq, 1, Dh] in bf16.  ``ref.py`` is the same function in plain
PyTorch (what the decode step computed before the kernel).

``has_design`` says from the operands alone whether the kernel takes a
call: bf16 throughout, a head size in ``HEAD_DIMS``, at most ``MAX_GROUP``
query heads a kv head, one new k/v head per cache head (no kv
replication), no softcap and no window (a linear cache).  The decode
step routes the rest (ring caches, gemma2's softcapped Dh 256, kv
replication, float32, the SMOKE heads) to its plain path.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises — operands without a design, wrong
device or layout, a failed build, a launch error); any other device
takes ``ref.py``, counted apart as ``plain``.  A launch is two kernels
(the splits, then their merge), counted as one.  Nothing waits on the
device: the fill is read there, and the scratch comes from
``torch.empty``, so the decode step still captures into a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (128,)
MAX_GROUP = 8  # query heads a kv head
TILE = 64  # cache rows a CTA stages at a time (the kernel's kTile)
EPS = 1e-6  # layers.rms_norm's

_counts_lock = threading.Lock()
# launches: kernel launches; plain: calls served by ref.py
counts = {"launches": 0, "plain": 0}
counters.register("decode_attention", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str) -> None:
    counters.bump("decode_attention", key)


def has_design(q, k_new, v_new, k_cache, v_cache, *, softcap=None,
               window=None) -> bool:
    """Whether the kernel takes q [B, Hq, 1, Dh], k_new, v_new [B, Hkv,
    1, Dh] against k_cache, v_cache [B, Hkv, S, Dh] with this softcap
    and window."""
    ts = (q, k_new, v_new, k_cache, v_cache)
    if softcap is not None or window is not None \
            or any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in ts):
        return False
    b, hq, lq, dh = q.shape
    hkv = k_cache.shape[1]
    return (lq == 1 and dh in HEAD_DIMS and hkv > 0 and hq % hkv == 0
            and hq // hkv <= MAX_GROUP
            and k_new.shape == v_new.shape == (b, hkv, 1, dh)
            and k_cache.shape == v_cache.shape
            and k_cache.shape[0] == b and k_cache.shape[3] == dh)


def splits(b: int, hkv: int, n_slots: int, n_sm: int) -> int:
    """How many slices of the filled slots each (row, kv head) gets: about
    two CTAs an SM, and no more slices than 64-row tiles in the cache."""
    return max(1, min(-(-n_slots // TILE), -(-2 * n_sm // (b * hkv))))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p, strides as
    64-bit ints)."""
    from repro_torch.kernels import build

    lib = build.load("decode_attention")
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.decode_attention_launch.argtypes = (
        [p] * 11 + [i] * 6 + [ll] * 12 + [f] * 3 + [p])
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _head_strides(t: torch.Tensor):
    """(t, its batch and head strides), t copied where its rows are not
    contiguous."""
    if t.stride(3) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def _cache_strides(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    """The cache's (batch, head, row) strides; it is written in place, so
    a layout the kernel cannot read raises."""
    strides = t.stride()[:3]
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 8 for s in strides):
        raise ValueError(f"{name} must have contiguous 16-byte-aligned "
                         f"rows; got strides {t.stride()}")
    return strides


def _launch(q, k_new, v_new, k_cache, v_cache, lengths, scale, rope_base,
            q_norm, k_norm):
    dev = q.device
    for name, t in (("k_new", k_new), ("v_new", v_new),
                    ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    lengths = lengths.to(torch.int32).contiguous()  # no copy when it is
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm come together")
    for name, w in (("q_norm", q_norm), ("k_norm", k_norm)):
        if w is not None and (w.device != dev or w.dtype != torch.float32
                              or w.shape != (q.shape[3],)
                              or not w.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{q.shape[3]}] on {dev}")
    b, hq, _, dh = q.shape
    hkv, n_slots = k_cache.shape[1], k_cache.shape[2]
    if b > 65535 or hkv > 65535 or max(hq, n_slots) > 2**31 - 1:
        raise ValueError("dimensions exceed the kernel's grid")
    kc = _cache_strides("k_cache", k_cache)
    vc = _cache_strides("v_cache", v_cache)
    q, *qs = _head_strides(q)
    k_new, *ks = _head_strides(k_new)
    v_new, *vs = _head_strides(v_new)
    lib = _lib()
    n_split = splits(b, hkv, n_slots, _sm_count(dev.index))
    part_o = torch.empty((b, hq, n_split, dh), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((b, hq, 1, dh), dtype=q.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), ptr(q_norm), ptr(k_norm),
            lengths.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), b, hq, hkv, n_slots, dh, n_split, *qs, *ks, *vs,
            *kc, *vc, float(scale), float(rope_base), EPS, stream)
    if err != 0:
        raise RuntimeError(
            "decode_attention launch failed: "
            f"{lib.decode_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    _bump("launches")
    return out


def decode_attention(q, k_new, v_new, k_cache, v_cache, lengths, *,
                     scale: float, rope_base: float, q_norm=None,
                     k_norm=None) -> torch.Tensor:
    """[B, Hq, 1, Dh]: the projections' q [B, Hq, 1, Dh], k_new and v_new
    [B, Hkv, 1, Dh] normalised (gains ``q_norm``, ``k_norm`` applied as
    1 + w, or none) and rotated at position length - 1, k_new and v_new
    written into the linear cache [B, Hkv, S, Dh] in place, and q
    attended over the slots below ``lengths`` [B] (int32, the fill
    including this token) at ``scale``."""
    if q.device.type == "cuda":
        if not has_design(q, k_new, v_new, k_cache, v_cache):
            raise ValueError(
                f"no decode_attention design for q {tuple(q.shape)} "
                f"{q.dtype}, k_new {tuple(k_new.shape)}, cache "
                f"{tuple(k_cache.shape)} {k_cache.dtype}: bf16, heads of "
                f"{HEAD_DIMS}, up to {MAX_GROUP} query heads a kv head, one "
                "new k/v head a cache head")
        return _launch(q, k_new, v_new, k_cache, v_cache, lengths, scale,
                       rope_base, q_norm, k_norm)
    _bump("plain")
    return decode_attention_ref(q, k_new, v_new, k_cache, v_cache, lengths,
                                scale=scale, rope_base=rope_base,
                                q_norm=q_norm, k_norm=k_norm)
