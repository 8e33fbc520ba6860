"""Wrapper of the top-k kernel (``csrc/topk.cu``, a radix select).

Keeps the JAX package's ``top_k`` contract: (values [k] f32, ids [k]
int32) of a score vector [N], ordered (score desc, id asc), k ≤
min(N, 128).  Where the JAX wrapper asserts (k > N, k > 128) this one
raises ``ValueError``.  A slot holding -inf carries the sentinel id
2³¹−1, as the JAX kernel gives it whenever the vector fits one of its
blocks (N ≤ 1,024).  A NaN of either sign ranks above +inf, NaNs in id
order, each with its own id and bits: the JAX kernel's order, the plain
version's and the kernel's.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or raises — wrong dtype, device or layout, a
failed build, a launch error); a CPU tensor takes the plain version in
``ref.py``.  On the card a call is a fixed launch sequence for its N
(one launch up to 262,144 scores, a memset and three launches above)
that reads nothing back to the host, so it can be captured in a CUDA
graph.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.topk.ref import ID_SENTINEL, top_k_ref

KPAD = 128  # widest k the kernel serves

_counts_lock = threading.Lock()
# launches: kernel calls (the multi-launch path of one call counts once)
counts = {"launches": 0}
counters.register("topk", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str) -> None:
    counters.bump("topk", key)


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p, N as a 64-bit
    int)."""
    from repro_torch.kernels import build

    lib = build.load("topk")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_launch.argtypes = [p, ll, i, p, p, p, p]
    lib.topk_launch.restype = ctypes.c_int
    lib.topk_scratch_bytes.argtypes = [ll]
    lib.topk_scratch_bytes.restype = ll
    lib.topk_kernels_for.argtypes = [ll]
    lib.topk_kernels_for.restype = i
    lib.topk_error_string.argtypes = [i]
    lib.topk_error_string.restype = ctypes.c_char_p
    return lib


def _launch(scores: torch.Tensor, k: int):
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be torch.float32, got {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    n = scores.shape[0]
    if n >= ID_SENTINEL:
        raise ValueError("N must stay below the sentinel id 2**31 - 1")
    lib = _lib()
    dev = scores.device
    # the state, the segment maxima and a candidate buffer of N keys, for
    # N past the one-launch path; nothing is read back, so a call can be
    # captured
    scratch = torch.empty((max(1, lib.topk_scratch_bytes(n)),),
                          dtype=torch.uint8, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    ids = torch.empty((k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.topk_launch(scores.data_ptr(), n, k, scratch.data_ptr(),
                              vals.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"topk launch failed: {lib.topk_error_string(err).decode()} "
            f"(cudaError {err})")
    _bump("launches")
    return vals, ids


def top_k(scores: torch.Tensor, k: int):
    """Top-k: (values [k] f32, ids [k] int32), ordered
    (score desc, id asc); needs 1 ≤ k ≤ min(N, 128)."""
    if scores.dim() != 1:
        raise ValueError(f"scores must be 1-D, got {tuple(scores.shape)}")
    n = scores.shape[0]
    if not 1 <= k <= min(n, KPAD):
        raise ValueError(f"top_k needs 1 <= k <= min(N, {KPAD}); got k={k}, "
                         f"N={n}")
    if scores.device.type == "cuda":
        return _launch(scores, k)
    if scores.device.type == "cpu":
        return top_k_ref(scores, k)
    raise ValueError(f"no top_k for device {scores.device}")
