"""Wrapper of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

Keeps the JAX package's ``embedding_bag`` contract:
out[b] = Σ_{seg[i]==b} w[i] · table[idx[i]] as [n_bags, E] in the
table's dtype (f32, or bf16 summed in f32); segments in any order (a
stable sort by segment happens here); bags with no index are zero;
``mean`` divides by the bag's count.  Segment ids belong in
[0, n_bags): the kernel path drops others, as ``segment_sum`` does, and
the plain version raises.  A row id outside [0, V) stops the kernel (a
device-side trap).  No index at all (n = 0) raises ``TypeError``, as
the JAX package's wrapper does (its kernel does not trace on an empty
grid).

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises — wrong dtype, device or layout, a
failed build, a launch error); a CPU tensor takes the plain version in
``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_counts_lock = threading.Lock()
# launches: kernel launches; plain: calls on CPU tensors (the plain version)
counts = {"launches": 0, "plain": 0}
counters.register("embedding_bag", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str) -> None:
    counters.bump("embedding_bag", key)


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p, V as a 64-bit
    int)."""
    from repro_torch.kernels import build

    lib = build.load("embedding_bag")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embedding_bag_launch.argtypes = [p, ll, i, i, p, p, p, i, i, p, p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [i]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def prepare(indices: torch.Tensor, segment_ids: torch.Tensor, n_bags: int,
            weights: torch.Tensor | None = None):
    """The kernel's operands on the inputs' device: row ids (int32) and
    weights (f32, or None) in a stable order by segment, and the bags'
    CSR offsets [n_bags + 1] (int64) into them."""
    seg, order = torch.sort(segment_ids.to(torch.int32), stable=True)
    idx = indices.to(torch.int32)[order].contiguous()
    w = None if weights is None else \
        weights.to(torch.float32)[order].contiguous()
    bounds = torch.arange(n_bags + 1, dtype=torch.int32, device=seg.device)
    return idx, w, torch.searchsorted(seg, bounds)


def launch(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor | None,
           offsets: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """One kernel launch on ``prepare``'s operands; [n_bags, E] in the
    table's dtype."""
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    operands = [("table", table, table.dtype, 2), ("idx", idx, torch.int32, 1),
                ("offsets", offsets, torch.int64, 1)]
    if w is not None:
        operands.append(("weights", w, torch.float32, 1))
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    for name, t, dtype, dim in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if w is not None and w.shape != idx.shape:
        raise ValueError(f"weights {tuple(w.shape)} != idx {tuple(idx.shape)}")
    v, e = table.shape
    n_bags = offsets.shape[0] - 1
    if n_bags >= 2**31 or e >= 2**31:
        raise ValueError("n_bags and E must stay below 2**31")
    out = torch.empty((n_bags, e), dtype=table.dtype, device=dev)
    if n_bags == 0 or e == 0:
        return out
    if v == 0:
        raise ValueError("the table has no rows")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), v, e, _DTYPES[table.dtype], idx.data_ptr(),
            None if w is None else w.data_ptr(), offsets.data_ptr(), n_bags,
            int(mode == "mean"), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"embedding_bag launch failed: "
            f"{lib.embedding_bag_error_string(err).decode()} (cudaError {err})")
    _bump("launches")
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Fused bag reduce: out[b] = Σ_{i: seg[i]==b} w[i] · table[idx[i]]."""
    if table.dim() != 2 or indices.dim() != 1 \
            or segment_ids.shape != indices.shape \
            or (weights is not None and weights.shape != indices.shape):
        raise ValueError(
            f"need table [V, E] and 1-D indices, segment_ids, weights of "
            f"one length; got {tuple(table.shape)}, {tuple(indices.shape)}, "
            f"{tuple(segment_ids.shape)}, "
            f"{None if weights is None else tuple(weights.shape)}")
    if indices.shape[0] == 0:
        raise TypeError("embedding_bag needs at least one index (n = 0), as "
                        "the JAX package's kernel does")
    if table.device.type == "cuda":
        idx, w, offsets = prepare(indices, segment_ids, n_bags, weights)
        return launch(table, idx, w, offsets, mode)
    if table.device.type == "cpu":
        _bump("plain")
        return embedding_bag_ref(table, indices, segment_ids, n_bags,
                                 weights, mode)
    raise ValueError(f"no embedding_bag for device {table.device}")
