"""Wrappers of the HSF kernels: the fused batched top-k
(``csrc/hsf_topk.cu``) and the single-query score (``csrc/hsf_score.cu``).

Keeps the JAX package's ``hsf_score_batched`` / ``pad_docs_for_kernel``
signatures and contract: (vals [B, k'], ids [B, k']), k' = min(k, N),
ordered (score desc, id asc); rows ``>= n_valid`` score -inf; slots
that cannot fill carry (-inf, ``ID_SENTINEL``).  ``hsf_score`` keeps
the JAX package's single-query contract: f32 [N] scores, f32 or bf16
docs and query summed in f32, n = 0 → an empty vector with no launch.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises — wrong dtype, device or layout, a
failed build, a launch error); a CPU tensor takes the plain version in
``ref.py``.  k' > ``KPAD`` is a shape rule, not a failure path: like
the JAX package (whose VMEM carry is 128 wide) it is served by the
unfused plain version on either device, and counted apart from kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels.hsf_score.ref import (
    hsf_score_ref,
    hsf_score_topk_ref,
)

KPAD = 128               # widest k the kernel serves
ID_SENTINEL = 2**31 - 1  # id of never-filled slots

_counts_lock = threading.Lock()
# launches: fused kernel launches (both passes of one call count once);
# unfused: k > KPAD calls served by the plain version
counts = {"launches": 0, "unfused": 0}
# launches of the single-query kernel (``hsf_score``)
single_counts = {"launches": 0}
_SINGLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    with _counts_lock:
        for table in (counts, single_counts):
            for key in table:
                table[key] = 0


def _bump(key: str, table=counts) -> None:
    with _counts_lock:
        table[key] += 1


def pad_docs_for_kernel(doc_vecs, doc_sigs, block_docs: int = 512):
    """Kept for the engine's and snapshot's operand cache.  The CUDA
    kernel masks the ragged doc edge itself and the plain version needs
    no alignment, so the operands come back unchanged."""
    del block_docs
    return doc_vecs, doc_sigs


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p, never as a
    32-bit int)."""
    from repro_torch.kernels import build

    lib = build.load("hsf_topk")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hsf_topk_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f,
                                    p, p, p, p, p]
    lib.hsf_topk_launch.restype = ctypes.c_int
    lib.hsf_topk_tiles_for.argtypes = [i]
    lib.hsf_topk_tiles_for.restype = ctypes.c_int
    lib.hsf_topk_error_string.argtypes = [i]
    lib.hsf_topk_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _single_lib():
    """The single-query kernel's library, signatures declared."""
    from repro_torch.kernels import build

    lib = build.load("hsf_score")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hsf_score_launch.argtypes = [p, p, p, p, i, i, i, i, f, f, p, p]
    lib.hsf_score_launch.restype = ctypes.c_int
    lib.hsf_score_max_words.argtypes = []
    lib.hsf_score_max_words.restype = ctypes.c_int
    lib.hsf_score_error_string.argtypes = [i]
    lib.hsf_score_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(doc_vecs, doc_sigs, query_vecs, query_sigs) -> None:
    dev = doc_vecs.device
    for name, t, dtype in (("doc_vecs", doc_vecs, torch.float32),
                           ("doc_sigs", doc_sigs, torch.int32),
                           ("query_vecs", query_vecs, torch.float32),
                           ("query_sigs", query_sigs, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, doc_vecs on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if doc_sigs.shape[0] != doc_vecs.shape[0] \
            or query_vecs.shape[0] != query_sigs.shape[0] \
            or query_vecs.shape[1] != doc_vecs.shape[1] \
            or query_sigs.shape[1] != doc_sigs.shape[1]:
        raise ValueError(
            f"shape mismatch: docs {tuple(doc_vecs.shape)}/"
            f"{tuple(doc_sigs.shape)}, queries {tuple(query_vecs.shape)}/"
            f"{tuple(query_sigs.shape)}")
    if max(doc_vecs.shape[0], doc_vecs.shape[1], doc_sigs.shape[1],
           query_vecs.shape[0]) >= 2**31:
        raise ValueError("dimensions must fit the kernel's int32 indices")


def _launch(doc_vecs, doc_sigs, query_vecs, query_sigs, k, alpha, beta,
            n_valid):
    _check_operands(doc_vecs, doc_sigs, query_vecs, query_sigs)
    lib = _lib()
    n, d = doc_vecs.shape
    b, w = query_sigs.shape
    tiles = lib.hsf_topk_tiles_for(n)
    dev = doc_vecs.device
    cand_v = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hsf_topk_launch(
            doc_vecs.data_ptr(), doc_sigs.data_ptr(), query_vecs.data_ptr(),
            query_sigs.data_ptr(), n, d, w, b, n_valid, k,
            float(alpha), float(beta), cand_v.data_ptr(), cand_i.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"hsf_topk launch failed: {lib.hsf_topk_error_string(err).decode()}"
            f" (cudaError {err})")
    _bump("launches")
    return vals, ids


def _with_sentinels(vals, ids):
    return vals, ids.masked_fill(torch.isneginf(vals), ID_SENTINEL)


def hsf_score_batched(
    doc_vecs,    # [N, D] float32
    doc_sigs,    # [N, W] int32
    query_vecs,  # [B, D] float32
    query_sigs,  # [B, W] int32
    *,
    k: int,
    alpha: float = 1.0,
    beta: float = 1.0,
    n_valid=None,
):
    """Fused batched HSF + top-k: (vals [B, k'], ids [B, k']),
    k' = min(k, N), ordered by (score desc, doc-id asc).

    ``n_valid`` (default N; an int or a one-element tensor) masks a
    suffix of the corpus; rows that cannot fill (k' > n_valid) carry
    -inf scores with sentinel ids (2³¹−1).
    """
    n = doc_vecs.shape[0]
    b = query_vecs.shape[0]
    k_eff = min(k, n)
    if n == 0 or b == 0 or k_eff <= 0:
        shape = (b, max(k_eff, 0))
        return (torch.zeros(shape, dtype=torch.float32,
                            device=doc_vecs.device),
                torch.zeros(shape, dtype=torch.int32, device=doc_vecs.device))
    n_valid = n if n_valid is None else int(n_valid)

    if k_eff > KPAD:
        _bump("unfused")
        return _with_sentinels(*hsf_score_topk_ref(
            doc_vecs, doc_sigs, query_vecs, query_sigs, alpha, beta,
            k_eff, n_valid=n_valid))
    if doc_vecs.device.type == "cuda":
        return _launch(doc_vecs, doc_sigs, query_vecs, query_sigs, k_eff,
                       alpha, beta, n_valid)
    if doc_vecs.device.type == "cpu":
        return _with_sentinels(*hsf_score_topk_ref(
            doc_vecs, doc_sigs, query_vecs, query_sigs, alpha, beta,
            k_eff, n_valid=n_valid))
    raise ValueError(f"no hsf_score_batched for device {doc_vecs.device}")


def _check_single(doc_vecs, doc_sigs, query_vec, query_sig) -> None:
    dev = doc_vecs.device
    if doc_vecs.dtype not in _SINGLE_DTYPES \
            or query_vec.dtype != doc_vecs.dtype:
        raise TypeError(
            "doc_vecs and query_vec must both be float32 or both "
            f"bfloat16, got {doc_vecs.dtype} and {query_vec.dtype}")
    for name, t, dim in (("doc_vecs", doc_vecs, 2), ("doc_sigs", doc_sigs, 2),
                         ("query_vec", query_vec, 1),
                         ("query_sig", query_sig, 1)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, doc_vecs on {dev}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    for name, t in (("doc_sigs", doc_sigs), ("query_sig", query_sig)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    n, d = doc_vecs.shape
    if doc_sigs.shape[0] != n or query_vec.shape[0] != d \
            or query_sig.shape[0] != doc_sigs.shape[1]:
        raise ValueError(
            f"shape mismatch: docs {tuple(doc_vecs.shape)}/"
            f"{tuple(doc_sigs.shape)}, query {tuple(query_vec.shape)}/"
            f"{tuple(query_sig.shape)}")
    if n >= 2**31:
        raise ValueError("N must fit the kernel's int32 row index")


def _launch_single(doc_vecs, doc_sigs, query_vec, query_sig, alpha, beta):
    _check_single(doc_vecs, doc_sigs, query_vec, query_sig)
    lib = _single_lib()
    n, d = doc_vecs.shape
    w = doc_sigs.shape[1]
    if d + w > lib.hsf_score_max_words():
        raise ValueError(
            f"D + W = {d + w} exceeds the kernel's shared-memory query "
            f"buffer of {lib.hsf_score_max_words()} words")
    out = torch.empty((n,), dtype=torch.float32, device=doc_vecs.device)
    with torch.cuda.device(doc_vecs.device):
        stream = torch.cuda.current_stream(doc_vecs.device).cuda_stream
        err = lib.hsf_score_launch(
            doc_vecs.data_ptr(), doc_sigs.data_ptr(), query_vec.data_ptr(),
            query_sig.data_ptr(), n, d, w, _SINGLE_DTYPES[doc_vecs.dtype],
            float(alpha), float(beta), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            "hsf_score launch failed: "
            f"{lib.hsf_score_error_string(err).decode()} (cudaError {err})")
    _bump("launches", single_counts)
    return out


def hsf_score(
    doc_vecs,    # [N, D] float32 or bfloat16
    doc_sigs,    # [N, W] int32
    query_vec,   # [D], doc_vecs' dtype
    query_sig,   # [W] int32
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
):
    """Single-query HSF scores, float32 [N]: α·(docs·q) + β·containment,
    summed in f32.  An empty corpus returns an empty [0] vector without
    a launch; a ragged N needs no padding (the kernel masks its edge)."""
    if doc_vecs.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=doc_vecs.device)
    if doc_vecs.device.type == "cuda":
        return _launch_single(doc_vecs, doc_sigs, query_vec, query_sig,
                              alpha, beta)
    if doc_vecs.device.type == "cpu":
        return hsf_score_ref(doc_vecs, doc_sigs, query_vec, query_sig,
                             alpha, beta)
    raise ValueError(f"no hsf_score for device {doc_vecs.device}")
