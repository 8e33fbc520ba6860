"""Wrapper of the MoE decode layer (``csrc/moe_decode.cu``).

A few tokens x [T, D] through a layer's routed experts: the float32
router product, softmax and top k (ties to the lower expert id), the k
selected experts' SwiGLU and their gated combine, [T, D] in bf16.
``ref.py`` is the same function in plain PyTorch (``moe.route`` then
``moe.dispatch``, what the decode step computed before the kernel).
The shared experts are not part of it; the aux loss is not computed.

``has_design`` says from the operands alone whether the kernel takes a
call: bf16 x and expert weights, the float32 router, at most
``MAX_TOKENS`` tokens, widths the kernel tiles (D and F multiples of
``TILE``; E a multiple of 4 up to ``MAX_EXPERTS``; k up to ``MAX_TOP_K``)
and nothing for autograd to record (the kernel is forward-only).  The
decode step sends the rest (float32 models, the SMOKE widths) to the
grouped path; prefill and training never call it.

Dispatch is by the tensors' device and nothing else: a CUDA tensor
launches the kernel (or raises — operands without a design, wrong
device or layout, a failed build, a launch error); any other device
takes ``ref.py``, counted apart as ``plain``.  A launch is three kernels
(route, gate/up, down and combine), counted as one.  Nothing waits on
the device: the expert ids are read there, and the scratch comes from
``torch.empty``, so the decode step still captures into a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import counters
from repro_torch.kernels.moe_decode.ref import moe_decode_ref

# The most tokens a call takes: above it the grouped path, which reads
# each used expert once, is faster than the kernel, which reads an
# expert once for each (token, slot) routed to it.
MAX_TOKENS = 8
TILE = 64  # columns of F or D a CTA owns (the kernel's kTile)
MAX_EXPERTS = 256
MAX_TOP_K = 8  # the down kernel's cluster holds a token's k slots

_counts_lock = threading.Lock()
# launches: kernel launches (one a layer call); plain: calls served by ref.py
counts = {"launches": 0, "plain": 0}
counters.register("moe_decode", counts, _counts_lock)


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def _bump(key: str) -> None:
    counters.bump("moe_decode", key)


def _weights(params) -> list:
    return [params[n] for n in ("router", "w_gate", "w_up", "w_down")]


def has_design(x: torch.Tensor, params: dict, cfg) -> bool:
    """Whether the kernel takes x [T, D] through the routed experts of
    ``params`` (router [D, E], w_gate and w_up [E, D, F], w_down [E, F,
    D]) under the MoE config ``cfg``."""
    router, w_gate, w_up, w_down = ws = _weights(params)
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        return False
    t, d = x.shape
    e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    if router.dtype != torch.float32 or any(w.dtype != torch.bfloat16
                                            for w in ws[1:]):
        return False
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, *ws)):
        return False
    return (1 <= t <= MAX_TOKENS and d % TILE == 0 and f % TILE == 0
            and e % 4 == 0 and e <= MAX_EXPERTS and 1 <= k <= min(MAX_TOP_K, e)
            and router.shape == (d, e) and w_gate.shape == (e, d, f)
            and w_up.shape == (e, d, f) and w_down.shape == (e, f, d))


def split(t: int, k: int, f: int, n_sm: int) -> int:
    """CTAs that share one gate/up tile's rows (the gate/up kernel's
    cluster): the fewest of 1, 2, 4 and 8 that give about two CTAs an
    SM."""
    ctas, out = (f // TILE) * t * k, 1
    while out < 8 and ctas * out < 2 * n_sm:
        out *= 2
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call
    builds it; pointers and the stream pass as c_void_p)."""
    from repro_torch.kernels import build

    lib = build.load("moe_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_decode_launch.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.moe_decode_launch.restype = ctypes.c_int
    lib.moe_decode_error_string.argtypes = [i]
    lib.moe_decode_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, params, cfg):
    """(out [T, D] bf16, gates [T, k] f32, ids [T, k] int32) from one
    launch."""
    dev = x.device
    ws = _weights(params)
    for name, w in zip(("router", "w_gate", "w_up", "w_down"), ws):
        if w.device != dev:
            raise ValueError(f"{name} is on {w.device}, x on {dev}")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned; got strides {w.stride()}")
    x = x.contiguous()  # no copy when it is
    t, d = x.shape
    e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    lib = _lib()
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    h = torch.empty((t * k, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.moe_decode_launch(
            x.data_ptr(), *(w.data_ptr() for w in ws), gates.data_ptr(),
            ids.data_ptr(), h.data_ptr(), out.data_ptr(), t, d, e, k, f,
            split(t, k, f, _sm_count(dev.index)), int(cfg.norm_topk), stream)
    if err != 0:
        raise RuntimeError(
            "moe_decode launch failed: "
            f"{lib.moe_decode_error_string(err).decode()} (cudaError {err})")
    _bump("launches")
    return out, gates, ids


def moe_decode(x: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    """x [T, D] through the routed experts of ``params`` (a layer's
    ``models/moe`` parameters) under ``cfg``: [T, D] in x's dtype, the
    shared experts left out and no aux loss."""
    if x.device.type == "cuda":
        if not has_design(x, params, cfg):
            raise ValueError(
                f"no moe_decode design for x {tuple(x.shape)} {x.dtype}, "
                f"{cfg.n_experts} experts of {cfg.d_ff_expert}, top "
                f"{cfg.top_k}: bf16 x and experts, a float32 router, up to "
                f"{MAX_TOKENS} tokens, D and F multiples of {TILE}, E a "
                f"multiple of 4 up to {MAX_EXPERTS}, k up to {MAX_TOP_K}, "
                "nothing requiring grad")
        return _launch(x, params, cfg)[0]
    _bump("plain")
    return moe_decode_ref(x, params, cfg)
