"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``*.cu`` under ``repro_torch/csrc/`` compiles to its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``.  Libraries land in ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of their
source and flags, so an edited source never loads a stale library.
``build_all()`` starts one ``nvcc`` per source, all at once; ``load``
builds on first use.  A failed build raises — there is no fallback.

Nothing here runs at import time: the CPU test suite imports every
module on hosts that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_build_lock = threading.Lock()  # one build at a time in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "repro_torch/csrc/ on a host with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) in
    parallel; returns ``{name: ptxas report}``.  Raises on any failure,
    naming the source and quoting the compiler's output."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if needed.
    Callers keep the handle (``ops._lib`` caches it with its C
    signatures declared)."""
    path = _target(name)
    with _build_lock:
        if not path.exists():
            build_all([name])
    return ctypes.CDLL(str(path))
