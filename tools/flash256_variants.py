"""The bf16 Dh=256 and MLA (q/k 192, v 128) flash designs against the
variants they were chosen over.

    python3 tools/flash256_variants.py [--parent DIR]

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is ("shipped")
and as two variants made from it by text substitution, so the shipped
source holds one design:

* ``64-row``: one consumer warpgroup, 64 query rows a CTA (256 threads,
  no ``setmaxnreg``);
* ``tanhf``: the softcap's tanh by ``tanhf`` instead of
  ``tanh.approx.f32``;
* ``ws-mla``: MLA's 192/128 heads on the warp-specialised design (two
  consumer warpgroups, 128 query rows and one CTA an SM) instead of the
  one-warpgroup ``wgmma`` design (64 rows, two CTAs an SM);
* ``parent`` (with ``--parent DIR``): the kernel of another tree, e.g.
  ``git archive`` of the parent commit unpacked into a directory that
  ``.gitignore`` lists.

Each build is one ``nvcc``, all started together, into
``build/flash256_variants/``.  Then each runs in a process of its own,
in the order shipped, the others, the others reversed, shipped (two
builds are compared only within one call): the bf16 Dh=256 and MLA
cases of ``chip_smoke.py``'s phase 2 (max |Δ| and atol against the plain
version: max |Δ|, atol, rms |Δ|; or the failed check; one call of the phase a case, so each
case draws its operands from the phase's seed) and the flash timings of
phases 6 and 11: gemma2 (L = 512 and 8,192, with and without the
softcap), gemma3 and qwen3 (Dh 128, L = 512), llama (Dh 128, L = 512
and 8,192) and deepseek's heads (192/128 by their own design, and
padded to 256; a library from before v's width was an argument of the
launch takes equal widths only, and then deepseek and the MLA cases are
left out).  One JSON line a run, after the card's name and power limit.
Needs a card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash256_variants"

# variant -> [(text in the shipped source, its replacement)]; each text
# must occur exactly once
SUBSTITUTIONS = {
    "shipped": [],
    "64-row": [
        ("static constexpr int kConsumers = 2;",
         "static constexpr int kConsumers = 1;"),
        ("    setmaxnreg_dec<24>();\n", ""),
        ("    setmaxnreg_inc<240>();\n", ""),
    ],
    "tanhf": [
        ('  asm("tanh.approx.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
         "  y = tanhf(x);\n"),
    ],
    "ws-mla": [
        ("return wgmma_design<192, 128>();", "return ws_design<192, 128>();"),
    ],
}


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source(variant: str, parent: Path | None) -> Path:
    """The variant's ``flash_attention.cu``, beside the headers it
    includes."""
    if variant == "parent":
        return parent / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    text = (CSRC / "flash_attention.cu").read_text()
    for old, new in SUBSTITUTIONS[variant]:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "flash_attention.cu").write_text(text)
    return d / "flash_attention.cu"


def build(variants: list[str], parent: Path | None) -> None:
    from repro_torch.kernels import build as kbuild

    procs = {}
    for v in variants:
        lib = OUT / f"lib{v}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[v] = subprocess.Popen(
            [_nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib),
             str(_source(v, parent))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for v, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{v}: nvcc failed\n{log}"
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{v}] {line.strip()}", file=sys.stderr)


class _EqualWidths:
    """A library whose launch takes one head size for q, k and v (no v
    width after q's): the wrapper's call with the v width taken out."""

    def __init__(self, lib):
        self._lib = lib

    def flash_attention_launch(self, *args):
        assert args[10] == args[11], "this library takes equal widths only"
        return self._lib.flash_attention_launch(*args[:11], *args[12:])

    def __getattr__(self, name):
        return getattr(self._lib, name)


def run_one(variant: str) -> dict:
    """The library of ``variant`` behind ``kernels/flash_attention/ops``:
    phase 2's bf16 Dh=256 and MLA cases and phase 11's gemma2 and
    deepseek timings."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get as get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(str(OUT / f"lib{variant}.so"))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    pairs = hasattr(lib, "flash_attention_design")  # v's width an argument
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p] + [i] * (8 if pairs else 7) + [ll] * 9
        + [f, i, i, i, i, f, i, i, p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    fa_ops._lib = (lambda: lib) if pairs else (lambda: _EqualWidths(lib))
    out = {"variant": variant, "max_abs_err": {}, "by_shape": {}}
    for case in cs._flash_cases(torch):
        dh = case[1][5]
        if case[2] != torch.bfloat16 or not (
                dh == 256 or (pairs and isinstance(dh, tuple))):
            continue
        try:  # one case a call, so a failed case still reports the rest
            _, errs = cs.phase_flash_kernel(torch, fa_ops, fa_ref, [case])
            out["max_abs_err"][case[0]] = errs[case[0]]
        except AssertionError as e:
            out["max_abs_err"][case[0]] = f"FAILED: {str(e)[:400]}"
    archs = ("gemma2-9b", "gemma3-27b", "qwen3-moe-30b-a3b",
             "deepseek-v2-lite-16b")
    for arch in archs if pairs else archs[:-1]:
        out["by_shape"].update(cs._family_flash(
            torch, fa_ops, fa_ref, arch, get_arch(arch).config))
    for l, runs in ((cs.ATTN_SERVE["l"], 10), (cs.ATTN_LONG_L, 5)):
        out["by_shape"][f"llama3.2-3b L={l}"] = cs._time_flash(
            torch, fa_ops, fa_ref, l, runs)
    return out


def main(argv: list[str]) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    parent = None
    if argv[:1] == ["--parent"]:
        parent = Path(argv[1]).resolve()
    variants = [*SUBSTITUTIONS, *(["parent"] if parent else [])]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    build(variants, parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path[:2])}
    for v in variants + variants[:0:-1] + variants[:1]:
        run = subprocess.run(
            [sys.executable, __file__, "--one", v], env=env,
            capture_output=True, text=True, timeout=600)
        sys.stderr.write(run.stderr[-4000:])
        assert run.returncode == 0, (v, run.stdout[-2000:])
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
