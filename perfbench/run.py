#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: the cell is looked up in ``BENCHMARK.json``
there, its files under this directory, the program under test
(``repro_torch``) under ``src/``.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, ``window``: what the
window's close left open, and last ``checks``: each
number the output check compared beside its limit, which are also the
last lines of standard error).  Exits 3 without a result when the card
the cell asks for is not there, 4 when a JAX module was loaded by the
time the window closed.  Caches (the corpus, the program's container,
the reference's arrays, the kernels' builds) live under ``cache/``
here, at fixed paths: only a checkout's first run of a configuration
builds them.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))


def _plain(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None, bench_json: Path = ROOT / "BENCHMARK.json",
         device=None) -> int:
    """The command.  ``bench_json`` and ``device`` are for the CPU tests,
    which run small cells of a benchmark directory of their own on the
    host; the command itself always looks for the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="cell name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pbkit import harness, spec

    bench_dir = bench_json.parent / "perfbench"
    cell = spec.load_cell(args.workload, bench_json, bench_dir)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          bench_dir / "cache", device=device)
    except harness.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    except harness.ForbiddenModules as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 4
    n = out.numbers
    print(f"setup_s: {out.setup_s!r}")
    print(f"samples: {out.result['attempted']} requests attempted, "
          f"{n['checked_retrievals']} retrievals checked, "
          f"{n['sampled_answers']} answers ({n['sampled_tokens']} tokens) "
          f"checked in {n['judge_s']:.1f} s")
    result = dict(out.result)
    result["checks"] = {name: {"value": _plain(v), "limit": lim}
                        for name, v, lim in out.checks}
    print(f"window close: {json.dumps(out.result['window'])}",
          file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
