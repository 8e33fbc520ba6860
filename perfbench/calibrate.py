#!/usr/bin/env python3
"""Readings that the output check's limits are set from: for one cell,
in one process, the program's numbers on each of ``--seeds`` (a short
window at the cell's own load, answered and judged as a run judges
them) and, on the first ``--control-seeds`` of them, the control's: the
references computed in the precision below the configuration's (the
language model's products in fp8, the retrieval's cosines in TF32) and
judged in the program's place.  One JSON line a reading.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds 10 [--first-seed N]

Exits 3 without readings when the cell's card is not there."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))


def readings(cell, seeds: list[int], n_control: int, seconds: float,
             cache_root: Path, device=None):
    """Yield one dict a seed and side (program, then control)."""
    import torch

    from pbkit import corpus as corpus_mod, harness, spec, weights as wts

    device = harness.device_for(cell, device)
    harness.use_cache_dirs(cache_root)
    cache_dir = cache_root / corpus_mod.corpus_key(cell.config)
    corpus = corpus_mod.load_or_make(cell.config, cache_dir)
    kb = harness.container(cell, corpus, cache_dir)
    ref_mod = spec.reference_module(cell)
    for i, seed in enumerate(seeds):
        weights = wts.make(ref_mod.weight_specs(cell.config), seed, device)
        served = harness.serve_window(cell, kb, weights, seed, seconds,
                                      False, device, corpus)
        sides = ["program"] + (["control"] if i < n_control else [])
        for side in sides:
            t0 = time.perf_counter()
            numbers = harness.judge(cell, served, weights, corpus, cache_dir,
                                    device, seed, control=side == "control")
            yield {"cell": cell.name, "seed": seed, "side": side,
                   **numbers, "judge_s": time.perf_counter() - t0}
        del weights, served
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from pbkit import harness, spec

    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json", BENCH_DIR)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    try:
        for row in readings(cell, seeds, args.control_seeds, args.seconds,
                            BENCH_DIR / "cache"):
            print(json.dumps(row), flush=True)
    except harness.NoDevice as exc:
        print(f"no readings: {exc}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
