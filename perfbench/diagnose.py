#!/usr/bin/env python3
"""Why decode runs at two speeds: one cell's closed loop as a run drives
it, with a record of every answer in the window.

    python3 perfbench/diagnose.py --workload <cell> --seed <n> \\
        --seconds <s> [--pin 0|1]

For each answer, one JSON line: its decode time a step on the host
clock and on the device (CUDA events around each decode replay), the
host's time in the replay call (copying the inputs in and launching
the graph, which returns before the graph has run), the
generator thread's CPU time and involuntary context switches over the
answer, the CPU it ran on at the answer's start and end, and the
machine's steal time over the answer (from ``/proc``).  Beside the
window, ``nvidia-smi`` samples the card's SM and memory clocks, power
and temperature every 200 ms.  Last, one summary line: the set-up's
phases, the answers split at the median decode step, and the clock
samples in the window.  ``--pin 1`` keeps the generator thread on one
CPU and every other thread of the process off it.  Reads only
``/proc`` of its own process and the machine's CPU counters; changes no
setting of the machine.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT / "src"))

SMI_FIELDS = ("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "pstate")


def _thread_stat() -> tuple[int | None, int | None]:
    """(CPU it last ran on, involuntary context switches) of the calling
    thread, None where ``/proc`` does not say."""
    task = f"/proc/self/task/{threading.get_native_id()}"
    cpu = nonvol = None
    try:
        with open(f"{task}/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(f"{task}/status") as f:
            for line in f:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    nonvol = int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return cpu, nonvol


def _steal_ticks() -> int | None:
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8])
    except (OSError, ValueError, IndexError):
        return None


def _delta(a, b):
    return None if a is None or b is None else b - a


def clock_events() -> list[str]:
    """The card's active clock-event (throttle) reasons, as
    ``nvidia-smi -q -d PERFORMANCE`` lists them."""
    try:
        text = subprocess.run(["nvidia-smi", "-q", "-d", "PERFORMANCE"],
                              capture_output=True, text=True,
                              timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [" ".join(line.split()) for line in text.splitlines()
            if line.strip().endswith(": Active")]


def pin_generator() -> dict:
    """The calling thread onto the last CPU it may use, every other
    thread of the process onto the rest."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return {"pinned": False}
    mine = threading.get_native_id()
    for tid in os.listdir("/proc/self/task"):
        if int(tid) != mine:
            try:
                os.sched_setaffinity(int(tid), cpus[:-1])
            except OSError:
                pass
    os.sched_setaffinity(0, {cpus[-1]})
    return {"pinned": True, "generator_cpu": cpus[-1]}


def _slow_run(rows: list, split: float) -> float:
    """Seconds from the window's first answer to the end of the run of
    slow answers it starts with (0 where it starts fast)."""
    first = next((r for r in rows if r["in_window"]), None)
    end = first["t"] if first else 0.0
    for r in rows:
        if not r["in_window"] or r["decode_ms_per_step"] <= split:
            break
        end = r["t"] + r["wall_ms"] / 1e3
    return end - first["t"] if first else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pin", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbkit import corpus as corpus_mod, harness, spec, weights as wts
    from pbkit.loop import Hooks
    from repro_torch.launch import steps as steps_mod

    t_start = harness.process_start()
    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json", BENCH_DIR)
    device = harness.device_for(cell, None)
    harness.use_cache_dirs(BENCH_DIR / "cache")
    window: dict = {}
    phases = {"free_gb_at_start": torch.cuda.mem_get_info(device)[0] / 1e9,
              "process_age_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    cache_dir = BENCH_DIR / "cache" / corpus_mod.corpus_key(cell.config)
    corpus = corpus_mod.load_or_make(cell.config, cache_dir)
    phases["corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    kb = harness.container(cell, corpus, cache_dir)
    phases["container_s"] = time.perf_counter() - t
    t = time.perf_counter()
    weights = wts.make(spec.reference_module(cell).weight_specs(cell.config),
                       args.seed, device)
    torch.cuda.synchronize(device)
    phases["weights_s"] = time.perf_counter() - t
    phases["before_program_s"] = time.perf_counter() - t_start
    window["events_first"] = clock_events()

    # device time of each decode replay
    step_events: list = []
    replay = steps_mod.CapturedStep.__call__

    def timed_call(self, *inputs):
        if not self.name.endswith(".decode") or self.graph is None:
            return replay(self, *inputs)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        out = replay(self, *inputs)
        host_ms = (time.perf_counter() - h0) * 1e3
        b.record()
        step_events.append((a, b, host_ms))
        return out

    steps_mod.CapturedStep.__call__ = timed_call

    answers: list[dict] = []
    pin_info: dict = {}

    class DiagHooks(Hooks):
        def phase(self, name):
            return _Answer() if name == "pb.generate" else super().phase(name)

        def answered(self, req):
            n = len(req.out.token_ids)
            answers[-1].update(
                decode_ms_per_step=req.out.decode_s * 1e3 / n,
                prefill_ms=req.out.prefill_s * 1e3, t_done=req.t_done)

    class _Answer:
        def __enter__(self):
            if args.pin and not pin_info:
                pin_info.update(pin_generator())
            step_events.clear()
            self.cpu0, self.nv0 = _thread_stat()
            self.steal0 = _steal_ticks()
            self.cpu_t0 = time.thread_time()
            self.t0 = time.time()
            return self

        def __exit__(self, *exc):
            cpu_s = time.thread_time() - self.cpu_t0
            cpu1, nv1 = _thread_stat()
            steal = _delta(self.steal0, _steal_ticks())
            torch.cuda.synchronize(device)
            dev = [a.elapsed_time(b) for a, b, _ in step_events]
            launch = [h for _, _, h in step_events]
            answers.append({
                "t": self.t0, "wall_ms": (time.time() - self.t0) * 1e3,
                "thread_cpu_ms": cpu_s * 1e3, "nonvoluntary": _delta(self.nv0, nv1),
                "cpu": [self.cpu0, cpu1], "steal_ticks": steal,
                "device_ms_per_step": statistics.fmean(dev) if dev else None,
                "device_step_ms": dev,
                "launch_ms_per_step": statistics.fmean(launch) if launch
                else None})
            return False

    smi_path = BENCH_DIR / "cache" / "diagnose_smi.csv"
    smi_path.parent.mkdir(parents=True, exist_ok=True)
    with open(smi_path, "w") as smi_out:
        smi = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=smi_out, stderr=subprocess.DEVNULL)
        try:
            served = harness.serve_window(cell, kb, weights, args.seed,
                                          args.seconds, False, device, corpus,
                                          hooks=DiagHooks())
        finally:
            smi.terminate()
            smi.wait()
    steps_mod.CapturedStep.__call__ = replay
    window["events_last"] = clock_events()
    setup_s = served.t0 - t_start
    to_wall = time.time() - time.perf_counter()
    window["t0"], window["t1"] = served.t0 + to_wall, served.t_end + to_wall
    smi_rows = []
    for line in smi_path.read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            ts = time.mktime(time.strptime(parts[0].split(".")[0],
                                           "%Y/%m/%d %H:%M:%S"))
            ts += float("0." + parts[0].split(".")[1])
            smi_rows.append((ts, float(parts[1]), float(parts[2]),
                             float(parts[3]), float(parts[4]), parts[5]))
        except (IndexError, ValueError):
            continue
    in_win = [s for s in smi_rows if window["t0"] <= s[0] <= window["t1"]]
    rows = []
    for a in answers:
        if "t_done" not in a:
            continue
        near = min(smi_rows, key=lambda s: abs(s[0] - a["t"]), default=None)
        rows.append(dict(a, in_window=a["t_done"] <= served.t_end,
                         sm_mhz=near and near[1], power_w=near and near[3]))
        print(json.dumps(rows[-1]))
    steps = sorted(r["decode_ms_per_step"] for r in rows if r["in_window"])
    # the two speeds split where the decode steps' range is halved
    med = ((steps[len(steps) // 10] + steps[-1 - len(steps) // 10]) / 2
           if steps else 0.0)

    def summary(group):
        keys = ("decode_ms_per_step", "device_ms_per_step",
                "launch_ms_per_step", "thread_cpu_ms",
                "wall_ms", "nonvoluntary", "steal_ticks", "sm_mhz",
                "power_w")
        out = {"n": len(group)}
        for k in keys:
            vals = [g[k] for g in group if g[k] is not None]
            out[k] = statistics.fmean(vals) if vals else None
        out["cpus"] = sorted({c for g in group for c in g["cpu"]
                              if c is not None})
        return out

    fast = [r for r in rows if r["in_window"] and
            r["decode_ms_per_step"] <= med]
    slow = [r for r in rows if r["in_window"] and
            r["decode_ms_per_step"] > med]
    print(json.dumps({
        "summary": True, "cell": cell.name, "seed": args.seed,
        "errors": sorted({r.error for r in served.requests if r.error})[:3],
        "pin": pin_info or {"pinned": False}, "setup_s": setup_s,
        "setup_phases": phases, "answers": len(steps),
        "clock_events": [window["events_first"], window["events_last"]],
        "slow_from_start_s": _slow_run(rows, med),
        "decode_ms_per_step": {"min": min(steps, default=None),
                               "split": med,
                               "max": max(steps, default=None)},
        "fast_half": summary(fast), "slow_half": summary(slow),
        "smi_in_window": {
            "samples": len(in_win),
            "sm_mhz": sorted({s[1] for s in in_win}),
            "mem_mhz": sorted({s[2] for s in in_win}),
            "power_w": [min((s[3] for s in in_win), default=None),
                        max((s[3] for s in in_win), default=None)],
            "temp_c": [min((s[4] for s in in_win), default=None),
                       max((s[4] for s in in_win), default=None)],
            "pstate": sorted({s[5] for s in in_win})},
        "smi_around_window": [
            [s[0] - window["t0"], s[1], s[3]] for s in smi_rows
            if window["t0"] - 5 <= s[0] <= window["t1"] + 5][::5]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
