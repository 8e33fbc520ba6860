"""End-to-end training driver (the JAX package's ``launch/train.py``).

Single-process entry point that exercises the production loop on one
device: deterministic data pipeline → train step (gradient accumulation
over micro-batches, remat, AdamW) → async content-hashed checkpoints →
exact restart-replay from the checkpointed step.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-3b --smoke --steps 50 --batch 8 --seq 64 \\
        [--device cpu]

The reference's flags, plus ``--device`` (default cuda, which raises
on a host without a card) and ``--deterministic``
(``torch.use_deterministic_algorithms``; on the card set
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment first): on the
card the embedding's and ``index_add``'s backward otherwise add with
atomics, so two runs agree only to rounding.  The batches are the data
pipeline's, which seeds each step with the process's ``hash`` of the
stream name: a restart-replay equals an uninterrupted run within one
process.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get as get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataCursor, lm_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import tree as tree_lib
from repro_torch.runtime.straggler import StragglerDetector


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run on "
                    "the host)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    return ap.parse_args(argv)


def init_params(cfg: T.LMConfig, seed: int, device) -> T.LM:
    """The model to train: float32 leaves from ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    return T.init(cfg, gen, device, leaf_dtype=torch.float32,
                  requires_grad=True)


def run(args) -> dict:
    """Train; returns {"losses": {step: loss}, "start": the step it
    started (restored) at, "save_s": [seconds of each save call],
    "restore_s": seconds of the restore (0.0 without one)}."""
    device = resolve_device(args.device)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise ValueError("train.py drives the LM family")
    cfg = arch.smoke_config if args.smoke else arch.config
    mesh = meshlib.make_host_mesh(args.model_parallel, device)
    print(f"mesh: {dict(mesh.shape)} ({mesh.placement} on {device})  "
          f"arch: {cfg.name} ({cfg.param_count() / 1e6:.1f} M params)")

    model = init_params(cfg, args.seed, device)
    opt = adamw_init(T.param_tree(model))
    cursor = DataCursor(seed=args.seed)

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start, restore_s = 0, 0.0
    if ck and ck.latest_step() is not None:
        t0 = time.perf_counter()
        state, start = ck.restore({"params": T.param_tree(model),
                                   "opt": opt})
        with torch.no_grad():
            tree_lib.map_(lambda p, v: p.copy_(v), T.param_tree(model),
                          state["params"])
        opt = state["opt"]
        restore_s = time.perf_counter() - t0
        cursor.step = start
        print(f"restored checkpoint at step {start}")

    step_fn = steps.make_lm_train_step(
        cfg, args.n_micro, AdamWConfig(lr=args.lr, weight_decay=0.0))
    detector = StragglerDetector()
    losses, save_s = {}, []
    micro = args.batch // args.n_micro
    for s in range(start, args.steps):
        toks, tgts = lm_batch(cursor, args.batch, args.seq, cfg.vocab)
        toks = torch.from_numpy(toks.reshape(args.n_micro, micro, args.seq))
        tgts = torch.from_numpy(tgts.reshape(args.n_micro, micro, args.seq))
        t0 = time.perf_counter()
        model, opt, loss = step_fn(model, opt, toks.to(device),
                                   tgts.to(device))
        loss = float(loss)
        dt = time.perf_counter() - t0
        detector.observe("worker0", dt)
        losses[s] = loss
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d}  loss {loss:.4f}  {dt * 1e3:7.1f} ms")
        if ck and (s + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            ck.save_async(s + 1, {"params": T.param_tree(model), "opt": opt})
            save_s.append(time.perf_counter() - t0)
    if ck:
        t0 = time.perf_counter()
        ck.wait()
        if save_s:
            save_s[-1] += time.perf_counter() - t0
    return {"losses": losses, "start": start, "save_s": save_s,
            "restore_s": restore_s}


def main(argv=None):
    losses = run(parse_args(argv))["losses"]
    return losses[max(losses)] if losses else None


if __name__ == "__main__":
    main()
