"""Failure detection + deterministic restart protocol (the JAX package's
``runtime/fault.py``, copied: standard library only).

At 1000+ nodes, node loss is routine; the framework's contract is:

  1. every worker heartbeats (host process, one per node);
  2. the monitor declares a worker dead after ``timeout`` missed beats;
  3. the controller computes a restart plan: the survivor set, the new
     mesh shape (largest power-of-two DP degree that fits — see
     elastic.py), the checkpoint generation to restore, and the
     DataCursor step to resume from;
  4. workers restart, restore bit-exact state, and replay the data
     stream from the cursor — the loss curve continues as if the
     failure never happened (tested in tests/test_checkpoint_runtime.py
     via a simulated kill-restore-replay cycle).

This module is runnable logic (driven by the tests and by
launch/train.py's single-host simulation), not a daemon — the
cluster-manager integration point is the HeartbeatTable API.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatTable:
    timeout: float = 30.0
    _last: dict[str, float] = field(default_factory=dict)

    def beat(self, worker: str, now: float | None = None):
        self._last[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return sorted(
            w for w, t in self._last.items() if now - t > self.timeout
        )

    def live_workers(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return sorted(
            w for w, t in self._last.items() if now - t <= self.timeout
        )


@dataclass(frozen=True)
class RestartPlan:
    survivors: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    restore_step: int | None
    data_cursor_step: int
    corpus_generation: int | None = None


def plan_restart(
    table: HeartbeatTable,
    chips_per_worker: int,
    model_parallel: int,
    latest_ckpt_step: int | None,
    steps_per_ckpt_interval: int = 0,
    corpus_generation: int | None = None,
    now: float | None = None,
) -> RestartPlan:
    """Shrink-to-fit plan: keep model parallelism fixed (a model shard
    set must be complete), drop data-parallel replicas to the largest
    power of two the survivors can host."""
    survivors = tuple(table.live_workers(now))
    chips = len(survivors) * chips_per_worker
    dp = max(1, chips // model_parallel)
    dp = 1 << (dp.bit_length() - 1)  # floor to power of two
    return RestartPlan(
        survivors=survivors,
        mesh_shape=(dp, model_parallel),
        restore_step=latest_ckpt_step,
        data_cursor_step=(latest_ckpt_step or 0),
        corpus_generation=corpus_generation,
    )
