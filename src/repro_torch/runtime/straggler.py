"""Straggler detection: EWMA step-time outlier tracking (the JAX
package's ``runtime/straggler.py``, copied: standard library only).

Retrieval shards are equal-size by construction (pad_corpus), so a
persistent retrieval straggler is hardware, not skew — the mitigation
is shard migration (elastic.py: content-addressed shards move with a
manifest edit).  For training, the mitigations exposed are (a) flagging
for the cluster manager to swap the node and (b) micro-batch rebalance
hooks.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    alpha: float = 0.1  # EWMA coefficient
    threshold: float = 1.5  # flag if step_time > threshold × fleet EWMA
    min_samples: int = 5
    _ewma: dict[str, float] = field(default_factory=dict)
    _count: dict[str, int] = field(default_factory=dict)

    def observe(self, worker: str, step_time: float):
        prev = self._ewma.get(worker)
        self._ewma[worker] = (
            step_time if prev is None
            else (1 - self.alpha) * prev + self.alpha * step_time
        )
        self._count[worker] = self._count.get(worker, 0) + 1

    def fleet_ewma(self) -> float:
        vals = [v for w, v in self._ewma.items()
                if self._count[w] >= self.min_samples]
        return sum(vals) / len(vals) if vals else 0.0

    def stragglers(self) -> list[str]:
        fleet = self.fleet_ewma()
        if fleet == 0.0:
            return []
        return sorted(
            w for w, v in self._ewma.items()
            if self._count[w] >= self.min_samples and v > self.threshold * fleet
        )
