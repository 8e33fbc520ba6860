"""Elastic scaling plans (the JAX package's ``runtime/elastic.py``,
copied: standard library only).

Corpus shards are content-addressed container files, so moving a shard
between workers is a manifest edit + one file copy — `rebalance_corpus`
computes the minimal-move assignment.  Training elasticity rides the
checkpoint round-trip: params are saved shard-agnostically (full
logical arrays per leaf), so restoring onto a different mesh shape is
just placing each leaf with the new layout (plan_restart picks the
shape).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShardMove:
    shard_index: int
    src: str
    dst: str


def rebalance_corpus(
    shard_owners: dict[int, str], workers: list[str]
) -> list[ShardMove]:
    """Minimal-move rebalance of n shards over the worker list.

    Keeps every shard already on a surviving worker in place when that
    worker is not over target; moves orphaned/overflow shards to the
    least-loaded survivors.  Deterministic (sorted orders) so every
    controller replica computes the same plan.
    """
    n = len(shard_owners)
    workers = sorted(set(workers))
    lo, extras = divmod(n, len(workers))  # lo or lo+1 shards per worker
    load: dict[str, int] = {w: 0 for w in workers}
    keep: dict[int, str] = {}
    extras_used = 0
    for idx in sorted(shard_owners):
        owner = shard_owners[idx]
        if owner not in load:
            continue
        if load[owner] < lo:
            keep[idx] = owner
            load[owner] += 1
        elif load[owner] == lo and extras_used < extras:
            keep[idx] = owner
            load[owner] += 1
            extras_used += 1
    moves = []
    for idx in sorted(shard_owners):
        if idx in keep:
            continue
        dst = min(workers, key=lambda w: (load[w], w))
        load[dst] += 1
        moves.append(ShardMove(idx, shard_owners[idx], dst))
    return moves
