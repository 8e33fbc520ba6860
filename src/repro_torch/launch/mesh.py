"""Shard placement for the retrieval planes (the JAX package's
``launch/mesh.py``, its ``make_shard_mesh`` and ``all_axes``).

The JAX package is single-controller: one process drives a 1-D
``("shards",)`` device mesh through ``shard_map``, or loops over
logical shards on the default device when the host has fewer devices
than shards.  The port keeps one process and no ``torch.distributed``:
a shard mesh is a tuple of one ``torch.device`` per shard.  A shard's
block, its local top-k and its launches live on its device; results
come back to the first device (or to the host) for the merge.

The production, host and data-parallel meshes of the JAX package serve
training and its dry run; they come with the training substrate of the
port (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

SHARD_AXES = ("shards",)


def make_shard_mesh(n_shards: int, device) -> tuple[torch.device, ...]:
    """One device per shard: the first ``n_shards`` CUDA devices when
    ``device`` is CUDA and that many exist, else ``device`` repeated
    (logical shards, with the same per-shard arithmetic)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if (device.type == "cuda" and n_shards > 1
            and torch.cuda.device_count() >= n_shards):
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    return (device,) * n_shards


def placement(mesh) -> str:
    """``"mesh"`` when every shard has a device of its own, else
    ``"logical"`` (the names the JAX package's quickstart prints)."""
    return "mesh" if len(mesh) > 1 and len(set(mesh)) == len(mesh) \
        else "logical"


def default_shards(device) -> int:
    """The shard count when the caller gives none: the CUDA device count
    on the card, 1 on the CPU."""
    return max(1, torch.cuda.device_count()) \
        if torch.device(device).type == "cuda" else 1


def all_axes(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a shard mesh has the one ``"shards"``."""
    del mesh
    return SHARD_AXES
