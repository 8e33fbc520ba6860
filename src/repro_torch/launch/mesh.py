"""Meshes of the port (the JAX package's ``launch/mesh.py``).

The JAX package is single-controller: one process drives a device mesh
through ``shard_map``.  The port keeps one process and no
``torch.distributed``.

- A shard mesh (``make_shard_mesh``, the retrieval planes) is a tuple of
  one ``torch.device`` per shard: a shard's block, its local top-k and
  its launches live on its device; results come back to the first
  device (or to the host) for the merge.
- A host mesh (``make_host_mesh``, training) is a ``HostMesh``: the
  ``("data", "model")`` axes over the cards that exist, or, where the
  host has fewer cards than the model axis asks for, one data replica
  whose model axis is that many logical shards of one device (the MoE
  expert-parallel form runs its expert shards one after another there,
  with the same per-shard arithmetic).  ``dp_axes``/``dp_size`` read it
  as the reference's do.

``make_production_mesh`` is the reference's pod mesh, 16 × 16 (or 2 ×
16 × 16) positions of logical ``meta`` devices: the mesh that
``launch/dryrun.py`` names.  Nothing runs on it.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    if isinstance(mesh, HostMesh):
        return mesh.axis_names
    return SHARD_AXES


# ==========================================================================
# training meshes
# ==========================================================================

@dataclass(frozen=True)
class HostMesh:
    """``shape`` maps each axis name to its size; ``devices`` holds one
    device per mesh position, data-major (a logical mesh repeats one
    device)."""
    shape: dict
    devices: tuple

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def placement(self) -> str:
        return placement(self.devices)


def make_host_mesh(model_parallel: int = 1, device=None) -> HostMesh:
    """The ("data", "model") mesh over the CUDA devices (``device``, cuda
    unless the CPU is asked for; no device and no card raises): data =
    cards // model_parallel when the cards divide evenly, else one data
    replica with ``model_parallel`` logical model shards of ``device``."""
    # core.engine imports this module
    from repro_torch.core.engine import resolve_device

    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    device = resolve_device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n >= model_parallel and n % model_parallel == 0 and n > 1:
        devices = tuple(torch.device("cuda", i) for i in range(n))
        return HostMesh({"data": n // model_parallel,
                         "model": model_parallel}, devices)
    return HostMesh({"data": 1, "model": model_parallel},
                    (device,) * model_parallel)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """16 × 16 = 256 chips a pod; 2 × 16 × 16 = 512 across 2 pods: the
    reference's axes and shape, one logical ``meta`` device a position."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    n = 1
    for size in shape.values():
        n *= size
    return HostMesh(shape, (torch.device("meta"),) * n)


def mesh_name(mesh: HostMesh) -> str:
    """``"16x16"``, ``"2x16x16"``: the reference dry run's mesh names."""
    return "x".join(str(v) for v in mesh.shape.values())


def dp_axes(mesh: HostMesh) -> tuple[str, ...]:
    """Data-parallel axes: pod (if present) + data."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: HostMesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out
