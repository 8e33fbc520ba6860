"""Sharded, content-hashed checkpointing on the knowledge-container
format (the JAX package's ``checkpoint/checkpointer.py``; paper C4
reused as the training-state store).

- Atomic publish: data files land first, then the generation manifest is
  ``os.replace``'d — a crash mid-save can never corrupt the latest
  restore point (the previous manifest still names only complete,
  hash-verified files).
- Content addressing: shard files are named by their data hash, so
  unchanged state between checkpoints dedupes to the same file name;
  the manifest's generation history keeps the last ``keep`` saves.
- Async save: ``save_async`` copies the state to the host on the
  caller's thread (the sync point), then writes on a background thread.
- Exact resume: ``restore`` returns bit-identical leaves, plus the step
  for the data cursor's replay.

A state is a tree of dicts and lists whose leaves are tensors (any
device) or numpy arrays.  Each leaf is stored under its path, keys and
list indices joined by ``"/"`` (the JAX package's key names), so the two
packages read each other's files: a bfloat16 leaf is stored as its raw
2-byte words with the numpy dtype string ``<V2``, as the JAX package's
``ml_dtypes`` bfloat16 arrays are.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.container import ShardedContainer, publish_sharded
from repro_torch.optim import tree as tree_lib

_BF16_WORDS = np.dtype("V2")  # how numpy spells an ml_dtypes bfloat16


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` in ``leaf``'s kind, dtype and (for a tensor) device."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def flatten(state) -> dict[str, np.ndarray]:
    """{``"/"``-joined path: the leaf as a host numpy array}."""
    return {tree_lib.key(p): _to_host(leaf)
            for p, leaf in tree_lib.paths(state)}


def unflatten(template, flat: dict[str, np.ndarray], prefix: tuple = ()):
    """``flat``'s arrays in ``template``'s structure, each leaf in the
    template leaf's kind, dtype and device."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, flat, prefix + (i,))
                              for i, v in enumerate(template))
    k = tree_lib.key(prefix)
    arr = flat[k]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{k}: stored shape {arr.shape}, template "
                         f"{tuple(template.shape)}")
    return _like(arr, template)


@dataclass
class Checkpointer:
    root: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---- save -----------------------------------------------------------

    def save(self, step: int, state, extra_meta: dict | None = None) -> int:
        return self._write(step, flatten(state), extra_meta or {})

    def save_async(self, step: int, state, extra_meta: dict | None = None):
        """Device→host copy now; file I/O on a background thread."""
        self.wait()
        flat = flatten(state)  # the copy to the host is the sync point

        def work():
            self._write(step, flat, extra_meta or {})

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra_meta: dict) -> int:
        # the manifest's generation-history GC enforces the keep window:
        # files referenced by the last ``keep`` generations survive
        return publish_sharded(
            self.root,
            shard_segments=[flat],
            shard_metas=[{"step": step}],
            meta={"step": step, **extra_meta},
            gc=True,
            gc_grace=self.keep,
        )

    # ---- restore --------------------------------------------------------

    def latest_step(self) -> int | None:
        mpath = os.path.join(self.root, "manifest.json")
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            return int(json.load(f)["meta"]["step"])

    def restore_flat(self) -> tuple[dict[str, np.ndarray], int]:
        """The latest checkpoint as ({key: host array}, step)."""
        self.wait()
        sc = ShardedContainer.open(self.root)
        flat: dict[str, np.ndarray] = {}
        for i in range(sc.n_shards):
            flat.update(sc.open_shard(i).read_all())
        return flat, int(sc.meta["step"])

    def restore(self, template):
        """Restore into the structure of ``template`` (e.g. the state
        from init).  Returns (state, step)."""
        flat, step = self.restore_flat()
        return unflatten(template, flat), step
