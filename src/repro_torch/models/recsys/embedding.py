"""Sparse embedding substrate for the recsys family (the JAX package's
``models/recsys/embedding.py``).

- All categorical fields share one fused row table [Σ vocab_f, dim]
  with per-field offsets (the FBGEMM table-batched layout), so one
  gather serves every field.  dlrm-rm2's table is 187,767,808 × 64 f32,
  48 GB: it is filled in place, and no lookup copies it.
- ``lookup_bags`` is the multi-hot EmbeddingBag path.  No model calls
  it: DLRM, DeepFM and AutoInt take one index per field (``lookup``,
  ``lookup_rows``, ``lookup_scores``).  With ``use_kernel=True`` it goes
  through ``kernels/embedding_bag`` — the CUDA kernel on a CUDA table,
  the kernel's plain version on a CPU one; without, a gather and an
  ``index_add_``.
- Distribution: under ``sharding_ctx(mesh)`` the rows are
  range-sharded over the shard mesh's S shards (``launch/mesh.py``):
  each of S contiguous row ranges gathers the rows it owns (rows it
  does not own give exact zeros) and a sum over the shards, in shard
  order, assembles the result — bit-identical to the unsharded lookup,
  because exactly one shard contributes each row.  ``lookup_scores``
  dots the rows at their shard and sums [n] scores instead of rows.
  The ranges are views of the one table, on the table's device, so no
  table is copied (dlrm-mlperf FULL's 96.1 GB table does not fit one
  card either way).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops

TABLE_ROW_MULTIPLE = 512  # rows padded so any mesh axis divides evenly
_FILL_ROWS = 1 << 22      # rows drawn per call while a table is filled


_CTX = threading.local()


@contextlib.contextmanager
def sharding_ctx(mesh, row_axis: str = "shards"):
    """Row-shard the lookups in this thread over ``mesh`` (a shard mesh,
    ``launch.mesh.make_shard_mesh``: S = its length) while open."""
    from repro_torch.launch.mesh import all_axes

    if row_axis not in all_axes(mesh):
        raise ValueError(f"a shard mesh has the axes {all_axes(mesh)}, "
                         f"not {row_axis!r}")
    if len(mesh) < 1:
        raise ValueError("a shard mesh has at least one shard")
    prev = getattr(_CTX, "value", None)
    _CTX.value = len(mesh)
    try:
        yield
    finally:
        _CTX.value = prev


def _row_ranges(n_rows: int, n_shards: int):
    """(lo, hi) of each shard's contiguous rows: ⌈V/S⌉ rows a shard."""
    per = -(-n_rows // n_shards)
    return [(min(s * per, n_rows), min((s + 1) * per, n_rows))
            for s in range(n_shards)]


def _sharded(table, flat, local_fn):
    """Σ over the shards, in shard order, of ``local_fn(view, li)`` with
    the rows a shard does not own set to exact zeros; ``view`` is the
    shard's row range of ``table`` and ``li`` the indices into it."""
    out = None
    for lo, hi in _row_ranges(table.shape[0], _CTX.value):
        li = flat.to(torch.int64) - lo
        valid = (li >= 0) & (li < hi - lo)
        part = local_fn(table[lo:hi], li.clamp(0, max(hi - lo - 1, 0)))
        mask = valid.reshape(valid.shape + (1,) * (part.dim() - 1))
        part = torch.where(mask, part, torch.zeros((), dtype=part.dtype,
                                                   device=part.device))
        out = part if out is None else out + part
    return out


def field_offsets(vocab_sizes: tuple[int, ...], device=None) -> torch.Tensor:
    """Per-field row offsets into the fused table, int32 [F]."""
    offsets = np.zeros(len(vocab_sizes), np.int64)
    np.cumsum(vocab_sizes[:-1], out=offsets[1:])
    return torch.tensor(offsets, dtype=torch.int32, device=device)


@functools.cache
def cached_offsets(vocab_sizes: tuple[int, ...], device) -> torch.Tensor:
    """``field_offsets`` kept on ``device``: a forward copies no offsets
    from the host (a copy that would wait for the queued device work).
    Callers never write into it."""
    return field_offsets(vocab_sizes, device)


def padded_rows(vocab_sizes: tuple[int, ...]) -> int:
    total = int(sum(vocab_sizes))
    return total + (-total) % TABLE_ROW_MULTIPLE


def normal_(t: torch.Tensor, std: float, gen: torch.Generator
            ) -> torch.Tensor:
    """Fill ``t`` in place with N(0, std²), ``_FILL_ROWS`` rows per draw:
    a 48 GB table never has a second copy or a temporary its size."""
    for lo in range(0, t.shape[0], _FILL_ROWS):
        t[lo:lo + _FILL_ROWS].normal_(0.0, std, generator=gen)
    return t


def init_tables(gen: torch.Generator, vocab_sizes: tuple[int, ...],
                dim: int, device=None) -> dict:
    """The fused table, N(0, 1) · dim^-½, on ``device`` (the generator's
    own by default)."""
    device = gen.device if device is None else torch.device(device)
    table = torch.empty((padded_rows(vocab_sizes), dim), dtype=torch.float32,
                        device=device)
    return {"table": normal_(table, (1.0 / dim) ** 0.5, gen)}


def lookup_rows(table: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Gather rows by already-offset indices: [...] → [..., E]
    (row-sharded under ``sharding_ctx``)."""
    flat = flat_idx.reshape(-1)
    if getattr(_CTX, "value", None) is None:
        rows = torch.index_select(table, 0, flat)
    else:
        rows = _sharded(table, flat,
                        lambda view, li: torch.index_select(view, 0, li))
    return rows.reshape(*flat_idx.shape, *table.shape[1:])


def lookup(table: torch.Tensor, offsets: torch.Tensor,
           sparse_idx: torch.Tensor) -> torch.Tensor:
    """One-hot-per-field lookup: sparse_idx [B, F] → [B, F, dim]."""
    flat = sparse_idx.to(torch.int32) + offsets[None, :]
    return lookup_rows(table, flat)


def lookup_scores(table: torch.Tensor, flat_idx: torch.Tensor,
                  q_vec: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]] · q — candidate scoring against one query
    (rows cast to q's dtype after the gather).  Under ``sharding_ctx``
    each shard scores the rows it owns and the [n] scores are summed:
    the gathered rows never leave their shard."""
    flat = flat_idx.reshape(-1)
    if getattr(_CTX, "value", None) is None:
        return torch.index_select(table, 0, flat).to(q_vec.dtype) @ q_vec
    return _sharded(
        table, flat,
        lambda view, li: torch.index_select(view, 0, li).to(q_vec.dtype)
        @ q_vec)


def lookup_bags(table, offsets, indices, field_ids, bag_ids, n_bags,
                weights=None, use_kernel: bool = False):
    """Multi-hot lookup: ragged (bag, field, index) triples reduced per
    bag — the EmbeddingBag path, [n_bags, E] in the table's dtype."""
    flat = indices.to(torch.int32) + offsets[field_ids]
    if use_kernel:
        return bag_ops.embedding_bag(table, flat, bag_ids, n_bags, weights)
    rows = lookup_rows(table, flat)
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((n_bags, *rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, bag_ids.to(torch.int64), rows)
