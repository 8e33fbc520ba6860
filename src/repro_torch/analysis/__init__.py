"""Zero-dependency invariant analyzer + runtime sanitizers
(docs/ARCHITECTURE.md §11), retargeted to the PyTorch port.

The same hard invariants back the port's claims as the JAX package's —
pinned-order ``stable_rowdot`` for every map-path cosine, the
``KnowledgeBase`` single-writer lock, fsync-then-rename commits,
immutable generation-pinned snapshots, and a serving loop that never
syncs the host inside what a CUDA graph captures.  This package encodes
them as machine-checked contracts over ``src/repro_torch``:

- **Static rules** (pure ``ast``, no dependency — the analyzer imports
  neither torch nor the JAX package, and keeps its own copy of the
  grammar and runner):

  =====================  ==================================================
  ``unpinned-reduction``  raw ``@`` / ``torch.matmul`` / ``mm`` / ``bmm`` /
                          ``einsum`` / ``F.linear`` / ``.matmul(`` in
                          scoring modules must route through
                          ``hsf.stable_rowdot`` (R1)
  ``writer-lock``         public ``KnowledgeBase`` mutators must hold the
                          ``_single_writer`` guard (R2)
  ``durability``          container/journal publishes must go through the
                          fsync-then-rename helpers, never bare
                          ``open(.., "w")`` + rename (R3)
  ``snapshot-mutation``   ``EngineSnapshot`` is written only at
                          construction, and no tensor a snapshot pins is
                          written in place (``add_``, ``copy_``,
                          ``index_copy_``, slice stores, ...) (R4)
  ``host-sync``           no ``.item()``/``.cpu()``/``.tolist()``/
                          ``.numpy()``/``int()``/``float()`` inside a
                          function a CUDA graph captures, and every
                          ``synchronize`` justified (R5)
  ``tenant-pin``          ``ContainerPool._resident`` changes only under
                          the pool guard, evictions check pins (R6)
  =====================  ==================================================

  Intentional exceptions carry an inline, reviewable pragma::

      # analysis: allow[unpinned-reduction] -- opt-in gemm path, ...

  ``python -m repro_torch.analysis --strict --check-audit
  docs/ANALYSIS_AUDIT_TORCH.md`` is the CI gate: exit 0 only when the
  tree is clean, every pragma carries a justification and the audit is
  current.

- **Runtime sanitizers** (``sanitizers.py``, opt-in via
  ``RAGDB_SANITIZERS=1``): a NaN/Inf guard on every scoring path's
  host-boundary output and a capture guard asserting zero steady-state
  CUDA graph captures in the serving loop after warmup.

Import note: this ``__init__`` stays dependency-free and cheap — hot
modules (core/engine.py) import ``repro_torch.analysis.sanitizers`` at
module load, so nothing here may pull in torch or the analyzer runner.
The CLI (``__main__``) imports the runner lazily.
"""
from __future__ import annotations

__all__ = ["run_analysis", "RULES", "Finding"]


def __getattr__(name):
    # lazy re-exports: keep `import repro_torch.analysis.sanitizers`
    # from paying for the ast runner (and vice versa)
    if name in __all__:
        from repro_torch.analysis import runner

        return getattr(runner, name)
    raise AttributeError(name)
