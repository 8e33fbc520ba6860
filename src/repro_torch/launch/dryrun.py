"""Dry run: count every (architecture × shape) cell on the ``meta``
device (the JAX package's ``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A [--arch B ...]
        [--shape S]]
        [--mesh single|multi|both] [--out DIR] [--skip-ragdb]
        [--graph-cut N] [--jobs J]

The reference lowers and compiles each cell for its production mesh (16
× 16 chips, or 2 × 16 × 16) and reads XLA's ``cost_analysis`` and
``memory_analysis``.  Torch has neither.  Here each cell is built with
``device="meta"`` (tensors with a shape and no storage; weights drawn
from a CPU generator) and its step is called once, eagerly, never
through a captured graph, in its plain formulation: the blockwise
attention and no kernel of the port's (the reference lowers its XLA
formulation, no Pallas kernel).  The step runs under

- ``torch.utils.flop_counter.FlopCounterMode``: ``flops`` counts the
  matrix products and attention of the forward and backward (elementwise
  ops are not counted);
- a ``TorchDispatchMode`` (``_Tally``) that adds up every op's input
  and output bytes (``bytes_accessed``: with no fusion an upper bound on
  what a fused program moves; views move nothing) and tracks the storages
  the step creates, freed when their last tensor goes: ``temp_bytes`` is
  the peak of those alive at once.

``argument_bytes`` are the bytes of the step's arguments (weights,
optimizer state, inputs, caches), each storage once; ``output_bytes``
those of the outputs that are no argument (a train step updates its
arguments in place).  ``fits_one_card``: argument + temp bytes within
the card's memory (``torch.cuda.get_device_properties`` where a card is
present, else 80 GB, the H100's, and the record names which).

The counts describe the whole cell on one logical device, not one
device's partition (``"partitioned": false``), so the mesh changes only
the ragdb cells, whose corpus is ``docs_per_device`` × the mesh's
devices.  Collective bytes do not carry over to a one-process port
(``"collectives": null``).  Two steps are counted at 1 and 2 of their
repeated parts and extrapolated linearly (the record says so): the LM
``train_4k`` step at 1 and 2 of its 256 micro-batches, which run one
after another (so its peak is the 2-micro-batch run's), and the ragdb
retrieval at 1 and 2 of its 256 or 512 shards.  A recsys train step on ``meta`` takes every index
as a row of its own (the distinct-row count is data-dependent).

One JSON file per cell (``<arch>__<shape>__<mesh>.json`` in ``--out``);
exit 1 with the failures listed when a cell fails.  ``--jobs`` worker
processes count cells side by side (8 by default, or the host's cores).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import shapes as shp
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import transformer as T

# the H100's 80 GB, where no card is present to ask
DEFAULT_CARD_BYTES = 80 * 10**9
DEFAULT_CARD = "NVIDIA H100 80GB HBM3 (assumed: no CUDA device present)"


# --------------------------------------------------------------------------
# what a step's arguments and outputs hold
# --------------------------------------------------------------------------

def _tensors(obj):
    """Every tensor in ``obj``: nested dicts, lists and tuples, and a
    ``transformer.LM``'s parameter tree."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, T.LM):
        yield from _tensors(T.param_tree(obj))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storages(obj) -> dict:
    """{storage key: bytes} of the distinct storages under ``obj``."""
    out = {}
    for t in _tensors(obj):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """Every op's input and output bytes (``moved``; view ops none), and
    the storages created under the mode that are not in ``exclude``:
    each is live until its last tensor is freed (a finalizer on the
    storage), ``peak`` the most bytes live at once."""

    def __init__(self, exclude):
        super().__init__()
        self.exclude = set(exclude)
        self.known = set()
        self.moved = 0
        self.live = 0
        self.peak = 0

    def _freed(self, key, nbytes):
        self.known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors(out))
        if not func.is_view:
            self.moved += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.moved += sum(_nbytes(t) for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.exclude or key in self.known:
                continue
            self.known.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._freed, key, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def count_step(fn, args) -> dict:
    """One eager call of ``fn(*args)`` on meta tensors: flops, bytes
    moved, the peak of live new storages, the bytes of new outputs."""
    arg_st = _storages(args)
    tally = _Tally(arg_st)
    with FlopCounterMode(display=False) as flops, tally:
        out = fn(*args)
    new_out = {k: b for k, b in _storages(out).items() if k not in arg_st}
    return {"flops": flops.get_total_flops(), "bytes_accessed": tally.moved,
            "temp_bytes": tally.peak, "output_bytes": sum(new_out.values())}


def _extrapolated(one: dict, two: dict, n: int, name: str,
                  temp_grows: bool) -> dict:
    """Counts at 1 and 2 of a step's ``n`` repeated parts (micro-batches,
    shards), extrapolated linearly to ``n``; the peak too when each part
    leaves something alive (``temp_grows``), else the 2-part run's."""
    out = {key: one[key] + (n - 1) * (two[key] - one[key])
           for key in ("flops", "bytes_accessed")}
    out["temp_bytes"] = (one["temp_bytes"]
                         + (n - 1) * (two["temp_bytes"] - one["temp_bytes"])
                         if temp_grows else two["temp_bytes"])
    out["output_bytes"] = two["output_bytes"]
    out[name] = {"counted": [1, 2], "of": n, "extrapolated": "linearly"}
    return out


def _lm_train_counts(cell) -> dict:
    """The LM train step counted at 1 and 2 of its micro-batches, which
    run one after another beside fixed accumulators."""
    model, opt, tokens, targets = cell.args
    runs = []
    for k in (1, 2):
        step = steps.make_lm_train_step(model.cfg, k,
                                        bf16_params="master" in opt)
        runs.append(count_step(step, (model, opt, tokens[:k], targets[:k])))
    return _extrapolated(*runs, cell.meta["n_micro"], "micro_batches",
                         temp_grows=False)


def _ragdb_counts(arch_id, shape_id, n_shards) -> dict:
    """The sharded retrieval counted at 1 and 2 shards of
    ``docs_per_device`` each (every shard scores its block alike; the
    merge keeps k a shard)."""
    runs = []
    for s in (1, 2):
        cell = steps.build_cell(arch_id, shape_id, device="meta", n_shards=s)
        runs.append(count_step(cell.fn.fn, cell.args))
    return _extrapolated(*runs, n_shards, "shards", temp_grows=True)


def card_memory() -> tuple[int, str]:
    """(bytes, name) of the card a cell must fit: CUDA device 0 where
    present, else the H100's 80 GB."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, props.name
    return DEFAULT_CARD_BYTES, DEFAULT_CARD


# --------------------------------------------------------------------------
# dry-run driver
# --------------------------------------------------------------------------

def run_cell(arch_id: str, shape_id: str, multi_pod: bool = False,
             out_dir: str | None = None, verbose: bool = True,
             smoke: bool = False, graph_cut: int | None = None,
             card: tuple[int, str] | None = None) -> dict:
    """Count one cell (module docstring) and return its record, written
    to ``out_dir`` when given.  ``card`` is (bytes, name) of the card to
    fit, ``card_memory()`` by default."""
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    name = meshlib.mesh_name(mesh)
    t0 = time.time()
    kind = shp.shapes_for_family(configs.get(arch_id).family)[shape_id].kind
    kw = {"graph_cut": graph_cut} if kind == "gnn_train" else {}
    if kind == "ragdb_retrieve":
        kw["n_shards"] = len(mesh.devices)
    cell = steps.build_cell(arch_id, shape_id, smoke=smoke, device="meta",
                            **kw)
    t_build = time.time() - t0
    t0 = time.time()
    if kind == "lm_train":
        counts = _lm_train_counts(cell)
    elif kind == "ragdb_retrieve":
        counts = _ragdb_counts(arch_id, shape_id, kw["n_shards"])
    else:
        fn = cell.fn.fn if isinstance(cell.fn, steps.CapturedStep) \
            else cell.fn
        counts = count_step(fn, cell.args)
    counts["argument_bytes"] = sum(_storages(cell.args).values())
    t_count = time.time() - t0
    card_bytes, card = card or card_memory()
    mem = {k: counts.pop(k) for k in ("argument_bytes", "output_bytes",
                                      "temp_bytes")}
    rec = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": name,
        "n_devices": len(mesh.devices),
        "kind": cell.meta.get("kind", kind),
        "formulation": "plain",
        "partitioned": False,
        "reduced": cell.meta.get("reduced", []),
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "flops": float(counts.pop("flops")),
        "flops_counts": "matrix products and attention "
                        "(FlopCounterMode); elementwise ops not counted",
        "bytes_accessed": float(counts.pop("bytes_accessed")),
        "bytes_accessed_is": "every op's inputs and outputs, no fusion: "
                             "an upper bound",
        "memory": mem,
        "card": card,
        "card_bytes": card_bytes,
        "fits_one_card": mem["argument_bytes"] + mem["temp_bytes"]
        <= card_bytes,
        "collectives": None,
        "note": "the whole cell on one logical device, not one device's "
                "partition; collective bytes do not carry over to a "
                "one-process port",
        **counts,
    }
    if verbose:
        print(f"[{name}] {arch_id} × {shape_id}: build {t_build:.1f}s count "
              f"{t_count:.1f}s  flops={rec['flops']:.3e}  "
              f"bytes={rec['bytes_accessed']:.3e}", flush=True)
        print(f"    memory: args={mem['argument_bytes']:.3e} "
              f"temp={mem['temp_bytes']:.3e} out={mem['output_bytes']:.3e}"
              f"  fits one card: {rec['fits_one_card']}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_id}__{shape_id}__{name}".replace("/", "_")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def smallest_fitting_cut(arch_id: str, shape_id: str,
                         cuts=(1, 2, 4, 8, 16, 32, 64)) -> tuple[int, dict]:
    """(cut, record): the first of ``cuts`` at which the cell fits one
    card (whole-graph GNN shapes)."""
    for cut in cuts:
        rec = run_cell(arch_id, shape_id, graph_cut=cut, verbose=False)
        if rec["fits_one_card"]:
            return cut, rec
    raise ValueError(f"{arch_id} {shape_id} fits no cut of {cuts}")


def _run_job(job) -> tuple | None:
    """A worker's cell: None, or the failure (arch, shape, multi_pod,
    error)."""
    arch_id, shape_id, multi_pod, out_dir, graph_cut, card = job
    try:
        run_cell(arch_id, shape_id, multi_pod, out_dir, graph_cut=graph_cut,
                 card=card)
        return None
    except Exception as e:  # noqa: BLE001 — report, keep going
        print(f"FAIL [{'2x16x16' if multi_pod else '16x16'}] "
              f"{arch_id} × {shape_id}: {e}\n{traceback.format_exc()}",
              flush=True)
        return (arch_id, shape_id, multi_pod, repr(e))
    finally:
        gc.collect()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch id (repeat the flag for more)")
    ap.add_argument("--shape", default=None, help="single shape id")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-ragdb", action="store_true")
    ap.add_argument("--graph-cut", type=int, default=None,
                    help="divide the nodes and edges of the whole-graph GNN "
                    "shapes (kind gnn_train); other cells are counted whole")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1),
                    help="worker processes, one cell at a time each (a "
                    "cell's count is one Python thread's work)")
    args = ap.parse_args(argv)

    if args.arch:
        cells = [(arch, s) for arch in args.arch
                 for s in ([args.shape] if args.shape else
                           shp.shapes_for_family(configs.get(arch).family))]
    else:
        cells = configs.cells()
        if args.skip_ragdb:
            cells = [c for c in cells if c[0] != "ragdb"]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    card = card_memory()
    jobs = [(arch_id, shape_id, multi_pod, args.out, args.graph_cut, card)
            for arch_id, shape_id in cells for multi_pod in meshes[args.mesh]]
    # the longest counts first
    jobs.sort(key=lambda j: not j[1].startswith(("train_4k", "prefill")))
    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawned workers: none inherits a CUDA context from this process
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn")) as ex:
            results = list(ex.map(_run_job, jobs))
    else:
        results = [_run_job(job) for job in jobs]
    failures = [r for r in results if r is not None]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nALL DRY-RUN CELLS PASSED ({len(jobs)})")


if __name__ == "__main__":
    main()
