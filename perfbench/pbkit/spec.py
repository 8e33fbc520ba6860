"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each is a file of its own under the benchmark's directory:

- ``configs/<config>.json``: the model and retrieval plane as run
  (``file`` of the configuration entry);
- ``traffic/<traffic>.json``: the mix's parameters, read by the one
  generator in ``pbkit/questions.py``;
- ``workloads/<cell>.json``: what belongs to the pair, the limits of
  the output check;
- ``metrics/<metric>.py``: one reader per metric;
- ``reference/<model_type>.py`` and ``adapters/<model_type>.py``: the
  plain reference of an architecture and how the program is given it.

Adding a configuration, a mix, a cell or a metric is adding files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: Path

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run of that kind."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if "workloads" not in m or self.name in m["workloads"]]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_json: Path,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = _read_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {bench_json}; "
                       f"cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _read_json(bench_json.parent / cfg_entry["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    workload = _read_json(bench_dir / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]),
                config=config, traffic=traffic, workload=workload,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                bench_dir=bench_dir)


def load_module(path: Path, name: str):
    """A module from a file path (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(cell: Cell):
    mt = cell.config["model_type"]
    return load_module(cell.bench_dir / "reference" / f"{mt}.py",
                       f"pb_reference_{mt}")


def adapter_module(cell: Cell):
    mt = cell.config["model_type"]
    return load_module(cell.bench_dir / "adapters" / f"{mt}.py",
                       f"pb_adapter_{mt}")


def metric_reader(bench_dir: Path, metric: str):
    """``read(run)`` of ``metrics/<metric>.py``: a number, or None when
    the run holds nothing for it to read."""
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "pb_metric_" + metric.replace(".", "_")).read
