"""Every (architecture × shape) cell of ``configs.cells()`` counted by
the port's dry run (``launch/dryrun.run_cell``) on the ``meta`` device
and the single-pod mesh, on the CPU with no card: the count of
``python -m repro_torch.launch.dryrun --mesh single``, one case a cell.

Each record holds the reference's keys, its memory split, the plain
formulation, the whole-cell (unpartitioned) count and no collectives;
its verdict is argument + temp bytes within the 80 GB card.  The LM
``train_4k`` cells take tens of seconds each (three micro-batches of a
full-width model, op by op on meta tensors), every other cell seconds at
most.
"""
import json

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun

CARD = (dryrun.DEFAULT_CARD_BYTES, dryrun.DEFAULT_CARD)
KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "formulation",
        "partitioned", "reduced", "flops", "bytes_accessed", "memory", "card",
        "card_bytes", "fits_one_card", "collectives", "note"}
# the cells that fit one 80 GB card whole (the rest are counted, and
# their verdict is False)
FITS = {("autoint", s) for s in ("retrieval_cand", "serve_bulk", "serve_p99",
                                 "train_batch")} | \
       {("deepfm", s) for s in ("retrieval_cand", "serve_bulk", "serve_p99",
                                "train_batch")} | \
       {("dlrm-rm2", s) for s in ("retrieval_cand", "serve_bulk",
                                  "serve_p99", "train_batch")} | \
       {("mace", s) for s in ("full_graph_sm", "minibatch_lg", "molecule")} | \
       {("deepseek-v2-lite-16b", "long_500k"), ("llama3.2-3b", "long_500k"),
        ("llama3.2-3b", "train_4k"), ("ragdb", "edge_1k")}


@pytest.mark.parametrize("arch,shape_id", configs.cells())
def test_every_cell_is_counted_on_meta(arch, shape_id):
    rec = dryrun.run_cell(arch, shape_id, verbose=False, card=CARD)
    assert KEYS <= set(rec), KEYS - set(rec)
    assert (rec["arch"], rec["shape"]) == (arch, shape_id)
    assert (rec["mesh"], rec["n_devices"]) == ("16x16", 256)
    assert rec["formulation"] == "plain" and rec["partitioned"] is False
    assert rec["collectives"] is None
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert mem["argument_bytes"] > 0
    assert min(mem.values()) >= 0 and rec["flops"] >= 0
    assert rec["bytes_accessed"] >= mem["temp_bytes"]
    assert rec["fits_one_card"] == (
        mem["argument_bytes"] + mem["temp_bytes"] <= CARD[0])
    assert rec["fits_one_card"] == ((arch, shape_id) in FITS)
    json.dumps(rec)
