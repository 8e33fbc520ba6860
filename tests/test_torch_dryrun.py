"""The port's dry run (``launch/dryrun.py``) and production mesh
(``launch/mesh.make_production_mesh``), on the CPU with no card.

- the production mesh's axes, shape, ``dp_axes`` and ``dp_size``
  against the JAX package's mesh (built in a subprocess with 512 XLA host
  devices, as the reference's dry run builds it);
- ``run_cell``'s ``argument_bytes`` against the bytes of the JAX
  package's ``jax.eval_shape`` params and optimizer state plus its
  ``shapes.input_specs``, for a GNN, a recsys and an LM cell;
- ``flops`` against analytic counts (2 · matrix elements · rows for
  each product, the attention's two products over every key block);
- ``temp_bytes`` on a chain of ops whose peak is known;
- the fit verdicts of ogb_products uncut and dlrm-mlperf FULL;
- the CLI: one JSON file per cell, exit 0, the ``--arch`` flag given
  more than once, exit 1 listing a failing cell.

Every cell's count on the single-pod mesh is in
``tests/test_torch_dryrun_cells.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import shapes as ref_shapes
from repro.models import transformer as RT
from repro.models.gnn import mace as ref_mace
from repro.models.recsys import dlrm as ref_dlrm
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.rowwise import split_tree as ref_split
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import transformer as T

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tree_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------

_REF_MESH = """
import json
from repro.launch import mesh
out = {}
for multi in (False, True):
    m = mesh.make_production_mesh(multi_pod=multi)
    out[str(multi)] = {"shape": dict(m.shape), "axes": list(m.axis_names),
                       "dp_axes": list(mesh.dp_axes(m)),
                       "dp_size": mesh.dp_size(m), "n": m.devices.size}
print(json.dumps(out))
"""


def test_production_mesh_equals_the_jax_package():
    """Both pod counts: the reference's axis names and sizes, its
    ``dp_axes``/``dp_size`` (``("data",)``, 16; ``("pod", "data")``, 32)
    and one logical ``meta`` device a position."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    proc = subprocess.run([sys.executable, "-c", _REF_MESH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        mesh = meshlib.make_production_mesh(multi_pod=multi)
        want = ref[str(multi)]
        assert mesh.shape == want["shape"]
        assert list(meshlib.all_axes(mesh)) == want["axes"]
        assert list(meshlib.dp_axes(mesh)) == want["dp_axes"]
        assert meshlib.dp_size(mesh) == want["dp_size"]
        assert len(mesh.devices) == want["n"]
        assert set(mesh.devices) == {torch.device("meta")}
        assert meshlib.mesh_name(mesh) == ("2x16x16" if multi else "16x16")
    assert meshlib.dp_size(meshlib.make_production_mesh()) == 16
    assert meshlib.dp_size(meshlib.make_production_mesh(multi_pod=True)) == 32


def test_host_mesh_without_a_device_or_a_card_raises(monkeypatch):
    """No device asked for and no card: the host mesh raises, as every
    entry point does, instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_host_mesh(2, "cuda")
    assert meshlib.make_host_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2


# ---------------------------------------------------------------------------
# what run_cell counts
# ---------------------------------------------------------------------------

def test_argument_bytes_equal_the_jax_package_shapes():
    """GNN (molecule), recsys (dlrm-rm2 train_batch) and LM (llama3.2-3b
    train_4k) SMOKE cells: params + optimizer state + inputs, from the
    reference's ``jax.eval_shape`` and ``input_specs``.  The port's LM
    working copy is bf16 in every leaf beside the float32 master (the
    reference keeps its scan-stacked leaves float32 there), so the LM's
    params count half the master's bytes."""
    rcfg = dataclasses.replace(REF_ARCHS["mace"].smoke_config, d_feat=32)
    params = jax.eval_shape(lambda: ref_mace.init(jax.random.PRNGKey(0),
                                                  rcfg))
    inputs = ref_shapes.input_specs(rcfg, ref_shapes.GNN_SHAPES["molecule"])
    want = (_tree_bytes(params) + _tree_bytes(jax.eval_shape(ref_adamw_init,
                                                             params))
            + _tree_bytes(inputs))
    rec = dryrun.run_cell("mace", "molecule", smoke=True, verbose=False)
    assert rec["memory"]["argument_bytes"] == want

    rc = REF_ARCHS["dlrm-rm2"].smoke_config
    params = jax.eval_shape(lambda: ref_dlrm.init(jax.random.PRNGKey(0), rc))
    tab, dense = ref_split(params)
    opt = {**jax.eval_shape(ref_adamw_init, dense),
           "g2": {k: jax.ShapeDtypeStruct((v.shape[0],), np.float32)
                  for k, v in tab.items()}}
    inputs = ref_shapes.input_specs(rc, ref_shapes.RECSYS_SHAPES[
        "train_batch"])
    rec = dryrun.run_cell("dlrm-rm2", "train_batch", smoke=True,
                          verbose=False)
    assert rec["memory"]["argument_bytes"] == (
        _tree_bytes(params) + _tree_bytes(opt) + _tree_bytes(inputs))

    rc = REF_ARCHS["llama3.2-3b"].smoke_config
    master = jax.eval_shape(lambda: RT.init(jax.random.PRNGKey(0), rc))
    inputs = ref_shapes.input_specs(rc, ref_shapes.LM_SHAPES["train_4k"])
    opt = {**jax.eval_shape(ref_adamw_init, master), "master": master}
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", smoke=True,
                          verbose=False)
    assert rec["memory"]["argument_bytes"] == (
        _tree_bytes(master) // 2 + _tree_bytes(opt) + _tree_bytes(inputs))
    assert rec["micro_batches"] == {"counted": [1, 2], "of": 256,
                                    "extrapolated": "linearly"}


def _mm(m, k, n):
    return 2 * m * k * n


def test_prefill_flops_equal_the_analytic_count():
    """A SMOKE llama prefill of 2 × 96 tokens: 2 · (layer matrix
    elements) · tokens, the blockwise attention's q·kᵀ and p·v over
    every key block of every query row (no causal skipping), and the
    tied head on each row's last position."""
    cfg = configs.get("llama3.2-3b").smoke_config
    b, l = 2, 96
    model = T.init(cfg, torch.Generator().manual_seed(0), "meta")
    tokens = torch.empty((b, l), dtype=torch.int64, device="meta")
    step = steps.make_lm_prefill_step(cfg, l)
    got = dryrun.count_step(step, (model, tokens))["flops"]
    layer = [t for path, t in T.param_tree(model)["layers"][0].items()
             if path in ("attn", "mlp")]
    mats = sum(v.numel() for tree in layer for v in tree.values()
               if v.dim() == 2)
    attn = 2 * _mm(b * cfg.n_heads * l, cfg.head_dim, l)
    head = _mm(b, cfg.d_model, cfg.vocab)
    assert cfg.tie_embeddings
    assert got == cfg.n_layers * (2 * mats * b * l + attn) + head


def test_gnn_step_flops_equal_the_analytic_count():
    """A SMOKE mace step (full_graph_sm on meta): each product's forward
    (2·m·k·n), its weight gradient, and its input gradient where the
    input needs one (not the features nor the radial basis, which do
    not depend on a parameter; not the energy head, which the node loss
    does not read)."""
    cfg = dataclasses.replace(configs.get("mace").smoke_config, d_feat=1433)
    cell = steps.build_cell("mace", "full_graph_sm", smoke=True,
                            device="meta")
    n, e = cell.meta["pad_nodes"], cell.meta["pad_edges"]
    c, f, r, k = cfg.d_hidden, cfg.d_feat, cfg.n_rbf, cfg.n_classes
    fwd = (_mm(n, f, c) + _mm(n, c, k) + _mm(n, c, 1)
           + cfg.n_layers * (_mm(e, r, c) + _mm(n, c, c)
                             + _mm(n, 7 * c, c) + _mm(n, c, c)))
    bwd = (_mm(n, f, c) + 2 * _mm(n, c, k)
           + cfg.n_layers * (_mm(e, r, c) + 2 * _mm(n, c, c)
                             + 2 * _mm(n, 7 * c, c) + 2 * _mm(n, c, c)))
    assert dryrun.count_step(cell.fn, cell.args)["flops"] == fwd + bwd


def test_temp_bytes_track_the_peak_of_live_storages():
    """x (an argument) → a = 2x → b = a + 1, a freed → c = [b, b], b
    freed → c.sum(): the peak is b and c at once, 3 · x's bytes; views
    move no bytes; the output is the scalar."""
    n = 1000

    def chain(x):
        a = x * 2.0
        b = a + 1.0
        del a
        c = torch.cat([b, b])
        del b
        return c.sum(), c[:10]

    x = torch.empty((n,), dtype=torch.float32, device="meta")
    out = dryrun.count_step(chain, (x,))
    assert out["temp_bytes"] == 3 * 4 * n
    assert out["output_bytes"] == 4 + 2 * 4 * n
    # mul: x in, a out; add: a in, b out; cat: b, b in, c out; sum: c in,
    # 4 bytes out; the slice is a view
    assert out["bytes_accessed"] == 4 * (2 * n + 2 * n + 4 * n + 2 * n) + 4
    assert out["flops"] == 0


@pytest.mark.parametrize("arch,shape_id", [("mace", "ogb_products"),
                                           ("dlrm-mlperf", "serve_p99"),
                                           ("dlrm-mlperf", "train_batch")])
def test_cells_too_large_for_one_card_do_not_fit(arch, shape_id):
    """ogb_products uncut (its [E, 128, 9] messages) and dlrm-mlperf FULL
    (a 96.1 GB table) exceed an 80 GB card; the record says why it
    counts what it counts."""
    rec = dryrun.run_cell(arch, shape_id, verbose=False,
                          card=(dryrun.DEFAULT_CARD_BYTES,
                                dryrun.DEFAULT_CARD))
    assert rec["fits_one_card"] is False
    assert rec["partitioned"] is False and rec["collectives"] is None
    assert rec["formulation"] == "plain"
    if arch == "dlrm-mlperf":
        assert rec["memory"]["argument_bytes"] > 96e9
    else:
        assert rec["memory"]["temp_bytes"] > 5e11


def test_ogb_products_fits_at_the_smallest_cut():
    """The smallest power-of-two cut at which ogb_products fits 80 GB,
    and the cut listed in ``reduced``."""
    cut, rec = dryrun.smallest_fitting_cut("mace", "ogb_products")
    assert cut == 16 and rec["fits_one_card"]
    assert rec["reduced"] == ["n_nodes 2449029 -> 153064",
                              "n_edges 61859140 -> 3866196"]
    half = dryrun.run_cell("mace", "ogb_products", graph_cut=cut // 2,
                           verbose=False)
    assert not half["fits_one_card"]


def test_cli_writes_one_record_per_cell(tmp_path):
    """``--arch mace --shape molecule --mesh both``: two cells, two
    files with the reference's keys, exit 0 (worker processes)."""
    dryrun.main(["--arch", "mace", "--shape", "molecule", "--mesh", "both",
                 "--out", str(tmp_path), "--jobs", "2"])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["mace__molecule__16x16.json",
                     "mace__molecule__2x16x16.json"]
    for name, n in zip(files, (256, 512)):
        rec = json.loads((tmp_path / name).read_text())
        assert rec["n_devices"] == n
        for key in ("arch", "shape", "mesh", "kind", "flops",
                    "bytes_accessed", "memory", "collectives",
                    "fits_one_card", "partitioned"):
            assert key in rec, key
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes"}
        assert rec["flops"] > 0 and rec["fits_one_card"]


def test_cli_takes_the_arch_flag_more_than_once(tmp_path):
    """``--arch deepfm --arch autoint``: every shape of both archs, one
    file a cell, exit 0 in one process."""
    dryrun.main(["--arch", "deepfm", "--arch", "autoint", "--mesh",
                 "single", "--out", str(tmp_path), "--jobs", "1"])
    want = sorted(f"{a}__{s}__16x16.json" for a, s in configs.cells()
                  if a in ("deepfm", "autoint"))
    assert len(want) == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == want


def test_cli_exits_1_listing_a_failing_cell(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such cell")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "mace", "--shape", "molecule", "--mesh",
                     "single", "--out", str(tmp_path), "--jobs", "1"])
    assert exc.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out
