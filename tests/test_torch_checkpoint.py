"""The port's checkpointer and fault-tolerance runtime (`checkpoint/`,
`runtime/`) on the CPU.

The contracts of ``tests/test_checkpoint_runtime.py`` run through the
port (the hypothesis-driven rebalance over fixed seeds): bit-exact
restore, async save and ``latest_step``, a crash during a save,
restart-replay determinism (bit for bit on the CPU), restart planning,
elastic rebalance, straggler detection.  Then the two packages read
each other's checkpoints: a JAX-written LM train state (the AdamW state
of the optimized form, bf16 working copy included) restores into the
port through ``opt_state_from_numpy``/``params_from_numpy`` and gives
the JAX package's tensors bit for bit, and a port-written state
restores through the JAX package's ``Checkpointer``.  Last, the train
launcher: ``python -m repro_torch.launch.train --device cpu --smoke``
against the JAX package's ``--smoke`` launcher (printed losses within
rtol 1e-4 after 21 steps), and its restart-replay bit-equal to an
uninterrupted run.
"""
import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.models import transformer as RT
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataCursor, lm_batch
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import tree as tree_lib
from repro_torch.runtime.elastic import rebalance_corpus
from repro_torch.runtime.fault import HeartbeatTable, plan_restart
from repro_torch.runtime.straggler import StragglerDetector

from test_torch_lm import port_config

torch.set_num_threads(1)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 4))
                                         .astype(np.float32)),
                   "b": torch.from_numpy(rng.normal(size=4)
                                         .astype(np.float32)),
                   "h": torch.from_numpy(rng.normal(size=(3, 2))
                                         .astype(np.float32))
                   .to(torch.bfloat16)},
        "opt": {"m": torch.zeros((8, 4)),
                "step": torch.tensor(7, dtype=torch.int32)},
        "layers": [{"x": torch.arange(3)}],
    }


def _equal(a, b):
    for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_bit_exact(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    state = _state()
    ck.save(42, state)
    template = tree_lib.map_(torch.empty_like, state)
    restored, step = ck.restore(template)
    assert step == 42
    _equal(state, restored)


def test_checkpoint_async_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_async(1, _state(1))
    ck.save_async(2, _state(2))
    ck.wait()
    assert ck.latest_step() == 2
    restored, step = ck.restore(_state(2))
    assert step == 2
    _equal(restored, _state(2))


def test_crash_during_save_preserves_previous(tmp_path):
    """Partial shard files never corrupt the published generation."""
    root = str(tmp_path / "ck")
    ck = Checkpointer(root)
    ck.save(1, _state(1))
    open(os.path.join(root, ".shard-9-0.ragdb"), "wb").write(b"partial")
    open(os.path.join(root, ".manifest-tmp-x"), "w").write("{}")
    restored, step = ck.restore(_state(1))
    assert step == 1
    _equal(restored, _state(1))


def test_restart_replay_determinism(tmp_path):
    """Kill at step 5, restore, replay data from the cursor → bit-equal
    params at step 8 to the uninterrupted run."""
    def train(upto, ck=None, resume_from=None):
        params = {"w": torch.zeros((16,))}
        opt = adamw_init(params)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        cursor = DataCursor(seed=123)
        start = 0
        if resume_from is not None:
            state, step = resume_from.restore({"params": params,
                                               "opt": opt})
            params, opt = state["params"], state["opt"]
            cursor.step = step
            start = step
        for s in range(start, upto):
            toks, tgts = lm_batch(cursor, batch=2, seq=8, vocab=16)
            w = params["w"].detach().requires_grad_()
            loss = torch.mean(torch.square(
                w[torch.from_numpy(tgts.reshape(-1) % 16).long()].sum()
                - float(toks.sum())))
            loss.backward()
            params, opt = adamw_update({"w": w.grad}, opt, params, cfg)
            if ck is not None and s == 4:
                ck.save(5, {"params": params, "opt": opt})
        return params

    straight = train(8)
    ck = Checkpointer(str(tmp_path / "ck"))
    train(5, ck=ck)
    resumed = train(8, resume_from=ck)
    assert torch.equal(straight["w"], resumed["w"])


def test_heartbeat_and_restart_plan():
    t = HeartbeatTable(timeout=10.0)
    for w in ["w0", "w1", "w2", "w3"]:
        t.beat(w, now=100.0)
    t.beat("w1", now=105.0)
    assert t.dead_workers(now=112.0) == ["w0", "w2", "w3"]
    plan = plan_restart(t, chips_per_worker=64, model_parallel=16,
                        latest_ckpt_step=500, now=112.0)
    assert plan.survivors == ("w1",)
    assert plan.mesh_shape == (4, 16)
    assert plan.restore_step == 500
    assert plan.data_cursor_step == 500


@pytest.mark.parametrize("seed", range(12))
def test_elastic_rebalance_properties(seed):
    rng = np.random.default_rng(seed)
    n_shards, n_old, n_new = (int(v) for v in rng.integers(1, [41, 11, 11]))
    old_workers = [f"w{i}" for i in range(n_old)]
    new_workers = [f"w{i}" for i in rng.choice(
        range(n_old + n_new), size=max(1, n_new), replace=False)]
    owners = {i: old_workers[rng.integers(0, n_old)] for i in range(n_shards)}
    moves = rebalance_corpus(owners, new_workers)
    final = dict(owners)
    for mv in moves:
        final[mv.shard_index] = mv.dst
    assert all(w in new_workers for w in final.values())
    loads = {w: 0 for w in new_workers}
    for w in final.values():
        loads[w] += 1
    assert max(loads.values()) - min(loads.values()) <= 1
    for mv in moves:
        assert owners[mv.shard_index] != mv.dst


def test_straggler_detection():
    d = StragglerDetector(alpha=0.5, threshold=1.4, min_samples=3)
    for _ in range(10):
        for w in ["a", "b", "c", "d"]:
            d.observe(w, 1.0 if w != "c" else 2.5)
    assert d.stragglers() == ["c"]


def test_runtime_modules_are_the_reference_copies():
    """The three runtime modules are standard-library copies: the same
    decisions as the JAX package's on the same inputs."""
    from repro.runtime import elastic as ref_elastic
    from repro.runtime import fault as ref_fault

    owners = {i: f"w{i % 3}" for i in range(10)}
    workers = ["w0", "w2", "w5"]
    assert ([tuple(m.__dict__.values()) for m in
             rebalance_corpus(owners, workers)]
            == [tuple(m.__dict__.values()) for m in
                ref_elastic.rebalance_corpus(owners, workers)])
    t, rt = HeartbeatTable(5.0), ref_fault.HeartbeatTable(5.0)
    for w, now in (("a", 1.0), ("b", 3.0), ("c", 9.0)):
        t.beat(w, now)
        rt.beat(w, now)
    plan = plan_restart(t, 8, 2, 40, now=10.0)
    ref = ref_fault.plan_restart(rt, 8, 2, 40, now=10.0)
    assert plan.__dict__ == ref.__dict__


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _jax_train_state():
    """A JAX LM train state of the optimized form (bf16 working copy,
    f32 master, AdamW moments with nonzero values, step 3)."""
    rc = ref_configs.ARCHS["llama3.2-3b"].smoke_config
    master = RT.init(jax.random.PRNGKey(0), rc)
    rng = np.random.default_rng(0)
    noise = lambda t: jnp.asarray(  # noqa: E731
        rng.normal(size=t.shape).astype(np.float32))
    opt = {**ref_adamw_init(master), "master": master}
    opt["m"] = jax.tree.map(noise, opt["m"])
    opt["v"] = jax.tree.map(lambda t: jnp.abs(noise(t)), opt["v"])
    opt["step"] = jnp.asarray(3, jnp.int32)
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), master)
    return rc, {"params": params, "opt": opt}


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    rc, state = _jax_train_state()
    RefCheckpointer(str(tmp_path / "ck")).save(3, state)
    cfg = port_config(rc)
    template = jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                            {"opt": state["opt"]})
    restored, step = Checkpointer(str(tmp_path / "ck")).restore(template)
    assert step == 3
    opt = T.opt_state_from_numpy(cfg, restored["opt"], "cpu")
    want = T.opt_state_from_numpy(
        cfg, jax.tree.map(np.asarray, state["opt"]), "cpu")
    assert int(opt["step"]) == 3 and opt["step"].dtype == torch.int32
    for k in ("m", "v", "master"):
        _equal(opt[k], want[k])
    # the bf16 working copy: stored as 2-byte words, read as bfloat16
    flat, _ = Checkpointer(str(tmp_path / "ck")).restore_flat()
    assert flat["params/embed"].dtype.str == "|V2"
    model = T.LM(cfg, T.param_tree(T.params_from_numpy(
        cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                          state["params"]), "cpu",
        leaf_dtype=torch.bfloat16)), "cpu", leaf_dtype=torch.bfloat16)
    embed = Checkpointer(str(tmp_path / "ck")).restore(
        {"params": {"embed": model.embed.detach()}})[0]["params"]["embed"]
    assert embed.dtype == torch.bfloat16 and torch.equal(embed, model.embed)


def test_a_port_checkpoint_restores_into_the_jax_package(tmp_path):
    """float32 and int32 leaves (the JAX package's checkpointer cannot
    cast the stored 2-byte words of a bfloat16 leaf back, its own
    included; the port's reads them)."""
    state = {"params": {"w": torch.randn(5, 3), "b": torch.randn(4)},
             "opt": {"step": torch.tensor(9, dtype=torch.int32),
                     "m": [torch.randn(2)]}}
    Checkpointer(str(tmp_path / "ck")).save(9, state)
    template = {"params": {"w": jnp.zeros((5, 3)), "b": jnp.zeros((4,))},
                "opt": {"step": jnp.zeros((), jnp.int32),
                        "m": [jnp.zeros(2)]}}
    restored, step = RefCheckpointer(str(tmp_path / "ck")).restore(template)
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored), tree_lib.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

_STEP_LINE = re.compile(r"^step\s+(\d+)\s+loss\s+(\S+)", re.M)


def test_train_launcher_matches_the_jax_launcher(monkeypatch):
    """``python -m repro_torch.launch.train --device cpu --smoke`` and
    the JAX package's ``--smoke`` launcher on the same seed, in one
    process (the pipeline's batches depend on the process's string
    hash) and from the same weights (the port's ``init_params`` carries
    the JAX package's ``init``): the printed losses agree."""
    from repro.launch import train as ref_train

    argv = ["--smoke", "--steps", "21"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_train.main(argv)
    want = {int(s): float(v) for s, v in _STEP_LINE.findall(out.getvalue())}

    def carried(cfg, seed, device):
        rc = ref_configs.ARCHS["llama3.2-3b"].smoke_config
        return T.params_from_numpy(cfg, jax.tree.map(np.asarray, RT.init(
            jax.random.PRNGKey(seed), rc)), device,
            leaf_dtype=torch.float32, requires_grad=True)

    monkeypatch.setattr(train, "init_params", carried)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got_last = train.main(argv + ["--device", "cpu"])
    got = {int(s): float(v) for s, v in _STEP_LINE.findall(out.getvalue())}
    assert sorted(got) == sorted(want) == [0, 10, 20]
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=1e-4), s
    assert got_last == pytest.approx(want[20], rel=1e-4)


def test_train_launcher_restart_replays_an_uninterrupted_run(tmp_path):
    """40 steps with a checkpoint every 20, then a restart to 60 in the
    same process: the restarted steps' losses equal an uninterrupted
    60-step run's bit for bit (the CPU is deterministic)."""
    common = ["--smoke", "--batch", "4", "--seq", "16", "--device", "cpu"]
    straight = train.run(train.parse_args(common + ["--steps", "60"]))
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "20"]
    first = train.run(train.parse_args(common + ck + ["--steps", "40"]))
    second = train.run(train.parse_args(common + ck + ["--steps", "60"]))
    assert first["start"] == 0 and second["start"] == 40
    assert len(first["save_s"]) == 2 and second["restore_s"] > 0
    for s in range(60):
        got = (first if s < 40 else second)["losses"][s]
        assert got == straight["losses"][s], s
