"""The port's training substrate against the JAX package's, on the CPU:
``lm_loss`` and its gradients, the LM train step (both forms), the
recsys train step with its touched-rows table update, the MoE
multi-device forms, the train cells, ``configs.cells``/``input_specs``,
the train launcher and the example.

Weights are the JAX package's ``init`` carried across with
``params_from_numpy`` (f32 SMOKE configs), inputs numpy arrays from a
seed.  Tolerances, each the smallest the arithmetic allows:

- ``lm_loss`` within rtol 1e-5, each gradient leaf within 1e-4 of its
  largest magnitude (f32; the attention's and the logsumexp's
  summation orders differ);
- train steps, from the end of the warm-up (lr 3e-4): losses within
  rtol 1e-5 in the f32 form, 1e-4 in the optimized form: once an
  update has moved the norms' weights off 0, the two packages' losses
  on the same bf16 weights differ by up to 1.7e-5 (llama, measured),
  most of it from the norms' 1 + w, which the port rounds to bf16 as
  the reference's source writes it and XLA's fused program need not;
  each step's update, per leaf, within 1e-3 of its norm in the f32
  form and 5e-2 in the optimized form (measured at most 3.5e-4 and
  1.6e-2: the gradient of a bf16 leaf is rounded to bf16, and Adam
  takes each element's sign and scale apart, so a near-zero element's
  rounding moves its update by up to the learning rate); parameters
  within atol 2 × the learning rates summed over the steps plus rtol
  1e-4, elementwise, for the same reason.  The moments within 1e-5 of
  each leaf's largest magnitude in the f32 form, and within 1e-2 in
  the optimized form, whose gradients are bf16 (2^-8 relative, one
  bf16 ulp, at the largest elements);
- recsys steps: the dense leaves within atol 1e-6, rtol 1e-5 (f32, the
  dense table gradient against the touched rows'), table rows within
  the gradients' agreement carried through row-wise Adagrad's
  normalisation and, at the full batch, the ReLU kinks
  (``_close_recsys``);
The launcher and its restart-replay are held in
``tests/test_torch_checkpoint.py``, the ``train_lm`` example in
``tests/test_torch_examples.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.rowwise import split_tree as ref_split
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.recsys import base
from repro_torch.optim import adamw_init, rowwise
from repro_torch.optim import tree as tree_lib

from test_torch_lm import LM_ARCHS, port_config

torch.set_num_threads(1)

LOSS_RTOL, LOSS_RTOL_BF16 = 1e-5, 1e-4
GRAD_TOL = 1e-4
MOMENT_TOL, MOMENT_TOL_BF16 = 1e-5, 1e-2
RECSYS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL, GRAD_REL_KINK = 1e-5, 1e-2
UPDATE_REL, UPDATE_REL_BF16 = 1e-3, 5e-2
SEQ, MICRO, N_MICRO = 16, 1, 2


@functools.cache
def _ref_train_step(arch, optimized):
    """The JAX package's jitted LM train step (two micro-batches), one
    per arch and form: the step and cell tests share its compile."""
    rc = ref_configs.ARCHS[arch].smoke_config
    return jax.jit(ref_steps.make_lm_train_step(
        rc, ref_mesh.make_host_mesh(1), N_MICRO, bf16_params=optimized))


def _ref_params(arch):
    rc = ref_configs.ARCHS[arch].smoke_config
    return rc, port_config(rc), RT.init(jax.random.PRNGKey(0), rc)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(vocab, shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=shape).astype(np.int32),
            rng.integers(0, vocab, size=shape).astype(np.int32))


def _copies(tree):
    """A tree of tensors as float32 numpy copies (never views: JAX on the
    CPU may take a numpy buffer without copying it)."""
    return tree_lib.map_(lambda t: t.detach().to(torch.float32).numpy()
                         .copy() if t.is_floating_point()
                         else t.numpy().copy(), tree)


def _close_tree(got, want, atol, label):
    for (path, a), b in zip(tree_lib.paths(want), tree_lib.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol,
                                   err_msg=f"{label} {path}")


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

_ref_loss_grad = jax.jit(jax.value_and_grad(RT.lm_loss), static_argnums=(3,))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_its_gradients_match_the_jax_package(arch):
    rc, cfg, params = _ref_params(arch)
    toks, tgts = _tokens(rc.vocab, (2, 24))
    loss, grads = _ref_loss_grad(params, jnp.asarray(toks),
                                 jnp.asarray(tgts), rc)
    model = T.params_from_numpy(cfg, _np(params), "cpu",
                                leaf_dtype=torch.float32, requires_grad=True)
    got = T.lm_loss(model, torch.from_numpy(toks), torch.from_numpy(tgts))
    got.backward()
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(loss), rel=LOSS_RTOL)
    want = T.tree_from_reference(cfg, _np(grads))
    for (path, a), p in zip(tree_lib.paths(want),
                            tree_lib.leaves(T.param_tree(model))):
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, a / scale,
                                   atol=GRAD_TOL, rtol=0, err_msg=str(path))


def test_remat_changes_no_gradient():
    rc, cfg, params = _ref_params("gemma2-9b")
    toks, tgts = (torch.from_numpy(a) for a in _tokens(rc.vocab, (2, 20)))
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = T.params_from_numpy(c, _np(params), "cpu",
                                    leaf_dtype=torch.float32,
                                    requires_grad=True)
        T.lm_loss(model, toks, tgts).backward()
        grads.append([p.grad for p in tree_lib.leaves(T.param_tree(model))])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_serving_form_is_unchanged_by_the_casts():
    """The serving model (matrices already in the compute dtype, no
    gradient) runs the same forward as before: a bf16 model's casts are
    no-ops, and its leaves do not require grad."""
    rc, cfg, params = _ref_params("llama3.2-3b")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    model = T.params_from_numpy(cfg16, _np(params), "cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())
    w = model.layers[0].attn["w_q"]
    assert w.to(torch.bfloat16) is w


# ---------------------------------------------------------------------------
# the LM train step
# ---------------------------------------------------------------------------

def _port_state(cfg, params, optimized):
    if optimized:
        model = T.params_from_numpy(cfg, _np(params), "cpu",
                                    leaf_dtype=torch.bfloat16,
                                    requires_grad=True)
        master = T.param_tree(T.params_from_numpy(
            cfg, _np(params), "cpu", leaf_dtype=torch.float32))
        return model, {**adamw_init(master), "master": master}
    model = T.params_from_numpy(cfg, _np(params), "cpu",
                                leaf_dtype=torch.float32, requires_grad=True)
    return model, adamw_init(T.param_tree(model))


def _ref_state(params, optimized):
    if optimized:
        return (jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
                {**ref_adamw_init(params), "master": params})
    return params, ref_adamw_init(params)


def _warm(opt):
    """The state moved to the end of the warm-up, where the learning rate
    is its peak 3e-4 (from step 0 it is 0, 3e-6, 6e-6: an update of that
    size hides inside the parameters' rounding)."""
    return {**opt, "step": torch.tensor(steps.WARMUP_STEPS,
                                        dtype=torch.int32)}


def _close_update(old, new, old_ref, new_ref, rel, label):
    """The step's update (new − old, in ``param_tree``'s layout) against
    the JAX package's: per leaf, ‖Δ − Δ_ref‖ ≤ rel · ‖Δ_ref‖, and every
    leaf moved.  A dropped or sign-flipped update is off by ‖Δ_ref‖ or
    more, a halved one by half of it."""
    for (path, a0), a1, b0, b1 in zip(tree_lib.paths(old_ref),
                                      tree_lib.leaves(new_ref),
                                      tree_lib.leaves(old),
                                      tree_lib.leaves(new)):
        want, got = a1 - a0, b1 - b0
        size = float(np.linalg.norm(want))
        assert size > 0, f"{label} {path}: no update"
        err = float(np.linalg.norm(got - want)) / size
        assert err <= rel, f"{label} {path}: update off by {err:.2e}"


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch,n_steps", [("llama3.2-3b", 3),
                                          ("qwen3-moe-30b-a3b", 1)])
def test_lm_train_step_matches_the_jax_package(arch, n_steps, optimized):
    """``make_lm_train_step`` (two micro-batches of one sequence) against
    the JAX package's jitted step on the same weights, state and tokens,
    one and three steps from the end of the warm-up (a dense and an MoE
    arch; every arch's gradients are held above, and every arch's train
    cell below): the loss at every step, each step's update of the
    parameters (the f32 master in the optimized form), the parameters,
    the moments and the step counter after."""
    rc, cfg, params = _ref_params(arch)
    toks, tgts = _tokens(rc.vocab, (N_MICRO, MICRO, SEQ))
    ref_step = _ref_train_step(arch, optimized)
    step = steps.make_lm_train_step(cfg, N_MICRO, bf16_params=optimized)
    jp, jo = _ref_state(params, optimized)
    jo = {**jo, "step": jnp.asarray(steps.WARMUP_STEPS, jnp.int32)}
    model, opt = _port_state(cfg, params, optimized)
    opt = _warm(opt)

    def port_now():
        return _copies(opt["master"] if optimized else T.param_tree(model))

    def ref_now():
        return T.tree_from_reference(cfg, _np(jo["master"] if optimized
                                              else jp))

    lr_sum = 0.0
    for i in range(n_steps):
        if optimized and i:
            # each step from the reference's state, so each update is held
            # from equal inputs: the two masters' last bits differ, and
            # where that straddles a bf16 rounding the working copies
            # differ by a bf16 ulp
            opt = T.opt_state_from_numpy(cfg, _np(jo), "cpu")
            with torch.no_grad():
                tree_lib.map_(lambda p, v: p.copy_(torch.from_numpy(v)),
                              T.param_tree(model),
                              T.tree_from_reference(cfg, _np(jp)))
        lr_sum += float(steps.warmup_cosine(opt["step"], 3e-4, 100, 10000))
        old, old_ref = port_now(), ref_now()
        jp, jo, jl = ref_step(jp, jo, jnp.asarray(toks), jnp.asarray(tgts))
        model, opt, loss = step(model, opt, torch.from_numpy(toks),
                                torch.from_numpy(tgts))
        assert float(loss) == pytest.approx(
            float(jl), rel=LOSS_RTOL_BF16 if optimized else LOSS_RTOL)
        _close_update(old, port_now(), old_ref, ref_now(),
                      UPDATE_REL_BF16 if optimized else UPDATE_REL,
                      f"{arch} step {i}")
    assert int(opt["step"]) == int(jo["step"]) == steps.WARMUP_STEPS + n_steps
    atol = 2 * lr_sum + 1e-7
    _close_tree(port_now(), ref_now(), atol, "params")
    if optimized:
        # the working copy is the master rounded to bf16
        for p, mp in zip(tree_lib.leaves(T.param_tree(model)),
                         tree_lib.leaves(opt["master"])):
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), mp.to(torch.bfloat16))
    ref_opt = T.opt_state_from_numpy(cfg, _np(jo), "cpu")
    tol = MOMENT_TOL_BF16 if optimized else MOMENT_TOL
    for k in ("m", "v"):
        for (path, a), b in zip(tree_lib.paths(ref_opt[k]),
                                tree_lib.leaves(opt[k])):
            scale = float(a.abs().max()) + 1e-30
            assert float((a - b).abs().max()) <= tol * scale, (k, path)


def test_bf16_master_step_tracks_f32_step():
    """The contract of ``tests/test_optimized_paths.py``: the bf16
    working copy's training follows full-f32 training on a SMOKE config
    for three steps (loss within 5 %, master within 5e-2)."""
    rc, cfg, params = _ref_params("llama3.2-3b")
    toks, tgts = (torch.from_numpy(a)
                  for a in _tokens(cfg.vocab, (2, 4, 32)))
    step32 = steps.make_lm_train_step(cfg, 2)
    step16 = steps.make_lm_train_step(cfg, 2, bf16_params=True)
    p32, o32 = _port_state(cfg, params, False)
    p16, o16 = _port_state(cfg, params, True)
    for _ in range(3):
        p32, o32, loss32 = step32(p32, o32, toks, tgts)
        p16, o16, loss16 = step16(p16, o16, toks, tgts)
    assert abs(float(loss32) - float(loss16)) < 0.05 * abs(float(loss32))
    for a, b in zip(tree_lib.leaves(T.param_tree(p32)),
                    tree_lib.leaves(o16["master"])):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   rtol=5e-2, atol=5e-2)


def test_gradients_are_accumulated_in_f32_and_freed():
    """Each micro-batch's gradient goes into its float32 accumulator as
    backward produces it; no leaf keeps a ``.grad`` after the step."""
    rc, cfg, params = _ref_params("llama3.2-3b")
    model, opt = _port_state(cfg, params, True)
    step = steps.make_lm_train_step(cfg, 2, bf16_params=True)
    toks, tgts = (torch.from_numpy(a) for a in _tokens(cfg.vocab, (2, 1, 8)))
    step(model, opt, toks, tgts)
    assert all(p.grad is None for p in model.parameters())
    assert all(not any(h for h in getattr(p, "_post_accumulate_grad_hooks",
                                          None) or ())
               for p in model.parameters())


# ---------------------------------------------------------------------------
# the recsys train step
# ---------------------------------------------------------------------------

RECSYS_TRAIN = ("dlrm-rm2", "deepfm", "autoint")


def _recsys_case(arch, batch=64):
    rc = ref_configs.ARCHS[arch].smoke_config
    cfg = configs.get(arch).smoke_config
    params = ref_steps.RECSYS_MODULES[arch].init(jax.random.PRNGKey(0), rc)
    return rc, cfg, params


def _recsys_batches(cfg, n, batch=64):
    from repro_torch.data import pipeline

    cur = pipeline.DataCursor(seed=0)
    return [pipeline.recsys_batch(cur, batch, cfg.vocab_sizes, cfg.n_dense)
            for _ in range(n)]


def _close_recsys(tp, to, jp, jo, n_steps, grad_rel=GRAD_REL):
    """The port's recsys params and state against the JAX package's.
    Dense leaves within RECSYS_TOL.  A table row of width E moves by
    lr·g/r a step, r = √g2 ≥ rms(g): normalised by its own gradient.
    A gradient error of at most δ per element moves element i by at most
    lr·δ·(1 + |g_i|/r)/r ≤ lr·δ·(1 + √E)/r.  The two packages' table
    gradients agree to ``grad_rel`` of the largest gradient element,
    which is at most √E · max r; so each row is held to n_steps · lr ·
    grad_rel · √E · max r · (1 + √E) / (r + ε) + 1e-6.  ``grad_rel``:
    GRAD_REL (1e-5, f32 rounding) at 64 samples; GRAD_REL_KINK at the
    full 65,536, where the towers' ReLUs meet pre-activations within
    rounding of 0 (65,536 × the hidden widths of them): such a sample
    takes the other side of the kink in one package, so its whole term
    is in one row's sum and not in the other's (measured: up to 2e-3 of
    the largest element, the port's float32 against its float64).  A
    row whose gradient is rounding noise (a cancelled sum) is free to
    move by a step; a row with a real gradient is not.  g2 (+= mean g²)
    within 2·r·δ + δ² for the same δ."""
    lr = rowwise.RowwiseAdagradConfig().lr
    g2 = {k: v.numpy() for k, v in to["g2"].items()}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree_lib.leaves(tp)):
        key = path[-1].key
        a, b = np.asarray(a), b.numpy()
        if key not in rowwise.TABLE_KEYS:
            np.testing.assert_allclose(b, a, **RECSYS_TOL, err_msg=key)
            continue
        root = np.sqrt(g2[key])
        width = np.sqrt(a.size // a.shape[0])
        delta = n_steps * grad_rel * width * root.max()
        allowed = (lr * delta * (1 + width)
                   / (root + rowwise.RowwiseAdagradConfig().eps) + 1e-6)
        diff = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
        assert (diff <= allowed).all(), (key, (diff - allowed).max())
        # g2 += mean(g²): an error δ in g moves it by ≤ 2·r·δ + δ²
        want = np.asarray(jo["g2"][key])
        g2_err = np.abs(g2[key] - want)
        assert (g2_err <= 2 * root * delta + delta ** 2
                + 1e-6 * want.max()).all(), key


@pytest.mark.parametrize("arch", RECSYS_TRAIN)
def test_recsys_train_step_matches_the_jax_package(arch):
    """Three steps: the loss, every parameter (tables included) and
    every ``g2`` against the JAX package's jitted step, whose tables
    take a dense gradient."""
    rc, cfg, params = _recsys_case(arch)
    tab, dense = ref_split(params)
    jo = {**ref_adamw_init(dense),
          "g2": {k: jnp.zeros((v.shape[0],), jnp.float32)
                 for k, v in tab.items()}}
    ref_step = jax.jit(ref_steps.make_recsys_step(
        arch, rc, ref_mesh.make_host_mesh(1), "recsys_train"))
    tp = base.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    to = steps.recsys_opt_init(tp)
    step = steps.make_recsys_step(arch, cfg, "recsys_train", device="cpu")
    jp = params
    for d, sp, lab in _recsys_batches(cfg, 3):
        jb = {"sparse_idx": jnp.asarray(sp), "labels": jnp.asarray(lab)}
        tb = {"sparse_idx": sp, "labels": lab}
        if d is not None:
            jb["dense"], tb["dense"] = jnp.asarray(d), d
        jp, jo, jl = ref_step(jp, jo, jb)
        tp, to, loss = step(tp, to, tb)
        assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _close_recsys(tp, to, jp, jo, n_steps=3)
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("arch", RECSYS_TRAIN)
def test_recsys_state_carried_from_the_jax_package_continues(arch):
    """A JAX train state after one step (AdamW moments and step, the
    tables' g2) carried with ``base.opt_state_from_numpy``: the port's
    next step from it equals the JAX package's next step."""
    rc, cfg, params = _recsys_case(arch)
    tab, dense = ref_split(params)
    jo = {**ref_adamw_init(dense),
          "g2": {k: jnp.zeros((v.shape[0],), jnp.float32)
                 for k, v in tab.items()}}
    ref_step = jax.jit(ref_steps.make_recsys_step(
        arch, rc, ref_mesh.make_host_mesh(1), "recsys_train"))
    batches = []
    for d, sp, lab in _recsys_batches(cfg, 2):
        b = {"sparse_idx": sp, "labels": lab}
        if d is not None:
            b["dense"] = d
        batches.append(b)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jp, jo, _ = jax.block_until_ready(ref_step(params, jo, jb[0]))
    tp = base.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    to = base.opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    assert int(to["step"]) == 1 and to["step"].dtype == torch.int32
    assert set(to) == set(steps.recsys_opt_init(tp))
    jp, jo, jl = ref_step(jp, jo, jb[1])
    step = steps.make_recsys_step(arch, cfg, "recsys_train", device="cpu")
    tp, to, loss = step(tp, to, batches[1])
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _close_recsys(tp, to, jp, jo, n_steps=1)


@pytest.mark.parametrize("arch", RECSYS_TRAIN)
def test_recsys_touched_rows_update_equals_the_dense_update(arch):
    """The step's table update against ``rowwise_update`` over the whole
    table with the dense gradient, in the port: untouched rows and
    their g2 keep their bits, touched rows and g2 are bit-equal too."""
    _, cfg, params = _recsys_case(arch)
    tp = base.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    d, sp, lab = _recsys_batches(cfg, 1)[0]
    # the dense gradient of the tables, through the unchanged forward
    mod = steps.RECSYS_MODULES[arch]
    live = tree_lib.map_(lambda t: t.clone().requires_grad_(), tp)
    loss = base.bce_with_logits(
        mod.forward(live, None if d is None else torch.from_numpy(d),
                    torch.from_numpy(sp), cfg), torch.from_numpy(lab))
    loss.backward()
    tables, _ = rowwise.split_tree(tp)
    want = {}
    for k, t in tables.items():
        g = live[k].grad
        g, t2 = (g, t) if g.dim() == 2 else (g[:, None], t[:, None])
        new_t, new = rowwise.rowwise_update(
            g, rowwise.rowwise_init(t), t2, rowwise.RowwiseAdagradConfig())
        want[k] = (new_t.reshape(t.shape), new["g2"])
    to = steps.recsys_opt_init(tp)
    before = {k: t.clone() for k, t in tables.items()}
    step = steps.make_recsys_step(arch, cfg, "recsys_train", device="cpu")
    tb = {"sparse_idx": sp, "labels": lab}
    if d is not None:
        tb["dense"] = d
    tp, to, _ = step(tp, to, tb)
    for k, (new_t, new_g2) in want.items():
        assert torch.equal(tp[k], new_t), k
        assert torch.equal(to["g2"][k], new_g2), k
        touched = (new_g2 != 0)
        assert touched.any() and not touched.all()
        assert torch.equal(tp[k][~touched], before[k][~touched])


@pytest.mark.parametrize("arch", RECSYS_TRAIN)
def test_recsys_train_cell_runs_on_the_cpu(arch):
    """``build_cell(arch, "train_batch", smoke=True)`` at the full
    65,536-sample batch against the JAX package's cell ``fn`` on the same
    arrays (its params carried from the port's)."""
    cell = steps.build_cell(arch, "train_batch", smoke=True, device="cpu")
    assert cell.meta == {"kind": "recsys_train", "reduced": []}
    params, opt, inputs = cell.args
    assert inputs["sparse_idx"].shape == (65536, len(
        configs.get(arch).smoke_config.vocab_sizes))
    ref = ref_steps.build_cell(arch, "train_batch", ref_mesh.make_host_mesh(1),
                               smoke=True)
    # copies: the port's step then updates its tensors in place
    jp = jax.tree.map(jnp.asarray, _copies(params))
    jo = jax.tree.map(jnp.asarray, _copies(opt))
    jb = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    jp, jo, jl = jax.block_until_ready(ref.fn(jp, jo, jb))
    params, opt, loss = cell.fn(*cell.args)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _close_recsys(params, opt, jp, jo, n_steps=1, grad_rel=GRAD_REL_KINK)


# ---------------------------------------------------------------------------
# the MoE multi-device forms
# ---------------------------------------------------------------------------

def _moe_params(seed=0, d=64):
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)
    rc = ref_moe.MoEConfig(**dataclasses.asdict(cfg))
    params = ref_moe.init(jax.random.PRNGKey(seed), rc, d)
    port = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    x = np.random.default_rng(seed).normal(size=(16, d)).astype(np.float32)
    return cfg, rc, params, port, x


@pytest.mark.parametrize("n_ep", [1, 4])
def test_expert_parallel_matches_dropless_when_capacity_ample(n_ep):
    """The contract of ``tests/test_optimized_paths.py``, on 1 and on 4
    logical expert shards: equal to the dropless layer within rtol/atol
    1e-5, the same aux loss."""
    cfg, rc, params, port, x = _moe_params()
    ref, aux_ref = ref_moe.apply(params, jnp.asarray(x), rc)
    mesh = meshlib.make_host_mesh(n_ep, "cpu")
    out, aux = moe.apply_expert_parallel(port, torch.from_numpy(x), cfg,
                                         mesh, ("data",), "model",
                                         capacity_factor=16.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(aux_ref)) < 1e-6


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5])
def test_expert_parallel_drops_as_the_jax_package(capacity_factor):
    """Below ample capacity the overflowing (token, slot) pairs drop: on
    a one-device mesh, the port's output equals the JAX package's
    ``apply_expert_parallel`` (its shard_map) within 1e-5."""
    cfg, rc, params, port, x = _moe_params(1)
    rmesh = ref_mesh.make_host_mesh(1)
    want, _ = jax.jit(lambda p, xx: ref_moe.apply_expert_parallel(
        p, xx, rc, rmesh, ("data",), "model",
        capacity_factor=capacity_factor))(params, jnp.asarray(x))
    got, _ = moe.apply_expert_parallel(
        port, torch.from_numpy(x), cfg, meshlib.make_host_mesh(1, "cpu"),
        ("data",), "model", capacity_factor=capacity_factor)
    full, _ = ref_moe.apply(params, jnp.asarray(x), rc)
    assert np.abs(np.asarray(want) - np.asarray(full)).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_expert_parallel_has_the_dropless_gradient():
    cfg, _, _, port, x = _moe_params(2)
    grads = []
    for ep in (False, True):
        live = {k: v.clone().requires_grad_() for k, v in port.items()}
        xx = torch.from_numpy(x).requires_grad_()
        if ep:
            out, aux = moe.apply_expert_parallel(
                live, xx, cfg, meshlib.make_host_mesh(4, "cpu"), ("data",),
                capacity_factor=16.0)
        else:
            out, aux = moe.apply(live, xx, cfg)
        (out.square().sum() + aux).backward()
        grads.append([xx.grad] + [live[k].grad for k in sorted(live)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_meshes():
    mesh = meshlib.make_host_mesh(1, "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert meshlib.dp_axes(mesh) == ("data",) and meshlib.dp_size(mesh) == 1
    assert meshlib.all_axes(mesh) == ("data", "model")
    assert meshlib.make_host_mesh(4, "cpu").placement == "logical"
    prod = meshlib.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert meshlib.dp_axes(prod) == ("data",) and meshlib.dp_size(prod) == 16


# ---------------------------------------------------------------------------
# cells, shapes, the launcher and the example
# ---------------------------------------------------------------------------

def test_cells_and_input_specs_equal_the_jax_package():
    assert configs.cells() == ref_configs.cells()
    for arch_id, shape_id in configs.cells():
        family = configs.ARCHS[arch_id].family
        cfg = configs.get(arch_id).config
        rcfg = ref_configs.get(arch_id).config
        spec = shapes.shapes_for_family(family)[shape_id]
        got = shapes.input_specs(cfg, spec)
        want = ref_shapes.input_specs(
            rcfg, ref_shapes.shapes_for_family(family)[shape_id])
        assert list(got) == list(want), (arch_id, shape_id)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch_id, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_cell_runs_on_the_cpu(arch):
    """``build_cell(arch, "train_4k", smoke=True)``: the reference's
    256 micro-batches of one 4,096-token sequence, uncut; then the cell
    cut to batch 2 and seq 16, one step against the JAX package's
    optimized train step on the same working copy, master, state and
    tokens."""
    cell = steps.build_cell(arch, "train_4k", smoke=True, device="cpu")
    model, opt, toks, tgts = cell.args
    assert cell.meta == {"kind": "lm_train", "n_micro": 256, "micro": 1,
                         "reduced": []}
    assert toks.shape == tgts.shape == (256, 1, 4096)
    assert model.embed.dtype == torch.bfloat16 and model.embed.requires_grad
    assert all(t.dtype == torch.float32
               for t in tree_lib.leaves(opt["master"]))
    del cell, model, opt
    cell = steps.build_cell(arch, "train_4k", smoke=True, device="cpu",
                            batch=2, seq=16)
    assert cell.meta["reduced"] == ["batch 256 -> 2", "seq 4096 -> 16"]
    model, opt, toks, tgts = cell.args
    opt["step"] = _warm(opt)["step"]
    rc = ref_configs.ARCHS[arch].smoke_config
    cfg = port_config(rc)
    ref_step = _ref_train_step(arch, True)
    unit = lambda tree: jax.tree.map(  # noqa: E731
        jnp.asarray, _to_reference(cfg, rc, tree))
    # copies: the port's step then updates its tensors in place
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      unit(_copies(T.param_tree(model))))
    jo = {"m": unit(_copies(opt["m"])), "v": unit(_copies(opt["v"])),
          "step": jnp.asarray(int(opt["step"]), jnp.int32),
          "master": unit(_copies(opt["master"]))}
    old = _copies(opt["master"])
    old_ref = T.tree_from_reference(cfg, _np(jo["master"]))
    _, jo, jl = jax.block_until_ready(ref_step(
        jp, jo, jnp.asarray(toks.numpy()), jnp.asarray(tgts.numpy())))
    _, opt, loss = cell.fn(*cell.args)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _close_update(old, _copies(opt["master"]), old_ref,
                  T.tree_from_reference(cfg, _np(jo["master"])),
                  UPDATE_REL_BF16, arch)
    for (path, a), b in zip(
            tree_lib.paths(T.tree_from_reference(cfg, _np(jo["m"]))),
            tree_lib.leaves(opt["m"])):
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b.numpy()).max() <= MOMENT_TOL_BF16 * scale, path


def _to_reference(cfg, rc, tree):
    """``param_tree``'s layout back to the JAX package's (head, scan
    stacked over units, tail): the inverse of ``tree_from_reference``."""
    layers = tree["layers"]
    p = len(cfg.pattern)
    head = layers[:cfg.n_dense_head_layers]
    body = layers[cfg.n_dense_head_layers:]
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "head": head, "tail": body[cfg.n_units * p:]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    if cfg.n_units:
        out["scan"] = {f"l{j}": jax.tree.map(
            lambda *xs: np.stack(xs),
            *[body[u * p + j] for u in range(cfg.n_units)])
            for j in range(p)}
    return out


def test_train_cells_and_launcher_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.build_cell("llama3.2-3b", "train_4k", smoke=True, batch=1,
                         seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.build_cell("dlrm-rm2", "train_batch", smoke=True, batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])


def test_flash_kernel_refuses_gradients():
    """The forward-only kernel raises where autograd would need its
    backward (checked with the device type a CUDA operand has); on the
    CPU the wrapper's plain version runs and has a gradient."""
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.refuse_grad("cuda", (True, False, False), True)
    fa_ops.refuse_grad("cuda", (True, True, True), False)
    fa_ops.refuse_grad("cuda", (False, False, False), True)
    fa_ops.refuse_grad("cpu", (True, True, True), True)
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True)
               for _ in range(3))
    fa_ops.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad.abs().sum() > 0
