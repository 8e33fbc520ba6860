"""Step builders (the JAX package's ``launch/steps.py``).

The JAX package compiles each step into one program (``jax.jit``).
Here the counterpart of a serving step is a CUDA graph:
``CapturedStep`` captures a step once over static input buffers and then
replays it, so the host issues one launch per step instead of every
operator's.  On the CPU the same static-shape function runs eagerly.
The train steps run eagerly on both (capturing them is ROADMAP Queue 1
item 16).

- ``make_lm_prefill_step(cfg, max_len)`` and ``make_lm_decode_step(cfg)``
  are the JAX package's LM serving steps (its mesh argument is gone: a
  serving step runs on one card).  Prefill takes a
  right-padded prompt and the real lengths, and writes caches allocated
  beforehand, so one graph serves every prompt of a length bucket.
- ``make_lm_train_step(cfg, n_micro, ...)``: gradient accumulation over
  micro-batches (a Python loop where the reference scans), float32
  accumulators, the ``warmup_cosine`` learning rate, then AdamW; with
  ``bf16_params=True`` the model holds the bf16 working copy and
  ``opt_state["master"]`` the float32 master.
- ``GenerationSteps`` holds what ``core/rag.py`` generates with: one
  static cache, one prefill step per power-of-two prompt bucket and one
  decode step, each captured at first use.
- ``make_recsys_step(arch_id, cfg, kind, device=None)`` returns the step
  of one recsys shape kind: ``recsys_serve`` → logits [B];
  ``recsys_retrieval`` → the top 16 (values f32, ids int32) of the
  candidate scores, positions ``>= batch["n_real_candidates"]`` masked
  to -inf first, ordered (score desc, id asc) by the port's top-k
  kernel (``jax.lax.top_k``'s order; ``torch.topk`` has no tie rule on
  CUDA); ``recsys_train`` → the train step: BCE, the dense towers on
  AdamW, the tables on row-wise Adagrad over the rows the batch touches.
  A batch holds numpy arrays or tensors (``dense``, ``sparse_idx``,
  ``labels``; ``query``, ``candidate_ids``, ``n_real_candidates``); the
  step moves them to its device.  The params must already be there.
- ``build_cell(arch_id, shape_id, smoke=False, device=None, ...)``
  assembles one (architecture × shape) cell with concrete inputs made
  from a seed: ``cell.fn(*cell.args)`` runs it.  A serving cell's
  ``fn`` is the captured step and its ``args`` the static tensors; a
  train cell's ``fn`` is the eager train step and its ``args`` the
  model (or params), the optimizer state and the batch, updated in
  place by every call.  Every cell of the JAX package is built: LM
  train, prefill and decode (all five LM archs: GQA or MLA caches, dense
  or MoE layers), the three GNN train kinds (``build_gnn_cell``), recsys
  train, serve and retrieval, and the RAGdb retrieval cells
  (``ragdb_retrieve``: ``build_sharded_retrieve`` over a shard mesh).
  On ``device="meta"`` a cell holds shapes only, its weights drawn from
  a CPU generator: what ``launch/dryrun.py`` counts.
- ``make_gnn_train_step(cfg, kind)``: MACE's train step, the
  reference's loss of each GNN kind (``gnn_loss``: node cross-entropy
  over ``node_mask``, and ``seed_mask`` for the sampled kind; the mean
  squared energy error for the batched kind), the ``warmup_cosine``
  learning rate, then AdamW, in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import configs
from repro_torch.analysis import sanitizers
from repro_torch.configs import shapes as shp
from repro_torch.core.engine import resolve_device
from repro_torch.data import pipeline
from repro_torch.kernels import counters
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import ref as topk_ref
from repro_torch.models import transformer as T
from repro_torch.models.gnn import mace as mace_mod
from repro_torch.models.gnn import sampler as sampler_mod
from repro_torch.models.recsys import autoint as autoint_mod
from repro_torch.models.recsys import base as rec_base
from repro_torch.models.recsys import deepfm as deepfm_mod
from repro_torch.models.recsys import dlrm as dlrm_mod
from repro_torch.models.recsys import embedding as emb_mod
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import tree as tree_lib
from repro_torch.optim import warmup_cosine
from repro_torch.optim import rowwise

RECSYS_MODULES = {
    "dlrm-rm2": dlrm_mod, "dlrm-mlperf": dlrm_mod,
    "deepfm": deepfm_mod, "autoint": autoint_mod,
    "dlrm-rm2-smoke": dlrm_mod, "dlrm-mlperf-smoke": dlrm_mod,
    "deepfm-smoke": deepfm_mod, "autoint-smoke": autoint_mod,
}
RETRIEVAL_TOP_K = 16
# eager passes on a side stream before a capture, so that lazy set-up
# (library handles, workspaces, the kernels' builds, cached offsets) is
# done when the graph is captured
WARMUP_RUNS = 2
SMALLEST_BUCKET = 64

# the reference's schedule inside its train steps
WARMUP_STEPS, TOTAL_STEPS = 100, 10000

# minibatch_lg's base graph: as many nodes as the cell has slots, at
# ogb_products' average degree (61,859,140 / 2,449,029 = 25.3), so that
# the fanouts (15, 10) are nearly always filled
MINIBATCH_BASE_DEGREE = 25
# the JAX package lowers the ragdb cells on its 16 × 16 production mesh
REFERENCE_RAGDB_SHARDS = 256


# ==========================================================================
# capture and replay
# ==========================================================================

def cell_device(device) -> torch.device:
    """``resolve_device``'s rule (cuda unless the CPU is asked for), and
    ``meta``: a cell there holds shapes and no storage, and its step
    runs eagerly (what ``launch/dryrun.py`` counts)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device``; a CPU one for
    ``meta``, which has no generator (meta tensors draw nothing)."""
    return torch.Generator("cpu" if device.type == "meta" else device
                           ).manual_seed(seed)


def _copy_into(static, new) -> None:
    """Copy ``new`` into the static buffers ``static`` (the same nesting
    of dicts, lists and tuples).  A tensor leaf takes a tensor or numpy
    array of its shape; any other leaf must be the same object or equal,
    because a captured graph cannot change it."""
    if static is new:
        return
    if isinstance(static, torch.Tensor):
        if isinstance(new, np.ndarray):
            new = torch.from_numpy(new)
        if not isinstance(new, torch.Tensor) or new.shape != static.shape:
            raise ValueError(
                f"a static input of shape {tuple(static.shape)} got "
                f"{getattr(new, 'shape', type(new).__name__)}")
        static.copy_(new)
    elif isinstance(static, dict):
        if set(static) != set(new):
            raise ValueError(f"input keys {sorted(new)} differ from the "
                             f"static {sorted(static)}")
        for key in static:
            _copy_into(static[key], new[key])
    elif isinstance(static, (list, tuple)):
        if len(static) != len(new):
            raise ValueError(f"{len(new)} inputs for {len(static)} static")
        for s, n in zip(static, new):
            _copy_into(s, n)
    elif static != new:
        raise ValueError(f"a captured step's constant input {static!r} "
                         f"cannot become {new!r}")


class CapturedStep:
    """``fn`` over static inputs, captured once into a CUDA graph.

    ``static_inputs`` is the tuple of ``fn``'s arguments: tensors (in
    dicts, lists or tuples) that stay at fixed addresses, and anything
    else (a model, a Python number) that stays fixed.  A call copies
    the inputs it is given into the static buffers (none given: they
    are used as they stand) and returns ``fn``'s outputs.

    On ``cuda`` the first call (or ``capture()``) warms ``fn`` up on a
    side stream and captures one pass of it; every call then replays
    the graph and returns the same output tensors, overwritten.  A
    failed capture raises: the step never falls back to eager.  The
    outputs, and every tensor the step allocates, come from the graph's
    private memory pool, so a kernel's host-encoded operand addresses
    (the TMA maps of the flash and HSF kernels) stay valid.  The kernel
    wrappers count launches only while their Python runs: the warm-up
    and capture passes are taken back out of the counts, and each
    replay adds the captured pass's counts (``launches``) again.

    On ``cpu`` each call runs ``fn`` eagerly on the static buffers.
    Calls must not overlap (one thread at a time per step).

    Every step registers with the capture guard
    (``analysis.sanitizers.register_capture``) under ``name`` (default:
    ``fn``'s name); ``captures`` counts its captures (0 or 1, always 0
    on the CPU), which the armed guard holds at their baseline.
    """

    def __init__(self, fn, static_inputs: tuple, device=None,
                 name: str | None = None):
        self.fn = fn
        self.inputs = tuple(static_inputs)
        self.device = cell_device(device)
        self.name = name or getattr(fn, "__name__", "step")
        self.graph = None
        self.outputs = None
        self.launches: dict[tuple[str, str], int] = {}
        self.capture_s = 0.0
        self.captures = 0
        sanitizers.register_capture(self)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self, *inputs) -> None:
        """Copy ``inputs`` in and capture now, if not yet captured (a
        no-op on the CPU): set-up a caller keeps out of its timings."""
        if inputs:
            _copy_into(self.inputs, inputs)
        if self.device.type != "cuda" or self.graph is not None:
            return
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), counters.recording() as setup:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with counters.recording() as captured:
                # other threads (a serving runtime's dispatches) may use
                # the card meanwhile; only this thread must stay legal
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    outputs = self.fn(*self.inputs)
            # analysis: allow[host-sync] -- the end of a capture: set-up
            #   made once per step, before its first replay and outside
            #   every timing; a replay never reaches it
            torch.cuda.synchronize()
        counters.add(counters.tally(setup, times=-1))
        self.launches = counters.tally(captured)
        self.graph, self.outputs = graph, outputs
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *inputs):
        if inputs:
            _copy_into(self.inputs, inputs)
        if self.device.type != "cuda":
            return self.fn(*self.inputs)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        counters.add(self.launches)
        return self.outputs


# ==========================================================================
# LM steps
# ==========================================================================

def make_lm_prefill_step(cfg: T.LMConfig, max_len: int,
                         backend: str = "auto"):
    """``step(model, tokens, lengths=None, caches=None)`` → (logits [B, V]
    at each row's last real position, caches, lengths): the JAX
    package's prefill step, whose ``logits[:, -1]`` this is when the
    prompts are not padded.  tokens [B, L ≤ max_len] right-padded;
    lengths [B] int32 the real lengths (default L); caches from
    ``T.init_cache(cfg, B, max_len)``, written in place (default: fresh
    ones)."""

    def step_fn(model, tokens, lengths=None, caches=None):
        b, l = tokens.shape
        if l > max_len:
            raise ValueError(f"{l} tokens exceed max_len {max_len}")
        if lengths is None:
            lengths = torch.full((b,), l, dtype=torch.int32,
                                 device=tokens.device)
        if caches is None:
            caches = T.init_cache(cfg, b, max_len, device=tokens.device)
        return T.prefill_static(model, tokens, lengths, caches, cfg, backend)

    return step_fn


def make_lm_decode_step(cfg: T.LMConfig, backend: str = "auto"):
    """``step(model, caches, tokens, lengths)`` → (logits [B, 1, V],
    caches): one token per row, lengths [B] = cache fill including it;
    the caches are written in place."""

    def step_fn(model, caches, tokens, lengths):
        return T.decode_step(model, caches, tokens, lengths, cfg, backend)

    return step_fn


class _GradAccumulator:
    """Adds each leaf's gradient into a float32 accumulator as soon as
    backward has produced it, then frees it (a post-accumulate-grad
    hook): a micro-batch's gradients never exist beside the
    accumulators as a whole."""

    def __init__(self, leaves):
        self.acc = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
        self._handles = []
        for p, a in zip(leaves, self.acc):
            p.grad = None
            self._handles.append(
                p.register_post_accumulate_grad_hook(self._hook(a)))

    @staticmethod
    def _hook(acc):
        def fn(p):
            acc.add_(p.grad.to(torch.float32))
            p.grad = None
        return fn

    def close(self):
        for h in self._handles:
            h.remove()


def make_lm_train_step(cfg: T.LMConfig, n_micro: int,
                       adamw: AdamWConfig | None = None,
                       backend: str = "blockwise",
                       bf16_params: bool = False):
    """``step(model, opt_state, tokens, targets)`` → (model, opt_state,
    loss): tokens/targets [n_micro, micro_batch, seq].  Each micro-batch's
    ``lm_loss`` is backpropagated and its gradients summed into float32
    accumulators, which are then divided by ``n_micro``; the loss is the
    mean of the micro losses.  ``bf16_params=True``: the model holds the
    bf16 working copy (``T.init(..., leaf_dtype=torch.bfloat16,
    requires_grad=True)``) and ``opt_state["master"]`` the float32
    master in ``T.param_tree``'s layout; AdamW updates the master, which
    is cast back into the working copy.  Otherwise AdamW updates the
    model's own leaves.  Model and state (the dict itself: its ``step``
    is replaced) are updated in place, so a cell's ``fn(*args)`` can be
    called again.
    ``backend`` is the attention's: the blockwise path (the reference's
    ``"xla"``), since the flash kernel has no backward."""
    adamw = adamw or AdamWConfig()

    def step_fn(model, opt_state, tokens, targets):
        params = T.param_tree(model)
        acc = _GradAccumulator(tree_lib.leaves(params))
        losses = []
        try:
            for i in range(n_micro):
                loss = T.lm_loss(model, tokens[i], targets[i], cfg, backend)
                loss.backward()
                losses.append(loss.detach())
        finally:
            acc.close()
        grads = tree_lib.from_leaves(params,
                                     [a.div_(n_micro) for a in acc.acc])
        lr = warmup_cosine(opt_state["step"], adamw.lr, WARMUP_STEPS,
                           TOTAL_STEPS)
        if bf16_params:
            inner = {k: opt_state[k] for k in ("m", "v", "step")}
            master, new_inner = adamw_update(grads, inner,
                                             opt_state["master"], adamw, lr)
            with torch.no_grad():
                tree_lib.map_(lambda p, mp: p.copy_(mp.to(p.dtype)), params,
                              master)
            opt_state.update(new_inner)
        else:
            opt_state.update(adamw_update(grads, opt_state, params, adamw,
                                          lr)[1])
        return model, opt_state, torch.stack(losses).mean()

    return step_fn


def prompt_bucket(n: int, max_context: int) -> int:
    """The padded length a prompt of ``n`` tokens is prefilled at: the
    smallest power of two from 64 that holds it, at most
    ``max_context`` (which must hold it)."""
    if not 1 <= n <= max_context:
        raise ValueError(f"a prompt of {n} tokens, context {max_context}")
    bucket = SMALLEST_BUCKET
    while bucket < n:
        bucket *= 2
    return min(bucket, max_context)


class GenerationSteps:
    """Batch-1 greedy generation on static shapes: one cache of
    ``max_context + max_new_tokens`` slots, a prefill step per prompt
    bucket (``prompt_bucket``; 64, 128, 256 and 512 at a 512-token
    context) and one decode step, each a ``CapturedStep`` captured at
    its first use.  All steps write the same cache, so one request at a
    time."""

    def __init__(self, model: T.LM, cfg: T.LMConfig, max_context: int,
                 max_new_tokens: int):
        self.model, self.cfg = model, cfg
        self.max_context = max_context
        self.max_len = max_context + max_new_tokens
        dev = self.device = model.device
        caches = self.caches = T.init_cache(cfg, 1, self.max_len, device=dev)
        prefill = make_lm_prefill_step(cfg, self.max_len)
        decode = make_lm_decode_step(cfg)
        self._prefill_fn = lambda tokens, lengths: prefill(
            model, tokens, lengths, caches)
        self._prefill: dict[int, CapturedStep] = {}
        self.decode = CapturedStep(
            lambda tokens, lengths: decode(model, caches, tokens, lengths),
            (torch.zeros((1, 1), dtype=torch.int64, device=dev),
             torch.ones((1,), dtype=torch.int32, device=dev)), dev,
            name=f"{cfg.name}.decode")

    def bucket(self, n: int) -> int:
        return prompt_bucket(n, self.max_context)

    def buckets(self) -> list[int]:
        """Every prompt bucket a request can take (64 … max_context)."""
        out, bucket = [], SMALLEST_BUCKET
        while True:
            out.append(min(bucket, self.max_context))
            if bucket >= self.max_context:
                return out
            bucket *= 2

    def capture_all(self) -> None:
        """Capture every prompt bucket's prefill step and the decode step
        now (a no-op on the CPU): what the serving runtime does before it
        arms the capture guard.  Each capture runs on the static buffers
        as they stand and writes the cache, which the next request's
        prefill overwrites up to its length (positions past a request's
        length are masked)."""
        for bucket in self.buckets():
            self.prefill(bucket).capture()
        self.decode.capture()

    def prefill(self, bucket: int) -> CapturedStep:
        """The step of one bucket: ``step(tokens [1, bucket] int64,
        lengths [1] int32)`` → (logits [1, V], caches, lengths).  The
        decode step is ``decode(tokens [1, 1] int64, lengths [1] int32)``
        → (logits [1, 1, V], caches)."""
        if bucket not in self._prefill:
            dev = self.device
            self._prefill[bucket] = CapturedStep(
                self._prefill_fn,
                (torch.zeros((1, bucket), dtype=torch.int64, device=dev),
                 torch.ones((1,), dtype=torch.int32, device=dev)), dev,
                name=f"{self.cfg.name}.prefill[{bucket}]")
        return self._prefill[bucket]

    def steps(self) -> list[CapturedStep]:
        return [*self._prefill.values(), self.decode]

    @property
    def captures(self) -> int:
        return sum(s.captured for s in self.steps())

    @property
    def capture_s(self) -> float:
        return sum(s.capture_s for s in self.steps())


# ==========================================================================
# GNN steps
# ==========================================================================

GNN_KINDS = ("gnn_train", "gnn_train_sampled", "gnn_train_batched")


def gnn_loss(params, batch: dict, cfg: mace_mod.MACEConfig,
             kind: str) -> torch.Tensor:
    """The reference's loss of a GNN kind (module docstring) on a batch
    of tensors on the params' device."""
    node_logits, energies = mace_mod.forward(
        params, batch["node_feats"], batch["positions"],
        batch["senders"], batch["receivers"], cfg,
        edge_mask=batch.get("edge_mask"),
        graph_ids=batch.get("graph_ids"),
        n_graphs=batch.get("n_graphs_static", 1))
    if kind == "gnn_train_batched":
        return torch.mean(torch.square(energies - batch["energy_targets"]))
    logz = torch.logsumexp(node_logits, dim=-1)
    gold = torch.gather(node_logits, -1,
                        batch["labels"][:, None].to(torch.int64))[:, 0]
    ce = logz - gold
    # padded node slots (and, for sampled training, non-seed nodes) carry
    # zero loss weight
    w = batch["node_mask"]
    if kind == "gnn_train_sampled":
        w = w * batch["seed_mask"]
    return torch.sum(ce * w) / torch.clamp_min(torch.sum(w), 1.0)


def make_gnn_train_step(cfg: mace_mod.MACEConfig, kind: str,
                        adamw: AdamWConfig | None = None):
    """``step(params, opt_state, batch)`` → (params, opt_state, loss):
    ``gnn_loss`` of ``kind``, its gradient, then AdamW (``adamw``,
    default lr 3e-4, weight decay 0.1) under the warm-up/cosine
    schedule, writing params and state in place.  A batch holds
    ``shapes.input_specs``' keys as numpy arrays or tensors (moved to the
    params' device) and ``n_graphs_static``, the batched kind's graph
    count (default 1)."""
    if kind not in GNN_KINDS:
        raise ValueError(f"unknown GNN step kind {kind!r}")
    adamw = adamw or AdamWConfig()

    def step_fn(params, opt_state, batch):
        device = params["embed"].device
        batch = {k: _on(v, device) if isinstance(v, (np.ndarray, torch.Tensor))
                 else v for k, v in batch.items()}
        live = tree_lib.map_(lambda p: p.detach().requires_grad_(), params)
        loss = gnn_loss(live, batch, cfg, kind)
        loss.backward()
        # a head the kind's loss does not read has a zero gradient, as
        # in the reference (its weight decay still applies)
        grads = tree_lib.map_(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad, live)
        lr = warmup_cosine(opt_state["step"], adamw.lr, WARMUP_STEPS,
                           TOTAL_STEPS)
        opt_state.update(adamw_update(grads, opt_state, params, adamw,
                                      lr)[1])
        return params, opt_state, loss.detach()

    return step_fn


# ==========================================================================
# recsys steps
# ==========================================================================

def _on(x, device):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=True)


def recsys_opt_init(params: dict) -> dict:
    """The recsys train state: AdamW's over the dense towers and one
    float32 ``g2`` per table row (``g2[key]`` [rows])."""
    tables, dense = rowwise.split_tree(params)
    return {**adamw_init(dense),
            "g2": {k: rowwise.rowwise_init(v)["g2"] for k, v in tables.items()}}


def _touched_rows(flat: torch.Tensor):
    """(rows int64, inverse): the distinct indices of ``flat`` and each
    index's place among them.  On ``meta`` (the dry run) their count is
    data-dependent: the bound, every index a row of its own, stands in."""
    if flat.device.type == "meta":
        return (torch.empty(flat.shape, dtype=torch.int64, device="meta"),
                torch.empty(flat.shape, dtype=torch.int64, device="meta"))
    rows, inverse = torch.unique(flat, return_inverse=True)
    return rows.to(torch.int64), inverse


def _recsys_train_step(mod, cfg, device, adamw: AdamWConfig,
                       row_cfg: rowwise.RowwiseAdagradConfig):
    def step_fn(params, opt_state, batch):
        sparse = _on(batch["sparse_idx"], device)
        labels = _on(batch["labels"], device)
        tables, dense = rowwise.split_tree(params)
        # the rows this batch touches, once each; the forward runs
        # unchanged on a table of just those rows: the field offsets
        # the model adds are folded into the indices, so that index +
        # offset is the row's place in the small table
        offs = emb_mod.cached_offsets(cfg.vocab_sizes, device)
        flat = sparse.to(torch.int32) + offs[None, :]
        rows, inverse = _touched_rows(flat.reshape(-1))
        local = (inverse.view(flat.shape) - offs[None, :]).to(torch.int32)
        touched = {k: v[rows].requires_grad_() for k, v in tables.items()}
        live = tree_lib.map_(lambda p: p.detach().requires_grad_(), dense)
        logits = mod.forward({**live, **touched},
                             _on(batch.get("dense"), device), local, cfg)
        loss = rec_base.bce_with_logits(logits, labels)
        loss.backward()
        lr = warmup_cosine(opt_state["step"], adamw.lr, WARMUP_STEPS,
                           TOTAL_STEPS)
        # the dense towers: AdamW (its global-norm clip over them only)
        inner = {k: opt_state[k] for k in ("m", "v", "step")}
        _, new_inner = adamw_update(tree_lib.map_(lambda p: p.grad, live),
                                    inner, dense, adamw, lr)
        # the tables: row-wise Adagrad on the touched rows; the others
        # keep their bits, as the dense update leaves them
        for k, t in tables.items():
            g = touched[k].grad
            rowwise.rowwise_update_rows(
                rows, g if g.dim() == 2 else g[:, None],
                {"g2": opt_state["g2"][k]},
                t if t.dim() == 2 else t[:, None], row_cfg)
        opt_state.update(new_inner)
        return params, opt_state, loss.detach()

    return step_fn


def make_recsys_step(arch_id: str, cfg, kind: str, device=None,
                     adamw: AdamWConfig | None = None):
    """The step of one recsys shape kind (module docstring).  The train
    step, ``step(params, opt_state, batch)`` → (params, opt_state, loss),
    updates params and state (``recsys_opt_init``) in place: the dense
    towers on AdamW (``adamw``, default lr 3e-4 without weight decay)
    under the reference's warm-up/cosine schedule, the tables on
    row-wise Adagrad (lr 0.02) over the rows the batch touches — what
    the reference's dense update gives, without a table-sized
    gradient."""
    mod = RECSYS_MODULES[cfg.name if cfg.name in RECSYS_MODULES else arch_id]
    device = cell_device(device)
    # full f32 in the towers on the card: a TF32 product keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False

    if kind == "recsys_serve":
        def serve(params, batch):
            return mod.forward(params, _on(batch.get("dense"), device),
                               _on(batch["sparse_idx"], device), cfg)

        return serve

    if kind == "recsys_retrieval":
        def retrieve(params, batch):
            scores = mod.retrieval_scores(
                params, _on(batch["query"], device),
                _on(batch["candidate_ids"], device), cfg)
            n = scores.shape[0]
            # analysis: allow[host-sync] -- a host int: the batch's
            #   n_real_candidates is a Python number, which a captured
            #   step holds constant (CapturedStep refuses to change it)
            n_real = int(batch.get("n_real_candidates", n))
            if n_real < n:
                pos = torch.arange(n, device=scores.device)
                scores = scores.masked_fill(pos >= n_real, float("-inf"))
            # meta (the dry run) runs nothing: the kernel's plain version
            # gives the shapes the dry run counts
            top_k = (topk_ref.top_k_ref if scores.device.type == "meta"
                     else topk_ops.top_k)
            return top_k(scores.to(torch.float32).contiguous(),
                         RETRIEVAL_TOP_K)

        return retrieve

    if kind == "recsys_train":
        return _recsys_train_step(mod, cfg, device,
                                  adamw or AdamWConfig(weight_decay=0.0),
                                  rowwise.RowwiseAdagradConfig())
    raise ValueError(f"unknown recsys step kind {kind!r}")


# ==========================================================================
# cells
# ==========================================================================

@dataclass(frozen=True)
class Cell:
    """One (architecture × shape) step with its concrete inputs:
    ``fn(*args)`` runs it (a ``CapturedStep`` over ``args``, or a train
    step).  ``meta["reduced"]`` lists each cut from the reference's
    shape."""
    arch_id: str
    shape_id: str
    fn: object
    args: tuple
    meta: dict


def _sizes(spec: shp.ShapeSpec, batch: int | None, seq: int | None):
    """(batch, seq or None, cuts) with each cut from the spec listed."""
    m = spec.meta
    b = m["batch"] if batch is None else batch
    s = m.get("seq") if seq is None else seq
    if seq is not None and "seq" not in m:
        raise ValueError(f"shape {spec.shape_id} has no seq to cut")
    cuts = [f"{name} {m[name]} -> {v}" for name, v in (("batch", b),
                                                       ("seq", s))
            if name in m and v != m[name]]
    return b, s, cuts


def build_lm_train_cell(arch_id, cfg: T.LMConfig, spec: shp.ShapeSpec,
                        device, batch=None, seq=None, seed=0) -> Cell:
    """The reference's optimized train cell: a bf16 working copy and a
    float32 master, micro-batches of one sequence (its
    one-sequence-per-device micro-batch on one device), so ``n_micro`` =
    batch.  Weights from ``seed`` (``T.init``), tokens from the data
    pipeline (``lm_batch`` at ``DataCursor(seed)``).  ``args`` = (model,
    opt_state, tokens, targets)."""
    b, s, cuts = _sizes(spec, batch, seq)
    micro = 1
    n_micro = b // micro
    gen = _generator(device, seed)
    master = T.param_tree(T.init(cfg, gen, device, leaf_dtype=torch.float32))
    model = T.LM(cfg, master, device, leaf_dtype=torch.bfloat16,
                 requires_grad=True)
    opt = {**adamw_init(master), "master": master}
    toks, tgts = pipeline.lm_batch(pipeline.DataCursor(seed=seed), b, s,
                                   cfg.vocab)
    tokens, targets = (torch.from_numpy(a.reshape(n_micro, micro, s))
                       .to(device) for a in (toks, tgts))
    step = make_lm_train_step(cfg, n_micro, bf16_params=True)
    return Cell(arch_id, spec.shape_id, step, (model, opt, tokens, targets),
                {"kind": "lm_train", "n_micro": n_micro, "micro": micro,
                 "reduced": cuts})


def build_lm_prefill_cell(arch_id, cfg: T.LMConfig, spec: shp.ShapeSpec,
                          device, batch=None, seq=None, seed=0) -> Cell:
    """Weights and tokens from ``seed``; every prompt is ``seq`` real
    tokens long."""
    b, s, cuts = _sizes(spec, batch, seq)
    gen = _generator(device, seed)
    model = T.init(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    caches = T.init_cache(cfg, b, s, device=device)
    args = (model, tokens, lengths, caches)
    fn = CapturedStep(make_lm_prefill_step(cfg, s), args, device)
    return Cell(arch_id, spec.shape_id, fn, args,
                {"kind": "lm_prefill", "max_len": s, "reduced": cuts})


def _fill_cache(caches: list[dict], gen: torch.Generator) -> None:
    """Random N(0, 1) cache entries (keys and values, or MLA's latent and
    rope key), in place, in the cache's dtype."""
    for layer in caches:
        for t in layer.values():
            t.normal_(generator=gen)


def build_lm_decode_cell(arch_id, cfg: T.LMConfig, spec: shp.ShapeSpec,
                         device, batch=None, seq=None, seed=0) -> Cell:
    """Weights, a full cache of ``seq`` slots (``lengths = seq``: the
    step's token takes the last slot, and every slot is read) and the
    tokens, from ``seed``."""
    b, s, cuts = _sizes(spec, batch, seq)
    gen = _generator(device, seed)
    model = T.init(cfg, gen, device)
    caches = T.init_cache(cfg, b, s, device=device)
    _fill_cache(caches, gen)
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                           device=device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    args = (model, caches, tokens, lengths)
    fn = CapturedStep(make_lm_decode_step(cfg), args, device)
    return Cell(arch_id, spec.shape_id, fn, args,
                {"kind": "lm_decode", "max_len": s, "reduced": cuts})


def _gnn_sizes(spec: shp.ShapeSpec, graph_cut: int | None):
    """(nodes, edges, node slots, edge slots, cuts): the shape's logical
    sizes divided by ``graph_cut`` and padded to 512, each cut listed."""
    m = spec.meta
    if graph_cut is None or graph_cut == 1:
        return (m["n_nodes"], m["n_edges"], m["pad_nodes"], m["pad_edges"],
                [])
    if spec.kind != "gnn_train" or graph_cut < 1:
        raise ValueError(f"shape {spec.shape_id} takes no graph_cut "
                         f"{graph_cut} (only a whole-graph shape is cut)")
    n, e = m["n_nodes"] // graph_cut, m["n_edges"] // graph_cut
    return (n, e, shp._pad512(n), shp._pad512(e),
            [f"n_nodes {m['n_nodes']} -> {n}",
             f"n_edges {m['n_edges']} -> {e}"])


def _padded(a: np.ndarray, slots: int) -> np.ndarray:
    out = np.zeros((slots,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def _gnn_arrays(spec: shp.ShapeSpec, cfg, n, e, pad_n, pad_e, seed):
    """(batch of numpy arrays with ``input_specs``' keys, meta entries).
    Node slots past the graph's nodes hold zero features and positions
    (their energy is exactly 0: h stays 0 through every layer), edge
    slots past its edges are ``(0, 0)``; the masks are float32."""
    m = spec.meta
    cursor = pipeline.DataCursor(seed=seed)
    if spec.kind == "gnn_train_sampled":
        # a base graph of the slots' size, 1,024 seeds, fanouts (15, 10)
        g = pipeline.gnn_graph(cursor, n, n * MINIBATCH_BASE_DEGREE,
                               cfg.d_feat)
        rng = np.random.default_rng(seed)
        seeds = rng.choice(n, size=m["batch_nodes"], replace=False)
        sub = sampler_mod.sample_subgraph(
            sampler_mod.CSRGraph(n, g["senders"], g["receivers"]), seeds,
            tuple(m["fanout"]), rng)
        keep = sub.node_mask[:, None]
        batch = {
            "node_feats": np.where(keep, g["node_feats"][sub.node_ids], 0.0
                                   ).astype(np.float32),
            "positions": np.where(keep, g["positions"][sub.node_ids], 0.0
                                  ).astype(np.float32),
            "senders": sub.senders, "receivers": sub.receivers,
            "labels": g["labels"][sub.node_ids],
            "edge_mask": sub.edge_mask.astype(np.float32),
            "node_mask": sub.node_mask.astype(np.float32),
            "seed_mask": sub.seed_mask.astype(np.float32),
        }
        return batch, {"base_nodes": n, "base_edges": n * MINIBATCH_BASE_DEGREE,
                       "sampled_nodes": int(sub.node_mask.sum()),
                       "sampled_edges": int(sub.edge_mask.sum())}
    g = pipeline.gnn_graph(cursor, n, e, cfg.d_feat, n_graphs=m["n_graphs"])
    batch = {
        "node_feats": _padded(g["node_feats"], pad_n),
        "positions": _padded(g["positions"], pad_n),
        "senders": _padded(g["senders"], pad_e),
        "receivers": _padded(g["receivers"], pad_e),
        "labels": _padded(g["labels"], pad_n),
        "edge_mask": _padded(np.ones(e, np.float32), pad_e),
        "node_mask": _padded(np.ones(n, np.float32), pad_n),
    }
    if spec.kind == "gnn_train_batched":
        batch["graph_ids"] = _padded(g["graph_ids"], pad_n)
        batch["energy_targets"] = g["energy_targets"]
    return batch, {}


def build_gnn_cell(arch_id, cfg, spec: shp.ShapeSpec, device, seed=0,
                   graph_cut: int | None = None) -> Cell:
    """MACE at the shape's feature width (``d_feat``), weights from
    ``seed`` (``mace.init``), the graph from the data pipeline
    (``gnn_graph`` at ``DataCursor(seed)``): the whole-graph shapes at
    their sizes, ``molecule`` as 128 graphs of 30 nodes and 64 edges,
    ``minibatch_lg`` sampled (fanouts (15, 10) from 1,024 seeds drawn
    with ``np.random.default_rng(seed)``) from a base graph of 169,984
    nodes and 25 edges a node.  ``graph_cut`` divides a whole-graph
    shape's nodes and edges (``meta["reduced"]`` lists it).  ``fn`` is
    the eager train step, ``args`` (params, opt_state, batch), updated
    in place by every call.  On ``meta`` the batch is
    ``shapes.input_specs``' meta tensors at the cell's slot counts."""
    m = spec.meta
    cfg = replace(cfg, d_feat=m["d_feat"])
    n, e, pad_n, pad_e, cuts = _gnn_sizes(spec, graph_cut)
    params = mace_mod.init(cfg, _generator(device, seed), device)
    meta = {"kind": spec.kind, "n_nodes": n, "n_edges": e,
            "pad_nodes": pad_n, "pad_edges": pad_e, "reduced": cuts}
    if device.type == "meta":
        batch = shp.input_specs(cfg, replace(spec, meta={
            **m, "pad_nodes": pad_n, "pad_edges": pad_e}))
    else:
        arrays, extra = _gnn_arrays(spec, cfg, n, e, pad_n, pad_e, seed)
        meta.update(extra)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in arrays.items()}
    step = make_gnn_train_step(cfg, spec.kind)
    n_graphs = m["n_graphs"]

    def step_with_static(params, opt_state, batch):
        return step(params, opt_state, {**batch, "n_graphs_static": n_graphs})

    return Cell(arch_id, spec.shape_id, step_with_static,
                (params, adamw_init(params), batch), meta)


def _field_ids(gen, vocab_sizes, rows: int, device) -> torch.Tensor:
    """int32 [rows, F]: column f uniform over field f's vocabulary."""
    return torch.stack([torch.randint(0, v, (rows,), generator=gen,
                                      device=device, dtype=torch.int32)
                        for v in vocab_sizes], dim=1)


def build_recsys_cell(arch_id, cfg, spec: shp.ShapeSpec, device,
                      batch=None, seed=0) -> Cell:
    """Weights (the arch's ``init``) and a batch from ``seed``.  The
    retrieval cell scores ``pad_candidates`` ids of field 0, of which the
    first ``n_candidates`` (1,000,000) are real: the step's mask is a
    constant of the graph, as the JAX package's cell fixes it.  The train
    cell's batch comes from the data pipeline (``recsys_batch`` at
    ``DataCursor(seed)``: labels that depend on field 0), its ``fn`` is
    the eager train step and its ``args`` (params, opt_state, batch)."""
    m = spec.meta
    gen = _generator(device, seed)
    params = RECSYS_MODULES[arch_id].init(cfg, gen, device)
    step = make_recsys_step(arch_id, cfg, spec.kind, device)
    if spec.kind == "recsys_train":
        b, _, cuts = _sizes(spec, batch, None)
        dense, sparse, labels = pipeline.recsys_batch(
            pipeline.DataCursor(seed=seed), b, cfg.vocab_sizes, cfg.n_dense)
        inputs = {"sparse_idx": torch.from_numpy(sparse).to(device),
                  "labels": torch.from_numpy(labels).to(device)}
        if dense is not None:
            inputs["dense"] = torch.from_numpy(dense).to(device)
        return Cell(arch_id, spec.shape_id, step,
                    (params, recsys_opt_init(params), inputs),
                    {"kind": spec.kind, "reduced": cuts})
    if spec.kind == "recsys_retrieval":
        if batch is not None:
            raise ValueError("the retrieval cell has no batch to cut")
        cuts = []
        n_pad, n_real = m["pad_candidates"], m["n_candidates"]
        cand = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        cand[:n_real] = torch.randint(0, cfg.vocab_sizes[0], (n_real,),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
        query = (torch.randn((1, cfg.n_dense), generator=gen, device=device)
                 if cfg.n_dense
                 else _field_ids(gen, cfg.vocab_sizes, 1, device))
        inputs = {"query": query, "candidate_ids": cand,
                  "n_real_candidates": n_real}
    else:
        b, _, cuts = _sizes(spec, batch, None)
        inputs = {"sparse_idx": _field_ids(gen, cfg.vocab_sizes, b, device)}
        if cfg.n_dense:
            inputs["dense"] = torch.randn((b, cfg.n_dense), generator=gen,
                                          device=device)
    args = (params, inputs)
    return Cell(arch_id, spec.shape_id, CapturedStep(step, args, device),
                args, {"kind": spec.kind, "reduced": cuts})


def build_ragdb_cell(arch_id, cfg, spec: shp.ShapeSpec, device,
                     n_shards: int | None = None, use_kernel: bool = False,
                     seed: int = 0) -> Cell:
    """The sharded retrieval step over ``docs_per_device × n_shards``
    docs: unit-norm doc and query vectors, full-range int32 signatures
    and query signatures that are the AND of two docs' (so the boost
    fires), all from ``seed`` on ``device``.  ``n_shards`` is the shard
    mesh's size (``launch.mesh.make_shard_mesh``: by default one shard
    per CUDA device, 1 on the CPU; more shards than devices are logical
    shards).  The JAX package's cell scores with the gemm path;
    ``use_kernel=True`` scores each shard with the fused HSF top-k
    kernel instead."""
    from repro_torch.core import retrieval as ret
    from repro_torch.launch import mesh as meshlib

    m = spec.meta
    if n_shards is None:
        n_shards = meshlib.default_shards(device)
    mesh = meshlib.make_shard_mesh(n_shards, device)
    n_docs = m["docs_per_device"] * n_shards
    cuts = ([f"shards {REFERENCE_RAGDB_SHARDS} -> {n_shards}"]
            if n_shards < REFERENCE_RAGDB_SHARDS else [])
    gen = _generator(device, seed)
    b = m["query_batch"]
    dv = torch.randn((n_docs, cfg.dim), generator=gen, device=device)
    dv = dv / dv.norm(dim=1, keepdim=True)
    ds = torch.randint(-2**31, 2**31, (n_docs, cfg.sig_words), generator=gen,
                       device=device, dtype=torch.int64).to(torch.int32)
    qv = torch.randn((b, cfg.dim), generator=gen, device=device)
    qv = qv / qv.norm(dim=1, keepdim=True)
    rows = torch.randint(0, n_docs, (b,), generator=gen, device=device)
    qs = ds[rows] & ds[(rows + 1) % n_docs]
    retrieve = ret.build_sharded_retrieve(
        mesh, meshlib.all_axes(mesh), n_docs=n_docs, k=cfg.top_k,
        alpha=cfg.alpha, beta=cfg.beta, use_kernel=use_kernel)
    args = (dv, ds, qv, qs)
    return Cell(arch_id, spec.shape_id, CapturedStep(retrieve, args, device),
                args, {"kind": spec.kind, "n_docs": n_docs,
                       "n_shards": n_shards,
                       "placement": meshlib.placement(mesh),
                       "use_kernel": use_kernel, "reduced": cuts})


def build_cell(arch_id: str, shape_id: str, smoke: bool = False, device=None,
               *, batch: int | None = None, seq: int | None = None,
               seed: int = 0, n_shards: int | None = None,
               use_kernel: bool = False,
               graph_cut: int | None = None) -> Cell:
    """The cell of ``arch_id`` (its SMOKE config with ``smoke``) at
    ``shape_id``, on ``device`` (cuda unless the CPU or ``meta`` is
    asked for).  ``batch`` and ``seq`` cut the reference's shape, and
    ``graph_cut`` a whole-graph GNN shape's nodes and edges; the cell's
    ``meta["reduced"]`` lists each cut.  ``n_shards`` and ``use_kernel``
    are the ragdb cells' (``build_ragdb_cell``)."""
    arch = configs.get(arch_id)
    spec = shp.shapes_for_family(arch.family)[shape_id]
    cfg = arch.smoke_config if smoke else arch.config
    device = cell_device(device)
    if graph_cut is not None and spec.kind not in GNN_KINDS:
        raise ValueError(f"shape {shape_id} has no graph to cut")
    if spec.kind in GNN_KINDS:
        if batch is not None or seq is not None:
            raise ValueError(f"shape {shape_id} has no batch or seq to cut")
        return build_gnn_cell(arch_id, cfg, spec, device, seed, graph_cut)
    if spec.kind == "ragdb_retrieve":
        if batch is not None or seq is not None:
            raise ValueError(f"shape {shape_id} has no batch or seq to cut")
        return build_ragdb_cell(arch_id, cfg, spec, device, n_shards,
                                use_kernel, seed)
    if spec.kind == "lm_train":
        return build_lm_train_cell(arch_id, cfg, spec, device, batch, seq,
                                   seed)
    if spec.kind == "lm_prefill":
        return build_lm_prefill_cell(arch_id, cfg, spec, device, batch, seq,
                                     seed)
    if spec.kind == "lm_decode":
        return build_lm_decode_cell(arch_id, cfg, spec, device, batch, seq,
                                    seed)
    if seq is not None:
        raise ValueError(f"shape {shape_id} has no seq to cut")
    return build_recsys_cell(arch_id, cfg, spec, device, batch, seed)
