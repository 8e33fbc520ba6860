"""Decoder-only LM (the JAX package's ``models/transformer.py``):
serving and forward for the five LM archs.

One config drives: GQA vs MLA attention (``models/mla.py``), dense vs
MoE FFN (``models/moe.py``, with deepseek's leading dense layers),
uniform vs local:global layer patterns (gemma2/3) with sliding windows,
qk-norm, sandwich norms, attention and final logit softcaps, per-kind
RoPE bases, embedding scale, query scale, tied or untied embeddings and
KV-head replication.  ``lm_loss`` is the training objective.

The model is an ``nn.Module`` holding the weights with its layers in
one ``nn.ModuleList`` in the reference's order: head layers, then unit
by unit the pattern's layers, then the tail.  ``forward``, ``prefill``
and ``decode_step`` are a plain loop over it.  Every layer function
casts a weight to the compute dtype where it uses it, as the reference
does.  Two forms of the weights:

- serving (the default ``leaf_dtype=None``): matrices (expert weights
  included) and the embedding in the compute dtype, rounded once (the
  reference rounds its float32 weights at every use to the same
  values), so each cast is a no-op; norms and the MoE router float32;
  no gradient;
- training (``leaf_dtype`` given, ``requires_grad=True``): every leaf in
  ``leaf_dtype`` — float32 for the reference's float32 parameters,
  bfloat16 for its optimized form's working copy (the float32 master
  then lives in the optimizer state, ``launch/steps.py``).  Gradients
  are taken with respect to these leaves through the casts.  With
  ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` when
  gradients are recorded (the reference's ``jax.checkpoint`` per scan
  unit): backward keeps the layer inputs and recomputes the rest.

Caches: a list with one dict per layer.  GQA layers hold ``{"k", "v"}``
[B, Hkv, S, Dh]: global layers cache the full horizon, sliding-window
layers a ring buffer of exactly ``window`` slots (position p lives in
slot p mod W; slot validity is recomputed from the current length).
MLA layers hold the compressed ``{"c_kv": [B, S, R], "k_rope": [B, 1,
S, rope]}``.  ``decode_step`` writes its token's slot in place.
``prefill_static`` is ``prefill`` over a right-padded prompt into caches
allocated beforehand, so that prefill and decode both run on fixed
shapes and buffers, which a CUDA graph can capture (``launch/steps.py``;
the MoE dispatch reads nothing back to the host).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.moe_decode import ops as md_ops
from repro_torch.kernels.moe_decode import ref as md_ref
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla as mla_mod, moe as moe_mod
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# weights stored in the compute dtype (expert and shared-expert weights
# too); every other leaf — the norms and the MoE router — is float32
_MATRICES = frozenset({"embed", "lm_head", "w_q", "w_k", "w_v", "w_o",
                       "w_gate", "w_up", "w_down",
                       "w_dkv", "w_kr", "w_uk", "w_uv"})


@functools.lru_cache(maxsize=None)
def _yarn(head_dim: int, base: float, scaling: tuple):
    return layers.yarn_rope(head_dim, base, dict(scaling))


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("global",)
    window: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    post_norms: bool = False
    rope_base: float = 10000.0
    rope_base_local: float | None = None
    activation: str = "silu"
    embed_scale: bool = False
    tie_embeddings: bool = True
    query_scale: float | None = None
    moe: MoEConfig | None = None
    n_dense_head_layers: int = 0  # leading dense layers when moe != None
    dense_d_ff: int | None = None
    mla: MLAConfig | None = None
    dtype: str = "bfloat16"
    remat: bool = True
    # KV-head replication factor (each KV head repeated kv_repeat×);
    # exact — a pure layout change
    kv_repeat: int = 1
    # the published ``rope_scaling`` group (a dict is accepted and kept as
    # its sorted items, so the config stays hashable): YaRN only, on MLA's
    # RoPE only (the GQA decode kernel rotates at ``rope_base`` itself)
    rope_scaling: tuple[tuple[str, object], ...] | None = None

    def __post_init__(self):
        if self.rope_scaling is None:
            return
        group = dict(self.rope_scaling)
        kind = group.get("type", group.get("rope_type"))
        if kind != "yarn":
            raise ValueError(f"rope_scaling: type {kind!r} is not "
                             "implemented (only 'yarn')")
        if self.mla is None:
            raise ValueError("rope_scaling: YaRN is implemented for MLA "
                             "only, and this config has no mla")
        # analysis: allow[snapshot-mutation] -- the caller's dict
        # becomes its sorted items once, in construction, before the
        # config is shared
        object.__setattr__(self, "rope_scaling", tuple(sorted(group.items())))

    @property
    def yarn(self) -> tuple[torch.Tensor, float, float] | None:
        """``layers.yarn_rope`` of MLA's RoPE (inverse frequencies in
        float64, the cos/sin factor, the softmax factor), or None without
        ``rope_scaling``."""
        if self.rope_scaling is None:
            return None
        return _yarn(self.mla.rope_head_dim, self.rope_base,
                     self.rope_scaling)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.n_dense_head_layers

    @property
    def n_units(self) -> int:
        return self.n_scan_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> tuple[str, ...]:
        r = self.n_scan_layers % len(self.pattern)
        return self.pattern[:r]

    def kind_of(self, pos_in_pattern: int) -> str:
        return self.pattern[pos_in_pattern]

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Every layer's kind, in the reference's order (head, units,
        tail)."""
        return ((self.pattern[0],) * self.n_dense_head_layers
                + self.pattern * self.n_units + self.tail_kinds)

    @property
    def n_kv_eff(self) -> int:
        return self.n_kv_heads * self.kv_repeat

    @property
    def attn_scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale
        if self.mla is not None:
            if self.rope_scaling is not None:
                return self.mla.scale * self.yarn[2]
            return self.mla.scale
        return self.head_dim ** -0.5

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline accounting)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n = emb + d  # final norm

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qdim = m.qk_head_dim
                return (d * self.n_heads * qdim + d * m.kv_lora_rank
                        + d * m.rope_head_dim + m.kv_lora_rank
                        + m.kv_lora_rank * self.n_heads * m.nope_head_dim
                        + m.kv_lora_rank * self.n_heads * m.v_head_dim
                        + self.n_heads * m.v_head_dim * d)
            p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params(moe_layer: bool):
            if moe_layer and self.moe is not None:
                m = self.moe
                p = d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
                if m.n_shared:
                    p += 3 * d * m.d_ff_expert * m.n_shared
                return p
            ff = self.dense_d_ff or self.d_ff
            return 3 * d * ff

        norms = d * (4 if self.post_norms else 2)
        for i in range(self.n_layers):
            moe_layer = self.moe is not None and i >= self.n_dense_head_layers
            n += attn_params() + mlp_params(moe_layer) + norms
        return n

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: the routed top-k and
        the shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_expert = 3 * m.n_experts * self.d_model * m.d_ff_expert
        active_expert = 3 * m.top_k * self.d_model * m.d_ff_expert
        n_moe_layers = self.n_layers - self.n_dense_head_layers
        return self.param_count() - n_moe_layers * (full_expert
                                                    - active_expert)

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and i >= self.n_dense_head_layers


# --------------------------------------------------------------------------
# the model and its weights
# --------------------------------------------------------------------------

def _leaf(name: str, value, cfg: LMConfig, device, leaf_dtype=None,
          requires_grad: bool = False) -> nn.Parameter:
    # numpy leaves are copied: the model never aliases the caller's arrays
    t = value if isinstance(value, torch.Tensor) else torch.tensor(value)
    if leaf_dtype is not None:
        dtype = leaf_dtype
    else:
        dtype = cfg.compute_dtype if name in _MATRICES else torch.float32
    return nn.Parameter(t.to(device=device, dtype=dtype),
                        requires_grad=requires_grad)


def _rounded(tree: dict, dtype: torch.dtype) -> dict:
    """``tree`` with its matrices in ``dtype`` (drawn float32 one layer
    at a time, so the float32 draw of the whole model never exists at
    once unless ``dtype`` is float32)."""
    return {k: _rounded(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if k in _MATRICES else v
            for k, v in tree.items()}


class Weights(nn.Module):
    """A (nested) parameter tree with the reference's leaf names:
    ``w["w_q"]`` is a parameter, ``w["shared"]`` a sub-tree."""

    def __init__(self, tree: dict, cfg: LMConfig, device, leaf_dtype=None,
                 requires_grad: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Weights(v, cfg, device, leaf_dtype,
                                           requires_grad))
            else:
                self.register_parameter(k, _leaf(k, v, cfg, device,
                                                 leaf_dtype, requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> dict:
        """The parameters as a nested dict (sub-trees as dicts)."""
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Layer(nn.Module):
    """One decoder layer: ``norms`` (ln1, ln2, post_ln1/2), ``attn`` (GQA:
    w_q, w_k, w_v, w_o, q_norm/k_norm; MLA: w_q, w_dkv, w_kr, kv_norm,
    w_uk, w_uv, w_o) and ``mlp`` (dense: w_gate, w_up, w_down; MoE:
    router, stacked w_gate/w_up/w_down, ``shared``), named as in the
    reference's parameter tree."""

    def __init__(self, kind: str, moe: bool, tree: dict, cfg: LMConfig,
                 device, leaf_dtype=None, requires_grad: bool = False,
                 rope_inv: torch.Tensor | None = None):
        super().__init__()
        self.kind, self.moe = kind, moe
        form = (cfg, device, leaf_dtype, requires_grad)
        self.norms = Weights({k: v for k, v in tree.items()
                              if k not in ("attn", "mlp")}, *form)
        self.attn = Weights(tree["attn"], *form)
        self.mlp = Weights(tree["mlp"], *form)
        # YaRN's inverse frequencies on the device (None without), made
        # once with the model so that no step copies them in
        self.register_buffer("rope_inv", rope_inv, persistent=False)

    def tree(self) -> dict:
        return {**self.norms.tree(), "attn": self.attn.tree(),
                "mlp": self.mlp.tree()}


class LM(nn.Module):
    """The decoder: ``embed``, ``final_norm``, ``lm_head`` (untied only)
    and ``layers``.  ``tree`` has ``param_tree``'s layout; ``leaf_dtype``
    and ``requires_grad`` choose the form (module docstring)."""

    def __init__(self, cfg: LMConfig, tree: dict, device, leaf_dtype=None,
                 requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        form = (cfg, device, leaf_dtype, requires_grad)
        self.embed = _leaf("embed", tree["embed"], *form)
        self.final_norm = _leaf("final_norm", tree["final_norm"], *form)
        self.lm_head = (None if cfg.tie_embeddings
                        else _leaf("lm_head", tree["lm_head"], *form))
        kinds = cfg.layer_kinds
        if len(tree["layers"]) != len(kinds):
            raise ValueError(f"{len(tree['layers'])} layer trees for "
                             f"{len(kinds)} layers")
        yarn = cfg.yarn
        rope_inv = None if yarn is None else yarn[0].to(
            device=device, dtype=torch.float32)
        self.layers = nn.ModuleList(
            Layer(kind, cfg.is_moe_layer(i), lt, *form, rope_inv=rope_inv)
            for i, (kind, lt) in enumerate(zip(kinds, tree["layers"])))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def param_tree(model: LM) -> dict:
    """The model's parameters as a nested dict: ``embed``,
    ``final_norm``, ``lm_head`` (untied only) and ``layers``, a list of
    per-layer dicts (``ln1``, ``ln2``, ``post_ln1/2``, ``attn``,
    ``mlp``) — the layout ``LM`` is built from, and the one the
    optimizer state and the checkpoints mirror."""
    out = {"embed": model.embed, "final_norm": model.final_norm,
           "layers": [lp.tree() for lp in model.layers]}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head
    return out


def _init_layer(gen, cfg: LMConfig, moe_layer: bool, device,
                mat_dtype: torch.dtype) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, device=device) \
            .to(mat_dtype)

    lt = {"ln1": zeros(d), "ln2": zeros(d)}
    if cfg.post_norms:
        lt["post_ln1"] = zeros(d)
        lt["post_ln2"] = zeros(d)
    if cfg.mla is not None:
        lt["attn"] = _rounded(mla_mod.init(gen, cfg.mla, d, h, device),
                              mat_dtype)
    else:
        lt["attn"] = {"w_q": dense(d, h * hd), "w_k": dense(d, hkv * hd),
                      "w_v": dense(d, hkv * hd), "w_o": dense(h * hd, d)}
        if cfg.qk_norm:
            lt["attn"]["q_norm"] = zeros(hd)
            lt["attn"]["k_norm"] = zeros(hd)
    if moe_layer:
        lt["mlp"] = _rounded(moe_mod.init(gen, cfg.moe, d, device),
                             mat_dtype)
    else:
        ff = cfg.dense_d_ff or cfg.d_ff
        lt["mlp"] = {"w_gate": dense(d, ff), "w_up": dense(d, ff),
                     "w_down": dense(ff, d)}
    return lt


def init(cfg: LMConfig, generator: torch.Generator, device=None,
         leaf_dtype=None, requires_grad: bool = False) -> LM:
    """Random weights with the reference's init distributions (normal ×
    d_in^-1/2 matrices and experts, normal × 0.01 embedding, zero norms),
    drawn layer by layer from ``generator`` on ``device`` (the
    generator's own device by default) and rounded, as they are drawn,
    to the compute dtype (serving) or ``leaf_dtype`` (a training form).
    A torch generator does not replay ``jax.random``; tests carry the
    reference's weights with ``params_from_numpy``."""
    device = generator.device if device is None else torch.device(device)
    mat_dtype = cfg.compute_dtype if leaf_dtype is None else leaf_dtype
    d = cfg.d_model
    tree = {"embed": layers.embed_init(generator, cfg.vocab, d,
                                       device=device).to(mat_dtype),
            "final_norm": torch.zeros((d,), dtype=torch.float32,
                                      device=device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = layers.dense_init(
            generator, d, cfg.vocab, device=device).to(mat_dtype)
    tree["layers"] = [_init_layer(generator, cfg, cfg.is_moe_layer(i),
                                  device, mat_dtype)
                      for i in range(cfg.n_layers)]
    return LM(cfg, tree, device, leaf_dtype, requires_grad)


def tree_from_reference(cfg: LMConfig, tree: dict) -> dict:
    """A tree in the layout of the reference's parameters (``T.init``:
    ``head``, ``scan`` with a leading [n_units] axis, ``tail``) in
    ``param_tree``'s layout: layers taken head, then unit by unit
    ``l0..l{P-1}``, then tail.  Leaves are passed through (an optimizer
    moment tree has the same layout)."""

    def unit_slice(sub, u):
        if isinstance(sub, dict):
            return {k: unit_slice(v, u) for k, v in sub.items()}
        return sub[u]

    flat = list(tree.get("head", []))
    for u in range(cfg.n_units):
        flat.extend(unit_slice(tree["scan"][f"l{j}"], u)
                    for j in range(len(cfg.pattern)))
    flat.extend(tree.get("tail", []))
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "layers": flat}
    if not cfg.tie_embeddings:
        out["lm_head"] = tree["lm_head"]
    return out


def params_from_numpy(cfg: LMConfig, tree: dict, device, leaf_dtype=None,
                      requires_grad: bool = False) -> LM:
    """The reference's parameter pytree (``T.init``), as numpy arrays,
    as the port's model, in the form ``leaf_dtype``/``requires_grad``
    choose (serving by default)."""
    return LM(cfg, tree_from_reference(cfg, tree), torch.device(device),
              leaf_dtype, requires_grad)


def _tensors(tree, device, dtype=None):
    """A numpy tree as tensors on ``device`` (copies), cast to ``dtype``
    when given."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree), device=device)
    return t if dtype is None else t.to(dtype)


def opt_state_from_numpy(cfg: LMConfig, state: dict, device) -> dict:
    """The reference's AdamW state (``adamw_init`` and its updates:
    ``m``, ``v``, ``step`` and, in the optimized form, the float32
    ``master``), as numpy arrays, as the port's: ``m``, ``v`` (float32)
    and ``master`` in ``param_tree``'s layout, ``step`` an int32
    scalar."""
    out = {k: _tensors(tree_from_reference(cfg, state[k]), device,
                       torch.float32)
           for k in ("m", "v", "master") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _norm(x, w):
    return layers.rms_norm(x, w, unit_offset=True)


def _gqa_heads(lp: Layer, x, cfg: LMConfig):
    """The q, k, v projections of x [B, L, d] as [B, H, L, hd] views."""
    b, l, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a, dt = lp.attn, x.dtype
    q = (x @ a["w_q"].to(dt)).view(b, l, h, hd).transpose(1, 2)
    k = (x @ a["w_k"].to(dt)).view(b, l, hkv, hd).transpose(1, 2)
    v = (x @ a["w_v"].to(dt)).view(b, l, hkv, hd).transpose(1, 2)
    return q, k, v


def _gqa_project(lp: Layer, x, cfg: LMConfig, positions, base):
    return _gqa_rotate(lp, *_gqa_heads(lp, x, cfg), cfg, positions, base)


def _qk_gains(lp: Layer, cfg: LMConfig):
    """The qk-norm gains (q_norm, k_norm), or (None, None) without."""
    return (lp.attn["q_norm"], lp.attn["k_norm"]) if cfg.qk_norm \
        else (None, None)


def _gqa_rotate(lp: Layer, q, k, v, cfg: LMConfig, positions, base):
    """qk-norm and RoPE of the projections, k and v repeated
    ``kv_repeat`` times."""
    q_norm, k_norm = _qk_gains(lp, cfg)
    q = da_ref.rotate(q, q_norm, positions, base)
    k = da_ref.rotate(k, k_norm, positions, base)
    if cfg.kv_repeat > 1:
        k = k.repeat_interleave(cfg.kv_repeat, dim=1)
        v = v.repeat_interleave(cfg.kv_repeat, dim=1)
    return q, k, v


def _rope_base_for(cfg: LMConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_base_local is not None:
        return cfg.rope_base_local
    return cfg.rope_base


def _mla_yarn(lp: Layer, cfg: LMConfig) -> dict:
    """MLA's keywords under YaRN (the softmax scale, the layer's inverse
    frequencies, the cos/sin factor); none without ``rope_scaling``."""
    if lp.rope_inv is None:
        return {}
    return {"scale": cfg.attn_scale, "inv_freq": lp.rope_inv,
            "rope_mscale": cfg.yarn[1]}


def _attn_out(lp: Layer, o):
    """[B, H, L, hd] attention output → [B, L, d_model]."""
    b, h, l, hd = o.shape
    return o.transpose(1, 2).reshape(b, l, h * hd) \
        @ lp.attn["w_o"].to(o.dtype)


def _moe_decode(params, x, m: MoEConfig):
    """The MoE layer of a decode step, x [T, D] → [T, D], without the aux
    loss (decode has no use for it).  Operands the MoE decode kernel has a
    design for (``md_ops.has_design``: bf16, a few tokens, widths it
    tiles) go to its wrapper; the rest (float32 models, the SMOKE widths)
    to its plain version (``moe.route`` and ``moe.dispatch``).  Shared
    experts are added after, as ``moe.apply`` adds them."""
    if md_ops.has_design(x, params, m):
        out = md_ops.moe_decode(x, params, m)
    else:
        out = md_ref.moe_decode_ref(x, params, m)
    return moe_mod.add_shared(params, x, out, m)


def _mlp_block(lp: Layer, x, a, cfg: LMConfig, decode: bool = False):
    """Residual add of the attention output, then the MLP sublayer (dense
    or MoE).  Returns (x, the MoE aux loss or None); ``decode`` (a decode
    step's token) takes the MoE decode layer, which computes no aux
    loss."""
    if cfg.post_norms:
        a = _norm(a, lp.norms["post_ln1"])
    x = x + a
    h = _norm(x, lp.norms["ln2"])
    aux = None
    if lp.moe:
        b, l, d = h.shape
        if decode:
            m = _moe_decode(lp.mlp, h.reshape(b * l, d), cfg.moe)
        else:
            m, aux = moe_mod.apply(lp.mlp, h.reshape(b * l, d), cfg.moe)
        m = m.view(b, l, d)
    else:
        m = layers.mlp_apply(lp.mlp, h, activation=cfg.activation)
    if cfg.post_norms:
        m = _norm(m, lp.norms["post_ln2"])
    return x + m, aux


def _layer_full(lp: Layer, x, cfg: LMConfig, positions, backend):
    """One layer over the whole sequence; returns (x, aux, kv): kv maps
    each cache entry's name to this layer's sequence of it ({"k", "v"}
    [B, Hkv, L, Dh], or MLA's {"c_kv" [B, L, R], "k_rope" [B, 1, L,
    rope]})."""
    kind = lp.kind
    xin = _norm(x, lp.norms["ln1"])
    base = _rope_base_for(cfg, kind)
    if cfg.mla is not None:
        a, (c_kv, k_rope) = mla_mod.apply(lp.attn, xin, cfg.mla, cfg.n_heads,
                                          positions, base, backend=backend,
                                          **_mla_yarn(lp, cfg))
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        q, k, v = _gqa_project(lp, xin, cfg, positions, base)
        o = attn.attention(
            q, k, v, scale=cfg.attn_scale, causal=True,
            window=cfg.window if kind == "local" else None,
            softcap=cfg.attn_softcap, backend=backend,
        )
        a, kv = _attn_out(lp, o), {"k": k, "v": v}
    x, aux = _mlp_block(lp, x, a, cfg)
    return x, aux, kv


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _embed(model: LM, tokens, cfg: LMConfig):
    x = model.embed[tokens].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # √d rounded to the compute dtype first, as the reference does;
        # rounded on the host, so nothing waits for the device
        x = x * torch.tensor(cfg.d_model ** 0.5,
                             dtype=cfg.compute_dtype).item()
    return x


def _unembed(model: LM, x, cfg: LMConfig):
    x = layers.rms_norm(x, model.final_norm, unit_offset=True)
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w.to(x.dtype)).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _positions(b: int, l: int, device):
    return torch.arange(l, device=device).expand(b, l)


def _layer_train(lp: Layer, x, cfg: LMConfig, positions, backend):
    """(x, aux) of one layer; aux 0 for a dense layer."""
    x, aux, _ = _layer_full(lp, x, cfg, positions, backend)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward(model: LM, tokens, cfg: LMConfig | None = None,
            backend: str = "auto"):
    """Full-sequence forward.  tokens [B, L] → (logits [B, L, V] f32,
    aux): aux is the MoE layers' summed load-balance loss (0 without
    MoE layers).  With ``cfg.remat``, while gradients are recorded,
    each layer is checkpointed (its activations recomputed in
    backward)."""
    cfg = model.cfg if cfg is None else cfg
    b, l = tokens.shape
    positions = _positions(b, l, tokens.device)
    x = _embed(model, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        if remat:
            x, aux = checkpoint(_layer_train, lp, x, cfg, positions, backend,
                                use_reentrant=False)
        else:
            x, aux = _layer_train(lp, x, cfg, positions, backend)
        aux_total = aux_total + aux
    return _unembed(model, x, cfg), aux_total


def lm_loss(model: LM, tokens, targets, cfg: LMConfig | None = None,
            backend: str = "blockwise") -> torch.Tensor:
    """Next-token cross entropy (mean over tokens) + the MoE aux loss.
    The logits and their logsumexp are float32.  ``backend`` defaults to
    the blockwise attention, which has a backward: the flash kernel is
    forward-only and refuses gradients."""
    logits, aux = forward(model, tokens, cfg, backend)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.to(torch.int64)[..., None])[..., 0]
    return (logz - gold).mean() + aux


# --------------------------------------------------------------------------
# KV-cache serving: prefill + decode
# --------------------------------------------------------------------------

def _cache_len(cfg: LMConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def _ring_slot_positions(n_slots: int, length) -> torch.Tensor:
    """Absolute position held by each ring slot given current fill
    ``length`` ([B] tensor or int): largest p < length with p ≡ slot
    (mod W).  Slots never written have negative p (floor division, as
    the reference's ``jnp.floor_divide``)."""
    length = torch.as_tensor(length)
    s = torch.arange(n_slots, device=length.device)
    lm1 = length[..., None] - 1
    return s + n_slots * torch.div(lm1 - s, n_slots, rounding_mode="floor")


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> list[dict]:
    """Zeroed caches, one dict per layer: ``{"k", "v"}`` [B, Hkv, S, Dh],
    or MLA's ``{"c_kv": [B, S, R], "k_rope": [B, 1, S, rope]}``."""
    dtype = dtype or cfg.compute_dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one(kind):
        s = _cache_len(cfg, kind, max_len)
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": zeros(batch, s, m.kv_lora_rank),
                    "k_rope": zeros(batch, 1, s, m.rope_head_dim)}
        return {name: zeros(batch, cfg.n_kv_eff, s, cfg.head_dim)
                for name in ("k", "v")}

    return [one(kind) for kind in cfg.layer_kinds]


def slots_view(t: torch.Tensor) -> torch.Tensor:
    """A cache entry (or its sequence) as [B, H, S, ·], slots on axis 2:
    MLA's c_kv [B, S, R] as [B, 1, S, R], a view."""
    return t[:, None] if t.dim() == 3 else t


def _fill_cache_from_seq(k_seq, n_slots: int, length):
    """The ring cache (slot = p mod n_slots) of k_seq [B, H, L, D] whose
    first ``length`` positions are real: an int, or a [B] tensor on
    k_seq's device (a right-padded batch).  Slot s holds the largest
    real p ≡ s; a slot no real position reaches holds position 0, which
    decode masks.  Nothing is copied from the host."""
    b, h, l, d = k_seq.shape
    if not isinstance(length, torch.Tensor):
        length = torch.full((b,), length, dtype=torch.int64,
                            device=k_seq.device)
    p = _ring_slot_positions(n_slots, length).clamp(0, l - 1)  # [B, S]
    return k_seq.gather(2, p[:, None, :, None].expand(b, h, n_slots, d))


def _prefill_layers(model: LM, tokens, lengths, caches: list[dict],
                    cfg: LMConfig, backend: str):
    """The prompt tokens [B, L] through every layer, each layer's cache
    entries written into its cache in place (a ring cache up to the real
    ``lengths``); returns the last layer's output [B, L, d]."""
    b, l = tokens.shape
    positions = _positions(b, l, tokens.device)
    x = _embed(model, tokens, cfg)
    for lp, cache in zip(model.layers, caches):
        x, _, kv = _layer_full(lp, x, cfg, positions, backend)
        for name, seq in kv.items():
            dst, seq = slots_view(cache[name]), slots_view(seq)
            n_slots = dst.shape[2]
            if n_slots >= l:
                dst[:, :, :l] = seq
            else:
                dst.copy_(_fill_cache_from_seq(seq, n_slots, lengths))
    return x


def prefill(model: LM, tokens, cfg: LMConfig | None = None,
            max_len: int | None = None, backend: str = "auto"):
    """Process the prompt; returns (logits [B, L, V], caches, lengths)."""
    cfg = model.cfg if cfg is None else cfg
    b, l = tokens.shape
    max_len = l if max_len is None else max_len
    caches = init_cache(cfg, b, max_len, device=tokens.device)
    lengths = torch.full((b,), l, dtype=torch.int32, device=tokens.device)
    x = _prefill_layers(model, tokens, lengths, caches, cfg, backend)
    return _unembed(model, x, cfg), caches, lengths


def prefill_static(model: LM, tokens, lengths, caches: list[dict],
                   cfg: LMConfig | None = None, backend: str = "auto"):
    """``prefill`` over static shapes, the form a captured CUDA graph
    replays.  tokens [B, L] hold each prompt right-padded to L; lengths
    [B] (on tokens' device) the real lengths, 1 <= length <= L; caches
    come from ``init_cache(cfg, B, max_len)`` with max_len >= L and are
    written in place.  Causal attention makes every real position exact
    under the padding (an MoE layer routes each token on its own), and a
    ring cache is filled up to the real length.  Slots at or past a
    row's length hold padding or an older request's entries, which
    decode masks.  Returns (logits [B, V] f32 at position length - 1,
    caches, lengths)."""
    cfg = model.cfg if cfg is None else cfg
    b = tokens.shape[0]
    x = _prefill_layers(model, tokens, lengths, caches, cfg, backend)
    last = (lengths.to(torch.int64) - 1)[:, None, None]
    x = x.gather(1, last.expand(b, 1, x.shape[-1]))
    return _unembed(model, x, cfg)[:, 0], caches, lengths


def _gqa_decode(lp: Layer, xin, cache, cfg: LMConfig, lengths):
    """GQA attention of one token against its layer's cache, whose slot
    it writes in place; returns [B, 1, d_model].  Operands the decode
    attention kernel has a design for (``da_ops.has_design``: a linear
    bf16 cache without softcap or kv replication) go to its wrapper;
    the rest (ring caches, softcaps, replication, other dtypes and head
    sizes) to the plain path."""
    kind = lp.kind
    base = _rope_base_for(cfg, kind)
    k_cache, v_cache = cache["k"], cache["v"]
    q, k_new, v_new = _gqa_heads(lp, xin, cfg)
    window = cfg.window if kind == "local" else None
    if da_ops.has_design(q, k_new, v_new, k_cache, v_cache,
                         softcap=cfg.attn_softcap, window=window):
        q_norm, k_norm = _qk_gains(lp, cfg)
        o = da_ops.decode_attention(
            q, k_new, v_new, k_cache, v_cache, lengths, scale=cfg.attn_scale,
            rope_base=base, q_norm=q_norm, k_norm=k_norm)
        return _attn_out(lp, o)
    positions = (lengths - 1)[:, None].to(torch.int64)  # [B, 1]
    q, k_new, v_new = _gqa_rotate(lp, q, k_new, v_new, cfg, positions, base)
    da_ref.append(k_cache, v_cache, k_new, v_new, lengths)
    n_slots = k_cache.shape[2]
    if window is not None and n_slots == min(window, n_slots):
        # ring cache: validity = slot holds a real position
        slot_pos = _ring_slot_positions(n_slots, lengths)  # [B, S]
        mask = (slot_pos >= 0) & (slot_pos < lengths[:, None])
        o = attn.masked_decode_attention(
            q, k_cache, v_cache, mask, scale=cfg.attn_scale,
            softcap=cfg.attn_softcap)
    else:
        o = attn.decode_attention(
            q, k_cache, v_cache, lengths, scale=cfg.attn_scale,
            window=window, softcap=cfg.attn_softcap)
    return _attn_out(lp, o)


def _layer_decode(lp: Layer, x, cache, cfg: LMConfig, lengths):
    """One decoded token through one layer; writes its cache slot in
    place and returns x."""
    xin = _norm(x, lp.norms["ln1"])
    if cfg.mla is not None:
        positions = (lengths - 1)[:, None].to(torch.int64)  # [B, 1]
        a, _ = mla_mod.decode_absorbed(
            lp.attn, xin, cfg.mla, cfg.n_heads, cache["c_kv"],
            cache["k_rope"], lengths, positions,
            _rope_base_for(cfg, lp.kind), **_mla_yarn(lp, cfg))
    else:
        a = _gqa_decode(lp, xin, cache, cfg, lengths)
    return _mlp_block(lp, x, a, cfg, decode=True)[0]


def decode_step(model: LM, caches: list[dict], tokens, lengths,
                cfg: LMConfig | None = None, backend: str = "auto"):
    """One decode step.  tokens [B, 1] (the token just sampled), lengths
    [B] = cache fill INCLUDING this token.  Returns (logits [B, 1, V],
    caches) — the caches are updated in place.  ``backend`` is ignored:
    GQA decode attention takes the decode attention kernel where it has
    a design and the plain path elsewhere (MLA: the absorbed form over
    the compressed cache, plain)."""
    del backend
    cfg = model.cfg if cfg is None else cfg
    x = _embed(model, tokens, cfg)
    for lp, cache in zip(model.layers, caches):
        x = _layer_decode(lp, x, cache, cfg, lengths)
    return _unembed(model, x, cfg), caches
