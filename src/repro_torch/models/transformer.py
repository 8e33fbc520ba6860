"""Decoder-only LM (the JAX package's ``models/transformer.py``), dense
branches.

One config drives: GQA attention, uniform vs local:global layer
patterns (gemma2/3) with sliding windows, qk-norm, sandwich norms,
attention and final logit softcaps, per-kind RoPE bases, embedding
scale, query scale, tied or untied embeddings and KV-head replication.
MLA and MoE layers raise ``NotImplementedError`` (ROADMAP Queue 1 item
10), and so does training (``lm_loss``).

The model is an ``nn.Module`` holding the weights — matrices and the
embedding in the compute dtype (rounded once; the reference rounds its
float32 weights at every use to the same values), norm weights in
float32 — with its layers in one ``nn.ModuleList`` in the reference's
order: head layers, then unit by unit the pattern's layers, then the
tail.  ``forward``, ``prefill`` and ``decode_step`` are a plain loop
over it; the reference's scan, remat and sharding plumbing are JAX-only.

KV caches: a list with one ``{"k", "v"}`` dict per layer.  Global
layers cache the full horizon; sliding-window layers cache a ring buffer
of exactly ``window`` slots (position p lives in slot p mod W; slot
validity is recomputed from the current length).  ``decode_step``
writes its token's slot in place.  ``prefill_static`` is ``prefill``
over a right-padded prompt into caches allocated beforehand, so that
prefill and decode both run on fixed shapes and buffers, which a CUDA
graph can capture (``launch/steps.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from repro_torch.models import attention as attn
from repro_torch.models import layers

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# weights stored in the compute dtype; every other leaf is a norm (f32)
_MATRICES = frozenset({"embed", "lm_head", "w_q", "w_k", "w_v", "w_o",
                       "w_gate", "w_up", "w_down"})
_UNPORTED = ("MLA and MoE layers belong to a later slice of the PyTorch "
             "port (ROADMAP Queue 1 item 10)")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    norm_topk: bool = True
    router_dtype: str = "float32"
    aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int | None = None  # V2-Lite: queries uncompressed


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
            return (self.mla.nope_head_dim + self.mla.rope_head_dim) ** -0.5
        return self.head_dim ** -0.5

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline accounting)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n = emb + d  # final norm

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qdim = m.nope_head_dim + m.rope_head_dim
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


# --------------------------------------------------------------------------
# the model and its weights
# --------------------------------------------------------------------------

def _leaf(name: str, value, cfg: LMConfig, device) -> nn.Parameter:
    # numpy leaves are copied: the model never aliases the caller's arrays
    t = value if isinstance(value, torch.Tensor) else torch.tensor(value)
    dtype = cfg.compute_dtype if name in _MATRICES else torch.float32
    return nn.Parameter(t.to(device=device, dtype=dtype),
                        requires_grad=False)


def _params(tree: dict, cfg: LMConfig, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: _leaf(k, v, cfg, device)
                             for k, v in tree.items()})


class Layer(nn.Module):
    """One decoder layer: ``norms`` (ln1, ln2, post_ln1/2), ``attn``
    (w_q, w_k, w_v, w_o, q_norm/k_norm) and ``mlp`` (w_gate, w_up,
    w_down), named as in the reference's parameter tree."""

    def __init__(self, kind: str, tree: dict, cfg: LMConfig, device):
        super().__init__()
        self.kind = kind
        self.norms = _params({k: v for k, v in tree.items()
                              if k not in ("attn", "mlp")}, cfg, device)
        self.attn = _params(tree["attn"], cfg, device)
        self.mlp = _params(tree["mlp"], cfg, device)


class LM(nn.Module):
    """The decoder: ``embed``, ``final_norm``, ``lm_head`` (untied only)
    and ``layers``."""

    def __init__(self, cfg: LMConfig, tree: dict, device):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = _leaf("embed", tree["embed"], cfg, device)
        self.final_norm = _leaf("final_norm", tree["final_norm"], cfg,
                                device)
        self.lm_head = (None if cfg.tie_embeddings
                        else _leaf("lm_head", tree["lm_head"], cfg, device))
        kinds = cfg.layer_kinds
        if len(tree["layers"]) != len(kinds):
            raise ValueError(f"{len(tree['layers'])} layer trees for "
                             f"{len(kinds)} layers")
        self.layers = nn.ModuleList(
            Layer(kind, lt, cfg, device)
            for kind, lt in zip(kinds, tree["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _check_ported(cfg: LMConfig) -> None:
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {_UNPORTED}")


def init(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random weights with the reference's init distributions (normal ×
    d_in^-1/2 matrices, normal × 0.01 embedding, zero norms), drawn
    layer by layer from ``generator`` on ``device`` (the generator's own
    device by default).  A torch generator does not replay
    ``jax.random``; tests carry the reference's weights with
    ``params_from_numpy``."""
    _check_ported(cfg)
    device = generator.device if device is None else torch.device(device)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def dense(d_in, d_out):
        # rounded to the compute dtype one matrix at a time, so the
        # float32 draw of the whole model never exists at once
        return layers.dense_init(generator, d_in, d_out, device=device) \
            .to(cfg.compute_dtype)

    tree = {"embed": layers.embed_init(generator, cfg.vocab, d,
                                       device=device).to(cfg.compute_dtype),
            "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense(d, cfg.vocab)
    tree["layers"] = []
    for _ in cfg.layer_kinds:
        lt = {"ln1": zeros(d), "ln2": zeros(d)}
        if cfg.post_norms:
            lt["post_ln1"] = zeros(d)
            lt["post_ln2"] = zeros(d)
        lt["attn"] = {"w_q": dense(d, h * hd), "w_k": dense(d, hkv * hd),
                      "w_v": dense(d, hkv * hd), "w_o": dense(h * hd, d)}
        if cfg.qk_norm:
            lt["attn"]["q_norm"] = zeros(hd)
            lt["attn"]["k_norm"] = zeros(hd)
        ff = cfg.dense_d_ff or cfg.d_ff
        lt["mlp"] = {"w_gate": dense(d, ff), "w_up": dense(d, ff),
                     "w_down": dense(ff, d)}
        tree["layers"].append(lt)
    return LM(cfg, tree, device)


def params_from_numpy(cfg: LMConfig, tree: dict, device) -> LM:
    """The reference's parameter pytree (``T.init``), as numpy arrays,
    as the port's model.  ``scan`` leaves carry a leading [n_units]
    axis; layers are taken head, then unit by unit ``l0..l{P-1}``, then
    tail."""
    _check_ported(cfg)

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
    return LM(cfg, out, torch.device(device))


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _norm(x, w):
    return layers.rms_norm(x, w, unit_offset=True)


def _gqa_project(lp: Layer, x, cfg: LMConfig, positions, base):
    b, l, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a = lp.attn
    q = (x @ a["w_q"]).view(b, l, h, hd).transpose(1, 2)
    k = (x @ a["w_k"]).view(b, l, hkv, hd).transpose(1, 2)
    v = (x @ a["w_v"]).view(b, l, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rms_norm(q, a["q_norm"], unit_offset=True)
        k = layers.rms_norm(k, a["k_norm"], unit_offset=True)
    q = layers.apply_rope(q, positions, base)
    k = layers.apply_rope(k, positions, base)
    if cfg.kv_repeat > 1:
        k = k.repeat_interleave(cfg.kv_repeat, dim=1)
        v = v.repeat_interleave(cfg.kv_repeat, dim=1)
    return q, k, v


def _rope_base_for(cfg: LMConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_base_local is not None:
        return cfg.rope_base_local
    return cfg.rope_base


def _attn_out(lp: Layer, o, x):
    """[B, H, L, hd] attention output → [B, L, d_model]."""
    b, h, l, hd = o.shape
    return o.transpose(1, 2).reshape(b, l, h * hd) @ lp.attn["w_o"]


def _mlp_block(lp: Layer, x, a, cfg: LMConfig):
    """Residual add of the attention output, then the MLP sublayer."""
    if cfg.post_norms:
        a = _norm(a, lp.norms["post_ln1"])
    x = x + a
    m = layers.mlp_apply(lp.mlp, _norm(x, lp.norms["ln2"]),
                         activation=cfg.activation)
    if cfg.post_norms:
        m = _norm(m, lp.norms["post_ln2"])
    return x + m


def _layer_full(lp: Layer, x, cfg: LMConfig, positions, backend):
    """One layer over the whole sequence; returns (x, k, v)."""
    kind = lp.kind
    q, k, v = _gqa_project(lp, _norm(x, lp.norms["ln1"]), cfg, positions,
                           _rope_base_for(cfg, kind))
    o = attn.attention(
        q, k, v, scale=cfg.attn_scale, causal=True,
        window=cfg.window if kind == "local" else None,
        softcap=cfg.attn_softcap, backend=backend,
    )
    return _mlp_block(lp, x, _attn_out(lp, o, x), cfg), k, v


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _embed(model: LM, tokens, cfg: LMConfig):
    x = model.embed[tokens]
    if cfg.embed_scale:
        # √d rounded to the compute dtype first, as the reference does;
        # rounded on the host, so nothing waits for the device
        x = x * torch.tensor(cfg.d_model ** 0.5,
                             dtype=cfg.compute_dtype).item()
    return x


def _unembed(model: LM, x, cfg: LMConfig):
    x = layers.rms_norm(x, model.final_norm, unit_offset=True)
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _positions(b: int, l: int, device):
    return torch.arange(l, device=device).expand(b, l)


def forward(model: LM, tokens, cfg: LMConfig | None = None,
            backend: str = "auto"):
    """Full-sequence forward.  tokens [B, L] → (logits [B, L, V] f32,
    aux): aux is the MoE loss, 0 for the dense layers ported here."""
    cfg = model.cfg if cfg is None else cfg
    b, l = tokens.shape
    positions = _positions(b, l, tokens.device)
    x = _embed(model, tokens, cfg)
    for lp in model.layers:
        x, _, _ = _layer_full(lp, x, cfg, positions, backend)
    return _unembed(model, x, cfg), torch.zeros((), device=x.device)


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
    """Zeroed caches, one ``{"k", "v"}`` dict per layer."""
    _check_ported(cfg)
    dtype = dtype or cfg.compute_dtype
    return [
        {name: torch.zeros((batch, cfg.n_kv_eff,
                            _cache_len(cfg, kind, max_len), cfg.head_dim),
                           dtype=dtype, device=device)
         for name in ("k", "v")}
        for kind in cfg.layer_kinds
    ]


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
    """The prompt tokens [B, L] through every layer, each layer's keys
    and values written into its cache in place (a ring cache up to the
    real ``lengths``); returns the last layer's output [B, L, d]."""
    b, l = tokens.shape
    positions = _positions(b, l, tokens.device)
    x = _embed(model, tokens, cfg)
    for lp, cache in zip(model.layers, caches):
        x, k, v = _layer_full(lp, x, cfg, positions, backend)
        n_slots = cache["k"].shape[2]
        for name, seq in (("k", k), ("v", v)):
            if n_slots >= l:
                cache[name][:, :, :l] = seq
            else:
                cache[name].copy_(_fill_cache_from_seq(seq, n_slots, lengths))
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
    under the padding, and a ring cache is filled up to the real length.
    Slots at or past a row's length hold padding or an older request's
    entries, which decode masks.  Returns (logits [B, V] f32 at position
    length - 1, caches, lengths)."""
    cfg = model.cfg if cfg is None else cfg
    b = tokens.shape[0]
    x = _prefill_layers(model, tokens, lengths, caches, cfg, backend)
    last = (lengths.to(torch.int64) - 1)[:, None, None]
    x = x.gather(1, last.expand(b, 1, x.shape[-1]))
    return _unembed(model, x, cfg)[:, 0], caches, lengths


def _layer_decode(lp: Layer, x, cache, cfg: LMConfig, lengths):
    """One decoded token through one layer; writes its cache slot in
    place and returns x."""
    b = x.shape[0]
    kind = lp.kind
    positions = (lengths - 1)[:, None].to(torch.int64)  # [B, 1]
    q, k_new, v_new = _gqa_project(lp, _norm(x, lp.norms["ln1"]), cfg,
                                   positions, _rope_base_for(cfg, kind))
    k_cache, v_cache = cache["k"], cache["v"]
    n_slots = k_cache.shape[2]
    slot = ((lengths - 1) % n_slots).to(torch.int64)  # [B]
    b_idx = torch.arange(b, device=x.device)
    k_cache[b_idx, :, slot, :] = k_new[:, :, 0, :].to(k_cache.dtype)
    v_cache[b_idx, :, slot, :] = v_new[:, :, 0, :].to(v_cache.dtype)
    if kind == "local" and cfg.window is not None \
            and n_slots == min(cfg.window, n_slots):
        # ring cache: validity = slot holds a real position
        slot_pos = _ring_slot_positions(n_slots, lengths)  # [B, S]
        mask = (slot_pos >= 0) & (slot_pos < lengths[:, None])
        o = attn.masked_decode_attention(
            q, k_cache, v_cache, mask, scale=cfg.attn_scale,
            softcap=cfg.attn_softcap)
    else:
        o = attn.decode_attention(
            q, k_cache, v_cache, lengths, scale=cfg.attn_scale,
            window=cfg.window if kind == "local" else None,
            softcap=cfg.attn_softcap)
    return _mlp_block(lp, x, _attn_out(lp, o, x), cfg)


def decode_step(model: LM, caches: list[dict], tokens, lengths,
                cfg: LMConfig | None = None, backend: str = "auto"):
    """One decode step.  tokens [B, 1] (the token just sampled), lengths
    [B] = cache fill INCLUDING this token.  Returns (logits [B, 1, V],
    caches) — the caches are updated in place.  Decode attention is
    plain PyTorch on every backend, as in the reference."""
    del backend
    cfg = model.cfg if cfg is None else cfg
    x = _embed(model, tokens, cfg)
    for lp, cache in zip(model.layers, caches):
        x = _layer_decode(lp, x, cache, cfg, lengths)
    return _unembed(model, x, cfg), caches
