"""The decode attention core (`kernels/decode_attention`) on the CPU.

Its plain version (``ref.py``: qk-norm, RoPE at position length - 1, the
cache write, one-token attention over the linear cache) is held to the
JAX package's decode at qwen3-moe's (32:4, qk-norm) and llama3.2's (24:8,
no qk-norm) head layouts, Dh 128, with fills of 1, S/2 and S: in f32 at
2e-6 of the output's scale (another summation order; 3.7e-7 read), in
bf16 at one bf16 ulp of it (a rounding of q, k or p that the two
packages' float32 steps could put on either side of a tie; 0 read).

The decode step routes the operands the kernel has a design for to the
wrapper (on CPU tensors the wrapper runs ``ref.py`` and counts
``plain``), with the plain path's bits, and the rest (ring-cache local
layers, Dh 256 with softcap, kv replication, float32) to the plain path.
The CUDA kernel itself is held to ``ref.py`` on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as RL
from repro_torch.kernels import counters
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import transformer as T

torch.set_num_threads(1)

S = 16
# (q heads, kv heads, qk-norm, RoPE base): qwen3-moe's and llama3.2's
LAYOUTS = {"qwen3": (32, 4, True, 1e6), "llama": (24, 8, False, 5e5)}


def _operands(hq, hkv, qk_norm, fill, seed):
    """numpy q [2, Hq, 1, 128], k_new, v_new [2, Hkv, 1, 128], caches
    [2, Hkv, S, 128], lengths (row 0 at ``fill``, row 1 at another), gains."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lengths = np.array([fill, S + 1 - fill], np.int32)
    gains = (0.3 * f(128), 0.3 * f(128)) if qk_norm else (None, None)
    return (f(2, hq, 1, 128), f(2, hkv, 1, 128), f(2, hkv, 1, 128),
            f(2, hkv, S, 128), f(2, hkv, S, 128), lengths, gains)


def _jax_decode(q, k_new, v_new, kc, vc, lengths, gains, base, scale):
    """The JAX package's decode of one token after the projections, as
    its ``transformer._layer_decode`` composes it."""
    positions = (lengths - 1)[:, None]
    if gains[0] is not None:
        q = RL.rms_norm(q, gains[0], unit_offset=True)
        k_new = RL.rms_norm(k_new, gains[1], unit_offset=True)
    q = RL.apply_rope(q, positions, base)
    k_new = RL.apply_rope(k_new, positions, base)
    slot = (lengths - 1) % kc.shape[2]
    b_idx = jnp.arange(kc.shape[0])
    kc = kc.at[b_idx, :, slot, :].set(k_new[:, :, 0, :].astype(kc.dtype))
    vc = vc.at[b_idx, :, slot, :].set(v_new[:, :, 0, :].astype(vc.dtype))
    return JA.decode_attention(q, kc, vc, lengths, scale=scale), kc, vc


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2 ** -8)])
@pytest.mark.parametrize("fill", [1, S // 2, S])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ref_matches_jax_decode(layout, fill, dtype, tol):
    hq, hkv, qk_norm, base = LAYOUTS[layout]
    q, k_new, v_new, kc, vc, lengths, gains = _operands(hq, hkv, qk_norm,
                                                        fill, seed=fill)
    scale = 128 ** -0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    caches = [t(kc), t(vc)]
    got = ref.decode_attention_ref(
        t(q), t(k_new), t(v_new), *caches, torch.from_numpy(lengths),
        scale=scale, rope_base=base,
        q_norm=None if gains[0] is None else torch.from_numpy(gains[0]),
        k_norm=None if gains[1] is None else torch.from_numpy(gains[1]))
    j = lambda x: jnp.asarray(x, jdt)  # noqa: E731
    want, jkc, jvc = _jax_decode(
        j(q), j(k_new), j(v_new), j(kc), j(vc), jnp.asarray(lengths),
        tuple(None if g is None else jnp.asarray(g) for g in gains), base,
        scale)
    for label, g, w in (("o", got, want), ("k_cache", caches[0], jkc),
                        ("v_cache", caches[1], jvc)):
        w = np.asarray(w.astype(jnp.float32))
        scale_w = np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy() / scale_w, w / scale_w,
                                   atol=tol, rtol=0, err_msg=label)
    # the new slot of each row holds the rotated k and the new v
    for row, n in enumerate(lengths):
        assert torch.equal(caches[1][row, :, n - 1], t(v_new)[row, :, 0])


def _cfg(name, **kw):
    base = dict(name=name, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                head_dim=128, d_ff=64, vocab=50, dtype="bfloat16")
    return T.LMConfig(**{**base, **kw})


# (config, layers routed to the wrapper): qwen3-like (qk-norm), llama-like,
# gemma3-like (its global layer takes the kernel, its ring-cache local
# layer the plain path), gemma2-like (Dh 256, softcap), kv replication,
# and float32
ROUTES = {
    "qwen3": (_cfg("qwen3", qk_norm=True, rope_base=1e6), 2),
    "llama": (_cfg("llama", n_heads=6, rope_base=5e5), 2),
    "gemma3": (_cfg("gemma3", pattern=("local", "global"), window=4,
                    qk_norm=True, query_scale=0.1, rope_base_local=1e4), 1),
    "gemma2": (_cfg("gemma2", head_dim=256, attn_softcap=50.0), 0),
    "kv_repeat": (_cfg("kv_repeat", kv_repeat=2), 0),
    "float32": (_cfg("float32", qk_norm=True, dtype="float32"), 0),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_decode_step_routes_designed_layers_to_the_wrapper(name, monkeypatch):
    cfg, routed = ROUTES[name]
    model = T.init(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for lp in model.layers:  # gains other than 1, so the norm shows
            for key in ("q_norm", "k_norm"):
                if cfg.qk_norm:
                    lp.attn[key].normal_(0.0, 0.3, generator=torch.Generator()
                                         .manual_seed(4))
    tokens = torch.tensor([[3, 7, 11, 5, 9, 2]])
    _, caches, lengths = T.prefill(model, tokens, cfg, max_len=12)
    tok, lengths = torch.tensor([[4]]), lengths + 1

    calls = []
    wrapper = ops.decode_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    routed_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    before = dict(ops.counts)
    got, _ = T.decode_step(model, routed_caches, tok, lengths, cfg)
    assert len(calls) == routed, calls
    assert ops.counts["plain"] == before["plain"] + routed
    assert ops.counts["launches"] == before["launches"]

    # the wrapper's plain version gives the plain path's bits
    monkeypatch.setattr(ops, "has_design", lambda *a, **kw: False)
    want, _ = T.decode_step(model, caches, tok, lengths, cfg)
    assert len(calls) == routed
    assert torch.equal(got, want)
    for c, w in zip(routed_caches, caches):
        assert all(torch.equal(c[k], w[k]) for k in c)


def _designed(hq=8, hkv=2, dh=128, s=S, dtype=torch.bfloat16):
    z = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
    return (z(1, hq, 1, dh), z(1, hkv, 1, dh), z(1, hkv, 1, dh),
            z(1, hkv, s, dh), z(1, hkv, s, dh))


@pytest.mark.parametrize("case,kw,want", [
    ("designed", {}, True),
    ("llama 24:8", dict(hq=24, hkv=8), True),
    ("group of 8", dict(hq=32, hkv=4), True),
    ("group of 16", dict(hq=32, hkv=2), False),
    ("Dh 64", dict(dh=64), False),
    ("Dh 256", dict(dh=256), False),
    ("float32", dict(dtype=torch.float32), False),
    ("softcap", {"softcap": 50.0}, False),
    ("window", {"window": 4}, False),
])
def test_has_design(case, kw, want):
    opts = {k: kw.pop(k) for k in ("softcap", "window") if k in kw}
    assert ops.has_design(*_designed(**kw), **opts) is want, case


def test_has_design_refuses_replicated_kv():
    q, k_new, v_new, kc, vc = _designed(hq=8, hkv=2)
    wide = torch.zeros((1, 4, S, 128), dtype=torch.bfloat16)
    assert not ops.has_design(q, k_new, v_new, wide, wide)


@pytest.mark.parametrize("b,hkv,n_slots,n_sm,want", [
    (1, 4, 2056, 132, 33),    # qwen3-moe at the benchmark's cache: 132 CTAs
    (1, 8, 2056, 132, 33),    # llama3.2: 264 CTAs
    (8, 8, 32768, 132, 5),    # llama3.2 decode_32k
    (1, 4, 10, 132, 1),       # a cache shorter than one tile
    (1, 16, 8192, 132, 17),   # gemma3's global layers
])
def test_splits(b, hkv, n_slots, n_sm, want):
    assert ops.splits(b, hkv, n_slots, n_sm) == want


def test_counts_record_and_replay_like_the_other_wrappers():
    """A decode step's bumps under ``counters.recording()`` are the
    shared table's, and ``CapturedStep``'s arithmetic takes the set-up
    passes back out and adds the captured pass at each replay."""
    assert counters._TABLES["decode_attention"][0] is ops.counts
    cfg, routed = ROUTES["qwen3"]
    model = T.init(cfg, torch.Generator().manual_seed(5))
    _, caches, lengths = T.prefill(model, torch.tensor([[1, 2, 3]]), cfg,
                                   max_len=8)
    start = dict(ops.counts)
    with counters.recording() as recs:
        T.decode_step(model, caches, torch.tensor([[6]]), lengths + 1, cfg)
    assert recs == [("decode_attention", "plain")] * routed
    counters.add(counters.tally(recs, times=-1))
    assert ops.counts == start
    for _ in range(3):
        counters.add(counters.tally(recs))
    assert ops.counts["plain"] == start["plain"] + 3 * routed
    assert ops.counts["launches"] == start["launches"]
