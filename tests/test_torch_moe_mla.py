"""The port's MoE layer (`models/moe.py`) and Multi-head Latent Attention
(`models/mla.py`) against the JAX package's, on the CPU.

Weights are the JAX package's own ``init`` (PRNGKey 0), inputs come
from numpy seeds.  MoE: both MoE SMOKE configs (qwen3: renormalised
gates, no shared experts; deepseek: raw gates, two shared experts), at
T = 37, at T = 1 (decode: most experts get no row) and with every token
routed to one expert; the chosen expert ids are equal, the output is
within 1e-5 of its largest magnitude, the aux loss within 1e-6.  MLA:
``apply`` (prefill) and ``decode_absorbed`` against the reference,
output and both compressed caches within 1e-5 of their largest
magnitude.  ``apply`` at FULL's head widths (nope 128, rope 64, v
128; 2 heads, a small d_model) against the reference: in bf16 the
heads reach attention unpadded (the flash kernel's own 192/128
design), in f32 padded to 256, and SMOKE's 24/16 padded to 32; bf16
within 1e-2 of the largest magnitude.  The zero-padded heads against
plain attention over the unpadded 24/16-wide (SMOKE) and 192/128-wide
(FULL) heads.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn
from repro_torch.models import mla, moe

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

MOE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
OUT_TOL, AUX_TOL, MLA_TOL = 1e-5, 1e-6, 1e-5
# MLA prefill in bf16 against the reference in bf16: the two round the
# projections' and attention's products at other places (3e-4 of the
# largest magnitude seen at FULL's heads)
MLA_BF16_TOL = 1e-2
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tree(params):
    """A JAX parameter tree as float32 torch tensors (nested dicts)."""
    return {k: _tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in params.items()}


def _close(got, want, tol, label=""):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=tol, rtol=0, err_msg=label)


def _moe_case(arch):
    rc = ref_configs.ARCHS[arch].smoke_config
    cfg = moe.MoEConfig(**dataclasses.asdict(rc.moe))
    params = ref_moe.init(jax.random.PRNGKey(0), rc.moe, rc.d_model)
    return rc, cfg, params


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,skew", [(37, False), (1, False), (37, True),
                                    (3, True)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_jax(arch, t, skew):
    rc, cfg, params = _moe_case(arch)
    x = np.random.default_rng(t).normal(size=(t, rc.d_model)) \
        .astype(np.float32)
    if skew:  # every token to expert 5 first; most experts get no row
        router = np.asarray(params["router"]).copy()
        router[0, 5] = 8.0
        x[:, 0] = np.abs(x[:, 0]) + 2.0
        params = {**params, "router": jnp.asarray(router)}
    want, want_aux = ref_moe.apply(params, jnp.asarray(x), rc.moe)
    port = _tree(params)
    got, aux = moe.apply(port, torch.from_numpy(x), cfg)
    assert got.shape == (t, rc.d_model) and got.dtype == torch.float32
    _close(got.numpy(), want, OUT_TOL, f"{arch} T={t}")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=AUX_TOL)

    # the experts each token is sent to, in the reference's order
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    want_gates, want_ids = jax.lax.top_k(probs, cfg.top_k)
    _, gates, ids = moe.route(port, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    if cfg.norm_topk:
        want_gates = want_gates / want_gates.sum(-1, keepdims=True)
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               rtol=1e-6, atol=1e-7)
    if skew:
        assert (ids[:, 0] == 5).all()


def test_moe_group_ends_cover_empty_groups():
    sorted_expert = torch.tensor([0, 0, 2, 2, 2, 5, 7])
    ends = moe.group_ends(sorted_expert, 8)
    assert ends.dtype == torch.int32
    assert ends.tolist() == [2, 2, 5, 5, 5, 6, 6, 7]
    counts = torch.bincount(sorted_expert, minlength=8)
    assert ends.tolist() == torch.cumsum(counts, 0).tolist()


def test_moe_grouped_products_equal_a_loop_over_experts():
    """The grouped products against each expert's rows multiplied on
    their own, with groups of 0, 1 and many rows."""
    rng = np.random.default_rng(3)
    e, d, f = 6, 16, 24
    ends = torch.tensor([0, 4, 4, 5, 11, 11], dtype=torch.int32)
    xs = torch.from_numpy(rng.normal(size=(11, d)).astype(np.float32))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.2)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    got = moe.expert_products(xs, ends, *w)
    start = 0
    for g, end in enumerate(ends.tolist()):
        rows = xs[start:end]
        h = torch.nn.functional.silu(rows @ w[0][g]) * (rows @ w[1][g])
        torch.testing.assert_close(got[start:end], h @ w[2][g], rtol=1e-5,
                                   atol=1e-6)
        start = end


def test_moe_init_draws_the_reference_shapes():
    for arch in MOE_ARCHS:
        rc, cfg, params = _moe_case(arch)
        port = moe.init(torch.Generator().manual_seed(0), cfg, rc.d_model)
        want = jax.tree.map(lambda a: a.shape, params)
        got = {k: ({n: tuple(t.shape) for n, t in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in port.items()}
        assert got == want, arch
        assert all(t.dtype == torch.float32 for t in port.values()
                   if isinstance(t, torch.Tensor))


def test_moe_multi_device_forms_are_ported():
    """The token-sharded dispatch (``sharding_ctx``) changes nothing on
    one device, and the expert-parallel form runs on logical expert
    shards of it; token shards on cards of their own raise.  Their
    parity with the JAX package is in ``tests/test_torch_train.py``."""
    from repro_torch.launch.mesh import HostMesh, make_host_mesh

    rc, cfg, params = _moe_case("qwen3-moe-30b-a3b")
    port = {k: torch.tensor(np.asarray(v)) for k, v in params.items()
            if not isinstance(v, dict)}
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(8, rc.d_model)).astype(np.float32))
    want, aux = moe.apply(port, x, cfg)
    mesh = make_host_mesh(2, "cpu")
    assert mesh.shape == {"data": 1, "model": 2}
    with moe.sharding_ctx(mesh, ("data",)):
        got, _ = moe.apply(port, x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got, got_aux = moe.apply_expert_parallel(port, x, cfg, mesh, ("data",),
                                             capacity_factor=16.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert float(got_aux) == float(aux)
    two = HostMesh({"data": 2, "model": 2}, (torch.device("cpu"),) * 4)
    with pytest.raises(ValueError, match="multi-card host mesh"):
        moe.apply_expert_parallel(port, x, cfg, two, ("data",))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_case():
    rc = ref_configs.ARCHS["deepseek-v2-lite-16b"].smoke_config
    cfg = mla.MLAConfig(**dataclasses.asdict(rc.mla))
    params = ref_mla.init(jax.random.PRNGKey(1), rc.mla, rc.d_model,
                          rc.n_heads)
    return rc, cfg, params


@pytest.mark.parametrize("backend", ["kernel", "blockwise"])
def test_mla_apply_matches_jax(backend):
    """Prefill: output and both compressed caches.  On the CPU the
    ``kernel`` backend runs the kernel wrapper's plain version over the
    padded heads, the ``blockwise`` one the online-softmax loop."""
    rc, cfg, params = _mla_case()
    b, l = 2, 29
    x = np.random.default_rng(5).normal(size=(b, l, rc.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(l), (b, l)).astype(np.int32)
    want, (want_c, want_kr) = ref_mla.apply(
        params, jnp.asarray(x), rc.mla, rc.n_heads, jnp.asarray(pos),
        rc.rope_base)
    fa_ops.reset_counts()
    got, (c_kv, k_rope) = mla.apply(
        _tree(params), torch.from_numpy(x), cfg, rc.n_heads,
        torch.from_numpy(pos).long(), rc.rope_base, backend=backend)
    assert fa_ops.counts["plain"] == (backend == "kernel")
    assert got.shape == (b, l, rc.d_model)
    assert c_kv.shape == (b, l, cfg.kv_lora_rank)
    assert k_rope.shape == (b, 1, l, cfg.rope_head_dim)
    _close(got.numpy(), want, MLA_TOL, "out")
    _close(c_kv.numpy(), want_c, MLA_TOL, "c_kv")
    _close(k_rope.numpy(), want_kr, MLA_TOL, "k_rope")


@pytest.mark.parametrize("backend", ["kernel", "blockwise"])
@pytest.mark.parametrize("widths,dtype,seen", [
    ((128, 64, 128), "bfloat16", (192, 128)),  # FULL: the kernel's design
    ((128, 64, 128), "float32", (256, 256)),   # f32 has none: padded
    ((16, 8, 16), "bfloat16", (32, 32)),       # SMOKE's 24/16: padded
])
def test_mla_apply_head_route_matches_jax(widths, dtype, seen, backend,
                                          monkeypatch):
    """Prefill at the given (nope, rope, v) widths, 2 heads, d_model 64,
    against the reference's unpadded ``apply``; a spy on
    ``attn.attention`` records the (q/k, v) widths attention was given:
    no padding reaches it where the kernel has a design."""
    nope, rope, dv = widths
    rcfg = ref_mla.MLAConfig(kv_lora_rank=32, rope_head_dim=rope,
                             nope_head_dim=nope, v_head_dim=dv)
    cfg = mla.MLAConfig(**dataclasses.asdict(rcfg))
    d_model, h, b, l = 64, 2, 2, 70
    params = ref_mla.init(jax.random.PRNGKey(2), rcfg, d_model, h)
    x = np.random.default_rng(7).normal(size=(b, l, d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(l), (b, l)).astype(np.int32)
    tdt, jdt, tol = {"float32": (torch.float32, jnp.float32, MLA_TOL),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16,
                                  MLA_BF16_TOL)}[dtype]
    want, (want_c, _) = ref_mla.apply(
        params, jnp.asarray(x, jdt), rcfg, h, jnp.asarray(pos), 10_000.0)
    given = []
    real = attn.attention

    def spy(q, k, v, **kw):
        given.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn, "attention", spy)
    fa_ops.reset_counts()
    got, (c_kv, _) = mla.apply(
        _tree(params), torch.from_numpy(x).to(tdt), cfg, h,
        torch.from_numpy(pos).long(), 10_000.0, backend=backend)
    assert given == [(seen[0], seen[0], seen[1])]
    assert fa_ops.counts["plain"] == (backend == "kernel")
    assert got.shape == (b, l, d_model) and got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want, np.float32), tol, "out")
    _close(c_kv.float().numpy(), np.asarray(want_c, np.float32), tol, "c_kv")


def test_mla_decode_absorbed_matches_jax():
    """Two decode steps over a cache filled by prefill, the rows at
    different lengths: output and both caches after each step."""
    rc, cfg, params = _mla_case()
    b, s = 2, 24
    rng = np.random.default_rng(6)
    c_cache = rng.normal(size=(b, s, cfg.kv_lora_rank)).astype(np.float32)
    kr_cache = rng.normal(size=(b, 1, s, cfg.rope_head_dim)) \
        .astype(np.float32)
    lengths = np.array([9, 17], np.int32)
    ref_c, ref_kr = jnp.asarray(c_cache), jnp.asarray(kr_cache)
    port = _tree(params)
    got_c, got_kr = torch.tensor(c_cache), torch.tensor(kr_cache)
    for step in range(2):
        lengths = lengths + 1
        x = rng.normal(size=(b, 1, rc.d_model)).astype(np.float32)
        pos = (lengths - 1)[:, None]
        want, (ref_c, ref_kr) = ref_mla.decode_absorbed(
            params, jnp.asarray(x), rc.mla, rc.n_heads, ref_c, ref_kr,
            jnp.asarray(lengths), jnp.asarray(pos), rc.rope_base)
        got, (out_c, out_kr) = mla.decode_absorbed(
            port, torch.from_numpy(x), cfg, rc.n_heads, got_c, got_kr,
            torch.from_numpy(lengths), torch.from_numpy(pos).long(),
            rc.rope_base)
        assert out_c is got_c and out_kr is got_kr  # written in place
        _close(got.numpy(), want, MLA_TOL, f"step {step} out")
        _close(got_c.numpy(), ref_c, MLA_TOL, f"step {step} c_kv")
        _close(got_kr.numpy(), ref_kr, MLA_TOL, f"step {step} k_rope")


def _plain_attention(q, k, v, scale):
    """Causal softmax attention over unpadded heads (q/k and v may
    differ in width), in float64."""
    q, k, v = (t.to(torch.float64) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    l = s.shape[-1]
    causal = torch.ones(l, l, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("backend", ["kernel", "blockwise"])
@pytest.mark.parametrize("qk,dv", [(24, 16), (192, 128)])
def test_padded_heads_equal_unpadded_attention(qk, dv, backend):
    cfg = mla.MLAConfig(nope_head_dim=qk - qk // 3, rope_head_dim=qk // 3,
                        v_head_dim=dv, kv_lora_rank=32)
    head = mla.padded_head_dim(cfg, torch.float32)
    assert head == {24: 32, 192: 256}[qk] and head in fa_ops.HEAD_DIMS
    # in bf16 FULL's heads have a design of their own; SMOKE's do not
    assert mla.padded_head_dim(cfg, torch.bfloat16) == {24: 32,
                                                        192: None}[qk]
    rng = np.random.default_rng(qk)
    b, h, l = 1, 3, 40
    q, k = (torch.from_numpy(rng.normal(size=(b, h, l, qk))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, h, l, dv)).astype(np.float32))
    got = mla.padded_attention(q, k, v, scale=cfg.scale, head_dim=head,
                               backend=backend)
    assert got.shape == (b, h, l, dv)
    want = _plain_attention(q, k, v, cfg.scale)
    _close(got.numpy(), want.numpy(), 1e-5, f"{qk}/{dv} {backend}")
    # without the padding the blockwise path computes the same
    unpadded = attn.flash_attention_blockwise(q, k, v, scale=cfg.scale)
    _close(unpadded.numpy(), want.numpy(), 1e-5, "unpadded blockwise")


def test_moe_and_mla_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "import repro_torch.configs.qwen3_moe_30b_a3b\n"
        "import repro_torch.configs.deepseek_v2_lite_16b\n"
        "import repro_torch.configs.gemma2_9b, repro_torch.configs.ragdb\n"
        "import repro_torch.configs.gemma3_27b\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
