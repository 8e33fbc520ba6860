#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from ``src/repro_torch/csrc/`` (one ``nvcc`` per source,
   all at once).
2. Kernels against their plain versions, on the card: the fused HSF
   top-k at the serving shape (N=65,536 docs, D=4,096, W=128 signature
   words, B=64 queries, k=16) and at its edges (ragged N, n_valid < N,
   k=128, k > n_valid, B=1, duplicated doc rows); then flash attention
   at the serving shape (B=1, Hq=24, Hkv=8, L=512, Dh=128, bf16, causal,
   strided operands as the projections give them) and at its edges
   (ragged L, GQA 8:1 at Dh=32 in f32, window + softcap at Dh=256,
   non-causal, q_offset with Lq < Lk, kv_len < Lk, fully masked rows,
   the SMOKE heads of 16 in bf16 and f32, Dh=256 in f32); then the
   single-query HSF score at the serving shape in f32 and bf16 and at
   its edges (ragged N, D without 16-byte rows, W=3, n = 0, the boost
   exactly β); then the streaming top-k at N=65,536 and 16,777,216 with
   k = 1, 16, 128, small N with k = N, duplicate-heavy and -inf-laden
   scores (ids and values exactly equal).
3. Main path: a 65,536-doc synthetic corpus with 64 entity codes,
   served through ``repro_torch.launch.serve.main`` (ingest → container
   save → micro-batched serving → generation with llama3.2-3b at full
   width in bf16, random weights from seed 0), then served again from
   the reloaded container with tracing on (its span breakdown is
   printed).  Recall@1 must be 1.0 on the entity queries, every request
   must generate, the reloaded run must give the same ids, scores and
   token ids, the HSF kernel's launches must equal the scoring
   dispatches, flash launches must be 28 per prefill with no plain
   call, and the map path must give the same bits on the card and on
   the CPU.
4. Timings of the HSF kernels and the top-k at their serving shapes
   (top-k also at 16,777,216 scores): kernel, plain version, the
   library yardstick, and the bound.
5. Full-width cross-check: last-position prefill logits of llama3.2-3b
   (the served weights) for four prompts through the flash kernel and
   through the plain blockwise path.
6. Timings of flash attention at the serving shape and at a long prompt
   (L=8,192): kernel, plain version, the library yardstick
   (``scaled_dot_product_attention``), each as device time of calls
   queued back to back, and the bound; then prefill and decode at full
   width, with a profiler breakdown of one prefill and one decode step.
7. The IVF index plane on phase 3's container: ``serve.main --index ivf
   --guarantee exact`` must give phase 3's ids, scores and token ids,
   with HSF launches = scoring dispatches; exact mode one query per
   dispatch must equal the flat kernel path bit for bit (some widen
   round reranking a proper subset), with k-means timed on the card;
   probe mode at nprobe 1 and 8 (entity Recall@1 ≥ 0.9, Recall@16 vs
   flat, probed fraction, span medians, time per query); the trained
   state saved, reloaded and adopted with no retrain; the postings
   prefilter; and the single-query path — ``hsf_scores_kernel`` then
   ``top_k`` per query — whose launches the ``kernels`` line reports.

The second line from the end is a JSON ``kernels`` record; the last is
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# serving shape: configs/ragdb.py FULL, one device's shard of the pod
N_DOCS, DIM, SIG_WORDS, BATCH, TOP_K = 65_536, 4_096, 128, 64, 16
N_ENTITIES = 64
ALPHA, BETA = 1.0, 1.0
TOPK_LONG_N = 16_777_216  # a score stream larger than the 50 MB L2
SCORE_ATOL = 1e-5
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# generation leg: configs/llama3_2_3b.py FULL (28 layers; attention
# B=1, Hq=24, Hkv=8, Dh=128 at the 512-token context window)
ARCH = "llama3.2-3b"
N_LAYERS = 28
MAX_NEW_TOKENS = 8
ATTN_SERVE = dict(b=1, hq=24, hkv=8, l=512, dh=128)
ATTN_LONG_L = 8_192
# kernel vs plain: f32 differs by summation order; bf16 by the rounding
# of p and of the output to bf16 (a few ulps of values below 4)
F32_TOL, BF16_TOL = 2e-4, 5e-2
# full-width logits, kernel vs blockwise, both bf16 over 28 layers
LOGIT_REL_TOL = 2e-2


def _log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def _make_operands(torch, gen, n, d, w, b, dup_rows=0):
    """Unit-norm doc and query rows, full-range int32 signatures (sign
    bit set on half the words), query signatures that are the AND of
    two doc signatures (so containment fires on some docs)."""
    dev = "cuda"
    dv = torch.randn(n, d, device=dev, generator=gen)
    if dup_rows:
        dv = dv[torch.arange(n, device=dev) % dup_rows]
    dv = dv / dv.norm(dim=1, keepdim=True)
    ds = torch.randint(-2**31, 2**31, (n, w), device=dev, generator=gen,
                       dtype=torch.int64).to(torch.int32)
    if dup_rows:
        ds = ds[torch.arange(n, device=dev) % dup_rows]
    qv = torch.randn(b, d, device=dev, generator=gen)
    qv = qv / qv.norm(dim=1, keepdim=True)
    rows = torch.randint(0, n, (b,), device=dev, generator=gen)
    qs = ds[rows] & ds[(rows + 1) % n]
    return dv.contiguous(), ds.contiguous(), qv.contiguous(), qs.contiguous()


def _check_against_plain(np, kv, ki, pv, pi, sentinel, label):
    """Kernel (kv, ki) against the plain version's extended top list
    (pv, pi; k + extra columns).  Scores within SCORE_ATOL; ids equal,
    except among candidates whose plain scores lie within SCORE_ATOL of
    each other, where the kernel's id must be one of that near-tie
    group's; unfilled slots (-inf) carry the sentinel; no real id twice.
    Returns the largest score difference."""
    b, k = kv.shape
    assert ki.shape == (b, k), (label, ki.shape)
    worst = 0.0
    for row in range(b):
        real = ki[row][ki[row] != sentinel]
        assert len(set(real.tolist())) == len(real), (label, row, "dup id")
        for p in range(k):
            want_v, got_v, got_i = pv[row, p], kv[row, p], ki[row, p]
            if np.isneginf(want_v):
                assert np.isneginf(got_v) and got_i == sentinel, \
                    (label, row, p, got_v, got_i)
                continue
            diff = abs(float(got_v) - float(want_v))
            worst = max(worst, diff)
            assert diff <= SCORE_ATOL, (label, row, p, got_v, want_v)
            if got_i != pi[row, p]:
                near = pi[row][np.abs(pv[row] - want_v) <= SCORE_ATOL]
                assert got_i in near, (label, row, p, got_i, pi[row, p])
    return worst


def phase_kernel(torch, np, ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # name, n, b, k, n_valid, dup_rows
        ("serving shape", N_DOCS, BATCH, TOP_K, None, 0),
        ("ragged N", 20_011, BATCH, TOP_K, None, 0),
        ("n_valid < N", 20_011, BATCH, TOP_K, 12_345, 0),
        ("k = 128", 20_011, BATCH, 128, None, 0),
        ("k > n_valid (sentinels)", 20_011, BATCH, TOP_K, 7, 0),
        ("B = 1", N_DOCS, 1, TOP_K, None, 0),
        ("duplicated doc rows", 20_011, BATCH, TOP_K, None, 97),
    ]
    worst = 0.0
    for name, n, b, k, n_valid, dup in cases:
        dv, ds, qv, qs = _make_operands(torch, gen, n, DIM, SIG_WORDS, b,
                                        dup_rows=dup)
        kv, ki = ops.hsf_score_batched(dv, ds, qv, qs, k=k, alpha=ALPHA,
                                       beta=BETA, n_valid=n_valid)
        torch.cuda.synchronize()
        # plain list long enough to hold every near-tie of the top k
        # (all copies of a row in the duplicated case)
        extra = n if dup else min(n, k + 32)
        pv, pi = ref.hsf_score_topk_ref(dv, ds, qv, qs, ALPHA, BETA, extra,
                                        n_valid=n_valid)
        kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
        pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
        err = _check_against_plain(np, kv, ki, pv, pi, ops.ID_SENTINEL, name)
        if dup:
            # exact ties: the kernel scores every copy of a row with the
            # same bits, so its top k (one row's copies, 206 > k of
            # them) must be that row's lowest copy ids, ascending
            for row in range(b):
                run = ki[row][kv[row] == kv[row, 0]]
                want = np.arange(int(run[0]) % dup, n, dup)[:k]
                assert len(run) == k and np.array_equal(run, want), \
                    (name, row, ki[row])
        if n_valid is not None and n_valid < k:
            assert np.all(ki[:, n_valid:] == ops.ID_SENTINEL), name
        worst = max(worst, err)
        _log(f"  kernel == plain: {name:26s} N={n} B={b} k={k} "
             f"n_valid={n_valid} max |Δscore| {err:.3e}")
        del dv, ds, qv, qs
    return worst


def phase_hsf_score_kernel(torch, np, ops, ref):
    """Single-query HSF kernel against its plain version: the serving
    shape in f32 and bf16, ragged N, D without 16-byte rows (scalar
    loads), a short signature, n = 0 and the boost exactly β.  Returns
    the largest |Δ| over the cases."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    alpha, beta = 0.9, 1.3  # the JAX sweep's weights
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, n, d, w, dtype
        ("serving shape", N_DOCS, DIM, SIG_WORDS, f32),
        ("serving shape bf16", N_DOCS, DIM, SIG_WORDS, bf16),
        ("ragged N=1", 1, DIM, SIG_WORDS, f32),
        ("ragged N=7", 7, DIM, SIG_WORDS, f32),
        ("ragged N=9", 9, DIM, SIG_WORDS, bf16),
        ("ragged N=100", 100, DIM, SIG_WORDS, f32),
        ("D=1001 (scalar loads)", 3_001, 1_001, SIG_WORDS, f32),
        ("D=1001 bf16 (scalar loads)", 3_001, 1_001, SIG_WORDS, bf16),
        ("W=3", 5_000, 256, 3, f32),
    ]
    worst = 0.0
    for name, n, d, w, dtype in cases:
        dv, ds, qv, qs = _make_operands(torch, gen, n, d, w, 1)
        dv, qv, qs = dv.to(dtype), qv[0].to(dtype), qs[0].contiguous()
        got = ops.hsf_score(dv, ds, qv, qs, alpha=alpha, beta=beta)
        torch.cuda.synchronize()
        want = ref.hsf_score_ref(dv, ds, qv, qs, alpha, beta)
        tol = 1e-5 if dtype == f32 else 3e-2
        assert got.shape == (n,) and got.dtype == f32, name
        # within tol, and β = 1.3 apart, so the boost decisions agree too
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=name)
        boosted = ref.containment_matrix(ds, qs[None, :])[0] > 0
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        _log(f"  hsf_score == plain: {name:28s} N={n} D={d} W={w} "
             f"{str(dtype)[6:]:8s} max |Δ| {err:.3e} (tol {tol:g}); "
             f"{int(boosted.sum())} boosted")
        del dv, ds, qv, qs, got, want
    # boost exactness: zero vectors, the query signature of doc 7
    n, d, w = 32, 128, 128
    ds = torch.randint(-2**31, 2**31, (n, w), device="cuda", generator=gen,
                       dtype=torch.int64).to(torch.int32)
    out = ops.hsf_score(torch.zeros((n, d), device="cuda"), ds,
                        torch.zeros((d,), device="cuda"), ds[7].contiguous(),
                        alpha=1.0, beta=1.0)
    assert out[7].item() == 1.0, out[7].item()
    before = ops.single_counts["launches"]
    empty = ops.hsf_score(torch.zeros((0, d), device="cuda"),
                          torch.zeros((0, w), dtype=torch.int32, device="cuda"),
                          torch.zeros((d,), device="cuda"),
                          torch.zeros((w,), dtype=torch.int32, device="cuda"))
    assert empty.shape == (0,) and empty.dtype == f32
    assert ops.single_counts["launches"] == before, "n = 0 launched"
    _log("  hsf_score: the boost is exactly β; n = 0 gives an empty vector "
         "with no launch")
    return worst


def phase_topk_kernel(torch, np, tk_ops, tk_ref):
    """Streaming top-k kernel against its plain version: ids and values
    exactly equal, over random, duplicate-heavy and -inf-laden vectors at
    N = 65,536 and 16,777,216 and small N with k = N."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    ninf = float("-inf")

    def normal(n):
        return torch.randn(n, device="cuda", generator=gen)

    def dups(n):  # five distinct values: ties everywhere
        return torch.randint(0, 5, (n,), device="cuda",
                             generator=gen).to(torch.float32)

    def sparse(n, finite):  # mostly -inf, fewer finite entries than k
        s = torch.full((n,), ninf, device="cuda")
        at = torch.randperm(n, device="cuda", generator=gen)[:finite]
        s[at] = dups(finite)
        return s

    cases = []
    for n in (N_DOCS, TOPK_LONG_N):
        for k in (1, 16, 128):
            cases.append((f"normal N={n}", normal(n), k))
        cases.append((f"duplicates N={n}", dups(n), 128))
        cases.append((f"40 finite, rest -inf N={n}", sparse(n, 40), 128))
    for n in (1, 5, 100, 128):
        cases.append((f"k = N = {n}", normal(n), n))
    cases.append(("[1, -inf, 2, -inf, 1]", torch.tensor(
        [1.0, ninf, 2.0, ninf, 1.0], device="cuda"), 5))
    cases.append(("all -inf", torch.full((3000,), ninf, device="cuda"), 7))
    for name, scores, k in cases:
        kv, ki = tk_ops.top_k(scores, k)
        torch.cuda.synchronize()
        pv, pi = tk_ref.top_k_ref(scores, k)
        assert kv.shape == (k,) and ki.dtype == torch.int32, name
        assert torch.equal(ki, pi), (name, ki[:8].tolist(), pi[:8].tolist())
        assert torch.equal(kv, pv), (name, kv[:8].tolist(), pv[:8].tolist())
        _log(f"  top_k == plain: {name:32s} k={k:3d} ids and values equal")
    return 0.0


def _attn_operands(torch, gen, b, hq, hkv, lq, lk, dh, dtype,
                   strided=False):
    """q, k, v from the standard normal; ``strided`` makes them the
    [B, L, H, Dh] → [B, H, L, Dh] transposed views the projections
    give the kernel."""
    def one(h, l):
        if strided:
            t = torch.randn(b, l, h, dh, device="cuda", generator=gen)
            return t.to(dtype).transpose(1, 2)
        return torch.randn(b, h, l, dh, device="cuda", generator=gen) \
            .to(dtype)
    return one(hq, lq), one(hkv, lk), one(hkv, lk)


def phase_flash_kernel(torch, fa_ops, fa_ref):
    """Flash kernel against its plain version; returns the largest
    |Δ| over the cases."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    sv = ATTN_SERVE
    cases = [
        # name, (b, hq, hkv, lq, lk, dh), dtype, strided, options
        ("serving shape", (sv["b"], sv["hq"], sv["hkv"], sv["l"], sv["l"],
                           sv["dh"]), bf16, True, {}),
        ("ragged L=517", (1, 24, 8, 517, 517, 128), bf16, True, {}),
        ("Hq=8 Hkv=1 Dh=32 f32", (2, 8, 1, 300, 300, 32), f32, False, {}),
        ("window 32 softcap 50 Dh=256", (1, 16, 8, 333, 333, 256), bf16,
         True, {"window": 32, "softcap": 50.0}),
        ("non-causal", (2, 4, 2, 200, 200, 64), bf16, False,
         {"causal": False}),
        ("q_offset=512 Lq=100 < Lk=612", (1, 24, 8, 100, 612, 128), bf16,
         False, {"q_offset": 512}),
        ("kv_len=590 < Lk=612 f32", (1, 8, 4, 100, 612, 64), f32, False,
         {"q_offset": 512, "kv_len": 590}),
        ("fully masked rows (q_offset=-40)", (1, 4, 2, 128, 128, 64), bf16,
         False, {"q_offset": -40}),
        # the SMOKE configs' heads (Dh=16, window 16) in both types, and
        # the widest head in f32
        ("Dh=16 window 16 softcap 30", (2, 4, 2, 77, 77, 16), bf16, True,
         {"window": 16, "softcap": 30.0}),
        ("Dh=16 window 16 softcap 30 f32", (2, 4, 2, 77, 77, 16), f32, True,
         {"window": 16, "softcap": 30.0}),
        ("Dh=256 f32", (1, 4, 2, 150, 150, 256), f32, True, {}),
    ]
    worst = 0.0
    for name, (b, hq, hkv, lq, lk, dh), dtype, strided, opts in cases:
        q, k, v = _attn_operands(torch, gen, b, hq, hkv, lq, lk, dh, dtype,
                                 strided)
        kw = {"scale": dh ** -0.5, "causal": True, **opts}
        got = fa_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa_ref.attention_ref(q, k, v, **kw)
        tol = F32_TOL if dtype == f32 else BF16_TOL
        assert got.shape == want.shape and got.dtype == dtype, name
        assert torch.isfinite(got).all(), name
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=name)
        q_off = opts.get("q_offset", 0)
        if q_off < 0:  # rows before position 0 see no key: exactly 0
            dead = got[:, :, :-q_off]
            assert dead.numel() and not dead.any(), name
        worst = max(worst, err)
        _log(f"  flash == plain: {name:34s} {str(dtype)[6:]:8s} "
             f"max |Δ| {err:.3e} (tol {tol:g})")
        del q, k, v, got, want
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

_RESULT = re.compile(r"^  ([* ]) (\S+)\s+score=(\S+)$")


_TOKENS = "  generated token ids: "


def _parse_serve(out: str):
    """{query: [(doc_id, boosted, score_text), ...]}, {query: token ids},
    the flush count and the metrics line from the driver's output."""
    results, tokens, cur = {}, {}, None
    for line in out.splitlines():
        if line.startswith("Q: "):
            cur = line[3:].rsplit("  [generation", 1)[0]
            results[cur] = []
        elif cur is not None and (m := _RESULT.match(line)):
            results[cur].append((m.group(2), m.group(1) == "*", m.group(3)))
        elif cur is not None and line.startswith(_TOKENS):
            tokens[cur] = json.loads(line[len(_TOKENS):])
    metrics = next(line for line in out.splitlines()
                   if line.startswith("serving metrics:"))
    flushes = int(re.search(r"(\d+) flushes", metrics).group(1))
    return results, tokens, flushes, metrics


def _serve(serve, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    assert rc == 0, rc
    out = buf.getvalue()
    results, tokens, flushes, metrics = _parse_serve(out)
    lines = out.splitlines()
    # the head (ingest, generator, path), the generation and metrics
    # lines, and the span breakdown table when the run was traced
    gen_line = next(line for line in lines if line.startswith("generation:"))
    extra = [line for line in lines if line.startswith("index stats:")]
    trace_at = next((i for i, line in enumerate(lines)
                     if line.startswith("trace: ")), len(lines))
    for line in lines[:5] + [gen_line, metrics] + extra + lines[trace_at:]:
        _log(f"    | {line}")
    _log(f"    ({time.perf_counter() - t0:.1f} s)")
    return results, tokens, flushes


def phase_main_path(torch, ops, fa_ops, tmp):
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.data.corpus import make_corpus, write_corpus_dir
    from repro_torch.launch import serve
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import results_equal

    t0 = time.perf_counter()
    docs, entities = make_corpus(n_docs=N_DOCS, n_entities=N_ENTITIES, seed=0)
    corpus = str(Path(tmp) / "corpus")
    write_corpus_dir(corpus, docs)
    del docs
    _log(f"  corpus: {N_DOCS} docs, {len(entities)} entity codes "
         f"({time.perf_counter() - t0:.1f} s)")
    words = ["invoice", "server", "latency", "budget", "replication",
             "audit", "schema", "revenue"]
    plain_queries = [f"{a} {b} report {i}" for i, (a, b) in enumerate(
        (a, b) for a in words for b in words)][:N_ENTITIES]
    queries = list(entities) + plain_queries
    container = str(Path(tmp) / "kb.ragdb")
    common = ["--top-k", str(TOP_K), "--max-batch", str(BATCH),
              "--arch", ARCH, "--max-new-tokens", str(MAX_NEW_TOKENS),
              "--queries", *queries]

    # the counts are zeroed just before the main path and read just after
    ops.reset_counts()
    fa_ops.reset_counts()
    _log("  serve: ingest + save + serve + generate")
    first, tokens_1, flushes_1 = _serve(serve, [
        "--corpus", corpus, "--dim", str(DIM), "--save", container, *common])
    _log("  serve: reload the saved container + serve + generate (traced)")
    second, tokens_2, flushes_2 = _serve(serve, [
        "--container", container,
        "--trace", str(Path(tmp) / "trace.json"), *common])
    obs_trace.disable()
    launches = ops.counts["launches"]
    fa_launches, fa_plain = fa_ops.counts["launches"], fa_ops.counts["plain"]
    dispatches = flushes_1 + flushes_2
    assert ops.counts["unfused"] == 0, ops.counts
    assert launches == dispatches and launches > 0, (launches, dispatches)
    # every request generated, the same tokens both times, and every
    # prefill layer went through the kernel (no plain call at all)
    for tokens in (tokens_1, tokens_2):
        assert sorted(tokens) == sorted(queries), len(tokens)
        assert all(len(t) == MAX_NEW_TOKENS for t in tokens.values())
    assert tokens_1 == tokens_2, "the reloaded container generated other tokens"
    prefills = len(tokens_1) + len(tokens_2)
    assert fa_plain == 0, fa_ops.counts
    assert fa_launches == N_LAYERS * prefills > 0, (fa_launches, prefills)
    _log(f"  generation: {prefills} prefills, flash launches {fa_launches} "
         f"(= {N_LAYERS} layers × {prefills}), plain calls {fa_plain}; the "
         "reloaded run generated the same token ids")

    # the entity doc must rank first and carry the boost.  Its score is
    # 1 + cosine, and the cosine of a one-token query can come out
    # negative when another word of the doc hashes to the same slot
    # with the opposite sign, so score > 1 is counted, not required
    hits = above_one = 0
    for code, doc_idx in entities.items():
        top = first[code][0]
        assert top[0] == f"doc_{doc_idx:05d}.txt" and top[1], (code, top)
        hits += 1
        above_one += float(top[2]) > 1.0
    recall = hits / len(entities)
    assert recall == 1.0
    _log(f"  entity top hits boosted: {hits}/{len(entities)}, with score "
         f"> 1: {above_one}/{len(entities)}")
    assert all(len(first[q]) == TOP_K for q in queries)
    assert first == second, "the reloaded container served other results"
    _log(f"  Recall@1 {recall:.3f} on {len(entities)} entity queries; "
         f"kernel launches {launches} over {dispatches} scoring "
         f"dispatches ({launches / dispatches:.2f} per dispatch); "
         "container round trip serves the same ids, scores and tokens")

    # map path: the same bits on the card and on the CPU
    kb = KnowledgeBase.load(container)
    probe = queries[:2] + plain_queries[:2]
    on_card = QueryEngine(kb, device="cuda", scoring_path="map")
    on_host = QueryEngine(kb, device="cpu", scoring_path="map")
    a = on_card.query_batch(probe, k=TOP_K)
    b = on_host.query_batch(probe, k=TOP_K)
    for q, ra, rb in zip(probe, a, b):
        assert results_equal(ra, rb), (q, ra[:2], rb[:2])
    assert all(math.isfinite(r.score) for row in a for r in row)
    _log(f"  map path: {len(probe)} queries bit-identical on "
         f"{on_card.device} and {on_host.device} (ids, scores, cosines, "
         "boost flags)")
    ctx = {"container": container, "queries": queries, "entities": entities,
           "flat": first, "tokens": tokens_1, "common": common}
    return launches, fa_launches, ctx


# ---------------------------------------------------------------------------
# phase 4: timings at the serving shape
# ---------------------------------------------------------------------------

def _median_ms(torch, fn, runs):
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_timings(torch, ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(1)
    dv, ds, qv, qs = _make_operands(torch, gen, N_DOCS, DIM, SIG_WORDS, BATCH)
    kernel = lambda: ops.hsf_score_batched(  # noqa: E731
        dv, ds, qv, qs, k=TOP_K, alpha=ALPHA, beta=BETA)
    plain = lambda: ref.hsf_score_topk_ref(  # noqa: E731
        dv, ds, qv, qs, ALPHA, BETA, TOP_K)
    ind = ref.containment_matrix(ds, qs)
    library = lambda: torch.topk(  # noqa: E731
        ALPHA * (qv @ dv.T) + BETA * ind, TOP_K)
    for fn in (kernel, plain, library):  # warm up
        fn()
    torch.cuda.synchronize()
    kernel_ms = _median_ms(torch, kernel, 30)
    plain_ms = _median_ms(torch, plain, 10)
    library_ms = _median_ms(torch, library, 30)
    kernel_ms_2 = _median_ms(torch, kernel, 30)
    n, d = dv.shape
    w = ds.shape[1]
    nbytes = 4 * (n * d + n * w + BATCH * d + BATCH * w) + 8 * BATCH * TOP_K
    flops = 2 * BATCH * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _log(f"  kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f} ms), plain "
         f"{plain_ms:.4f} ms, library torch.topk(α·q@docsᵀ+β·ind) "
         f"{library_ms:.4f} ms (containment precomputed)")
    _log(f"  bound {bound_ms:.4f} ms = max({nbytes / 1e9:.3f} GB / 3.35 TB/s "
         f"= {bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP / 67 TFLOP/s = "
         f"{ops_ms:.4f} ms); kernel at {bound_ms / kernel_ms:.1%} of it")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_new_kernel_timings(torch, ops, ref, tk_ops, tk_ref):
    """Single-query HSF at the serving shape (f32) and top-k of a
    65,536-score vector at k = 16 (the single-query path's shapes), and
    top-k of a 16,777,216-score vector: kernel, plain version, library
    yardstick and bound, as device time of calls queued behind a spin
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    dv, ds, qv, qs = _make_operands(torch, gen, N_DOCS, DIM, SIG_WORDS, 1)
    qv, qs = qv[0].contiguous(), qs[0].contiguous()
    kernel = lambda: ops.hsf_score(dv, ds, qv, qs, alpha=ALPHA, beta=BETA)  # noqa: E731
    plain = lambda: ref.hsf_score_ref(dv, ds, qv, qs, ALPHA, BETA)  # noqa: E731
    library = lambda: ALPHA * torch.mv(dv, qv) + BETA * (  # noqa: E731
        (ds & qs) == qs).all(dim=1)
    for fn in (kernel, plain, library):  # warm up
        fn()
    torch.cuda.synchronize()
    score = {"ms": _queued_ms(torch, kernel, 20, 10),
             "plain_ms": _queued_ms(torch, plain, 5, 5),
             "library_ms": _queued_ms(torch, library, 20, 10)}
    again = _queued_ms(torch, kernel, 20, 10)
    n, d, w = N_DOCS, DIM, SIG_WORDS
    nbytes = 4 * (n * d + n * w + d + w + n)
    flops = 2 * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    score.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    _log(f"  hsf_score N={n} D={d} W={w} f32: kernel {score['ms']:.4f} ms "
         f"(again {again:.4f} ms), plain {score['plain_ms']:.4f} ms, library "
         f"α·torch.mv + β·all((sig & q) == q) {score['library_ms']:.4f} ms; "
         f"bound {score['bound_ms']:.4f} ms = max({nbytes / 1e6:.1f} MB / "
         f"3.35 TB/s, {flops / 1e9:.2f} GFLOP / 67 TFLOP/s) by "
         f"{score['bound_by']}; kernel at {score['bound_ms'] / score['ms']:.1%}"
         f" of it, {nbytes / score['ms'] / 1e9:.2f} TB/s")
    del dv, ds
    out = {"score": score}
    for n, k, reps in ((N_DOCS, TOP_K, 50), (TOPK_LONG_N, TOP_K, 10),
                       (TOPK_LONG_N, 128, 5)):
        scores = torch.randn(n, device="cuda", generator=gen)
        kernel = lambda: tk_ops.top_k(scores, k)  # noqa: E731
        plain = lambda: tk_ref.top_k_ref(scores, k)  # noqa: E731
        library = lambda: torch.topk(scores, k)  # noqa: E731
        for fn in (kernel, plain, library):
            fn()
        torch.cuda.synchronize()
        t = {"ms": _queued_ms(torch, kernel, reps, 10),
             "plain_ms": _queued_ms(torch, plain, 2, 5),
             "library_ms": _queued_ms(torch, library, reps, 10)}
        again = _queued_ms(torch, kernel, reps, 10)
        nbytes = 4 * n + 8 * k
        t.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        _log(f"  top_k N={n} k={k}: kernel {t['ms']:.4f} ms (again "
             f"{again:.4f} ms), plain (stable sort) {t['plain_ms']:.4f} ms, "
             f"library torch.topk {t['library_ms']:.4f} ms; bound "
             f"{t['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB / 3.35 TB/s); "
             f"kernel at {t['bound_ms'] / t['ms']:.1%} of it")
        out[(n, k)] = t
        del scores
    return out


# ---------------------------------------------------------------------------
# phase 5: full-width cross-check, kernel against the blockwise path
# ---------------------------------------------------------------------------

def _served_model(torch, T, cfg):
    """The weights ``serve.py`` serves on the card (seed 0)."""
    return T.init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")


def phase_cross_check(torch, T, model, cfg):
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for length in (512, 389, 128, 17):
        tokens = torch.randint(0, cfg.vocab, (1, length), device="cuda",
                               generator=gen)
        by = {}
        for backend in ("kernel", "blockwise"):
            logits, _, _ = T.prefill(model, tokens, cfg, length,
                                     backend=backend)
            by[backend] = logits[0, -1].float()
        lk, lb = by["kernel"], by["blockwise"]
        assert torch.isfinite(lk).all() and torch.isfinite(lb).all()
        scale = lb.abs().max().item()
        rel = (lk - lb).abs().max().item() / scale
        assert rel <= LOGIT_REL_TOL, (length, rel)
        # each argmax lies in the other's near-tie group
        tie = LOGIT_REL_TOL * scale
        ak, ab = int(lk.argmax()), int(lb.argmax())
        assert lb[ak] >= lb.max() - tie and lk[ab] >= lk.max() - tie, \
            (length, ak, ab)
        worst = max(worst, rel)
        _log(f"  L={length:4d}: max |Δlogit| / max |logit| {rel:.3e} "
             f"(tol {LOGIT_REL_TOL:g}), argmax kernel {ak} blockwise {ab}")
    return worst


# ---------------------------------------------------------------------------
# phase 6: flash attention and generation timings
# ---------------------------------------------------------------------------

def _flash_bound(b, hq, hkv, l, dh, elsize):
    """Least time for causal attention at Lq = Lk = l: q, k, v read and
    o written once over the memory rate; 4·B·Hq·Dh·L(L+1)/2 operations
    (the two products on the causal triangle) over the bf16 rate."""
    nbytes = elsize * dh * (2 * b * hq * l + 2 * b * hkv * l)
    flops = 4 * b * hq * dh * l * (l + 1) / 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", nbytes, flops)


def _queued_ms(torch, fn, reps, runs):
    """Device time of one call of ``fn``: ``reps`` calls back to back
    between two CUDA events, median over ``runs``.  A spin kernel ahead
    of the start event keeps the card busy while the host queues the
    calls, so the host's per-call cost (which exceeds a short kernel's
    time) is not timed."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms of spinning
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _time_flash(torch, fa_ops, fa_ref, l, runs):
    import torch.nn.functional as F

    sv = ATTN_SERVE
    b, hq, hkv, dh = sv["b"], sv["hq"], sv["hkv"], sv["dh"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _attn_operands(torch, gen, b, hq, hkv, l, l, dh,
                             torch.bfloat16)
    scale = dh ** -0.5
    kernel = lambda: fa_ops.flash_attention(q, k, v, scale=scale)  # noqa: E731
    plain = lambda: fa_ref.attention_ref(q, k, v, scale=scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    for fn in (kernel, plain, library):  # warm up
        fn()
    torch.cuda.synchronize()
    reps = max(1, 200 // runs)  # ~20 calls per event pair at L = 512
    out = {"ms": _queued_ms(torch, kernel, reps, runs),
           "plain_ms": _queued_ms(torch, plain, 1, 3),
           "library_ms": _queued_ms(torch, library, reps, runs)}
    again = _queued_ms(torch, kernel, reps, runs)
    bound_ms, bound_by, nbytes, flops = _flash_bound(b, hq, hkv, l, dh, 2)
    out.update(bound_ms=bound_ms, bound_by=bound_by)
    _log(f"  L={l}: kernel {out['ms']:.4f} ms (again {again:.4f} ms), plain "
         f"{out['plain_ms']:.4f} ms, library SDPA {out['library_ms']:.4f} ms; "
         f"bound {bound_ms:.4f} ms = max({nbytes / 1e6:.1f} MB / 3.35 TB/s, "
         f"{flops / 1e9:.1f} GFLOP / 989 TFLOP/s) by {bound_by}; kernel at "
         f"{bound_ms / out['ms']:.1%} of it, "
         f"{flops / out['ms'] / 1e9:.1f} TFLOP/s")
    return out


def _profile(torch, fn, wall_ms, label):
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    against the call's CUDA-event wall time ``wall_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # operators: their kernels count
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms == 0:
        _log(f"  profiler, {label}: no kernel time recorded (not measured)")
        return
    rows.sort(reverse=True)
    flash_ms = sum(r[0] for r in rows if "flash_fwd" in r[2]) / 1e3
    _log(f"  profiler, {label}: kernels {busy_ms:.3f} ms of {wall_ms:.3f} ms "
         f"wall (device idle {1 - busy_ms / wall_ms:.1%}); flash kernel "
         f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.1%} of kernel time)")
    for dev_us, count, key in rows[:6]:
        _log(f"    {dev_us / 1e3:9.3f} ms {dev_us / 1e3 / busy_ms:6.1%} "
             f"x{count:<4d} {key[:80]}")


def phase_generation_timings(torch, T, model, cfg, fa_ops, fa_ref):
    serving = _time_flash(torch, fa_ops, fa_ref, ATTN_SERVE["l"], 10)
    long = _time_flash(torch, fa_ops, fa_ref, ATTN_LONG_L, 5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    l = ATTN_SERVE["l"]
    tokens = torch.randint(0, cfg.vocab, (1, l), device="cuda",
                           generator=gen)
    max_len = l + MAX_NEW_TOKENS + 1  # the timed steps and a profiled one
    T.prefill(model, tokens, cfg, max_len)  # warm up
    prefill_ms = _median_ms(
        torch, lambda: T.prefill(model, tokens, cfg, max_len), 10)
    _, caches, lengths = T.prefill(model, tokens, cfg, max_len)
    step = tokens[:, -1:]
    steps = []
    for _ in range(MAX_NEW_TOKENS):
        lengths = lengths + 1
        steps.append(_median_ms(
            torch, lambda: T.decode_step(model, caches, step, lengths, cfg), 1))
    decode_ms = statistics.median(steps)
    share = N_LAYERS * serving["ms"] / prefill_ms
    _log(f"  llama3.2-3b FULL bf16: prefill of {l} tokens {prefill_ms:.3f} ms "
         f"(flash {N_LAYERS} × {serving['ms']:.4f} ms = {share:.1%} of it), "
         f"decode {decode_ms:.3f} ms/token at a {l}-token cache "
         "(CUDA events, median)")
    _profile(torch, lambda: T.prefill(model, tokens, cfg, max_len),
             prefill_ms, f"one prefill of {l} tokens")
    lengths = lengths + 1
    _profile(torch, lambda: T.decode_step(model, caches, step, lengths, cfg),
             decode_ms, "one decode step")
    return serving, long


# ---------------------------------------------------------------------------
# phase 7: the IVF index plane at the serving shape
# ---------------------------------------------------------------------------

def _same_results(a, b, label, cos_tol=None):
    """Ids, scores and boost flags equal bit for bit; cosines equal too,
    or within ``cos_tol`` where the cosine is recomputed by a product
    whose batch shape differs (the kernel path's per-result cosine).
    Returns the largest cosine difference."""
    assert len(a) == len(b), (label, len(a), len(b))
    worst = 0.0
    for rank, (x, y) in enumerate(zip(a, b)):
        where = (label, rank, x, y)
        assert (x.doc_id, x.score, x.boosted) == (y.doc_id, y.score,
                                                  y.boosted), where
        diff = abs(x.cosine - y.cosine)
        assert diff == 0.0 or (cos_tol is not None and diff <= cos_tol), where
        worst = max(worst, diff)
    return worst


def _span_ms(spans, name):
    durs = [sp.dur_s * 1e3 for sp in spans if sp.name == name]
    return (statistics.median(durs) if durs else float("nan")), len(durs)


def phase_ivf(torch, np, ops, tk_ops, ctx, tmp):
    """The IVF plane at 65,536 docs: (a) serve.py --index ivf --guarantee
    exact against phase 3's flat run; (b) exact mode one query per
    dispatch against the flat kernel path; (c) probe mode at nprobe 1
    and 8; (d) the trained state saved, reloaded and adopted with no
    retrain; (e) the postings prefilter; (f) the single-query path,
    hsf_score then top_k, whose kernel launches are counted here.
    Returns the launches of hsf_score and of top_k on that path."""
    from repro_torch.core import hsf
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.core.retrieval import Retriever
    from repro_torch.index import IVFIndex, spherical_kmeans
    from repro_torch.kernels.hsf_score import ref
    from repro_torch.launch import serve
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.export import load_chrome_trace

    queries, entities = ctx["queries"], ctx["entities"]

    # (a) serve.py in exact mode, against phase 3's flat run
    _log("  (a) serve --index ivf --guarantee exact (reloaded container, "
         "traced)")
    trace_path = str(Path(tmp) / "ivf_trace.json")
    ops.reset_counts()
    got, tokens, flushes = _serve(serve, [
        "--container", ctx["container"], "--index", "ivf", "--guarantee",
        "exact", "--metrics", "--trace", trace_path, *ctx["common"]])
    obs_trace.disable()
    launches = ops.counts["launches"]
    dispatches = sum(sp.name == "device_dispatch"
                     for sp in load_chrome_trace(trace_path))
    assert ops.counts["unfused"] == 0, ops.counts
    assert launches == dispatches > 0, (launches, dispatches)
    assert got == ctx["flat"], "ivf exact served other ids or scores"
    assert tokens == ctx["tokens"], "ivf exact generated other tokens"
    _log(f"  (a) ids, scores and token ids equal the flat run for all "
         f"{len(queries)} requests; hsf_topk launches {launches} = scoring "
         f"dispatches {dispatches} over {flushes} flushes")

    # (b) exact mode, one query per dispatch; k-means timed on the card
    kb = KnowledgeBase.load(ctx["container"])
    flat = QueryEngine(kb, device="cuda")
    assert flat.scoring_path == "kernel"
    want = flat.query_batch(queries, k=TOP_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spherical_kmeans(flat.doc_vecs, seed=0)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained = IVFIndex.train(flat.doc_vecs, flat.doc_sigs, seed=0)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    IVFIndex.from_assignments(trained.centroids, trained.assign,
                              flat.doc_vecs, flat.doc_sigs, drift=0,
                              trained_n=N_DOCS, seed=0)
    bounds_s = time.perf_counter() - t0
    sizes = [m.size for m in trained.members]
    _log(f"  (b) k-means (k={trained.n_clusters}, 8 Lloyd steps) "
         f"{kmeans_s:.3f} s; train incl. bounds {train_s:.3f} s; "
         f"from_assignments alone {bounds_s:.3f} s (radius dots on the "
         f"card, 33.5 MB of signatures to the host); cluster sizes "
         f"{min(sizes)}..{max(sizes)}")
    t0 = time.perf_counter()
    exact = QueryEngine(kb, device="cuda", index="ivf", guarantee="exact")
    assert exact.retrains == 1
    _log(f"  (b) QueryEngine(index='ivf') built and trained in "
         f"{time.perf_counter() - t0:.2f} s")
    obs_trace.enable()
    obs_trace.get().drain()
    final_rows, rounds, cos_worst, hits = [], [], 0.0, 0
    for q, w in zip(queries, want):
        with obs_trace.span("query"):  # the index plane's spans attach here
            res = exact.query_batch([q], k=TOP_K)[0]
        cos_worst = max(cos_worst, _same_results(res, w, q, cos_tol=1e-6))
        if q in entities:
            hits += res[0].doc_id == f"doc_{entities[q]:05d}.txt"
        st = exact.index_stats()
        final_rows.append(st["candidate_rows"])
        rounds.append(st["rounds"])
    spans = obs_trace.get().drain()
    obs_trace.disable()
    widen = [sp.args["rows"] for sp in spans if sp.name == "ivf_widen_round"]
    subset = [r for r in widen if r < N_DOCS]
    assert len(widen) == sum(rounds) and subset, (len(widen), sum(rounds))
    assert hits == len(entities), hits
    _log(f"  (b) exact, 1 query per dispatch: entity Recall@1 "
         f"{hits / len(entities):.3f}; {len(queries)} queries equal "
         f"the flat kernel path (ids, scores, boost flags; cosines within "
         f"{cos_worst:.1e}); widen rounds mean {statistics.mean(rounds):.2f}"
         f" max {max(rounds)}; {len(subset)} of {len(widen)} scoring "
         f"dispatches reranked a proper subset (mean "
         f"{statistics.mean(subset) / N_DOCS:.1%} of the rows); final "
         f"probed fraction mean {statistics.mean(final_rows) / N_DOCS:.1%}, "
         f"{sum(r < N_DOCS for r in final_rows)} queries stopped short of "
         f"the full scan")

    # (c) probe mode; the flat kernel scores of the same docs, bit for bit
    ent_queries = list(entities)
    for nprobe in (1, 8):
        eng = QueryEngine(kb, device="cuda", index="ivf", nprobe=nprobe)
        assert eng.retrains == 0, "probe engine retrained"
        obs_trace.enable()
        obs_trace.get().drain()
        with obs_trace.span("flush"):
            res = eng.query_batch(queries, k=TOP_K)
        spans = obs_trace.get().drain()
        obs_trace.disable()
        fraction = eng.index_stats()["probed_fraction"]
        probe_ms, _ = _span_ms(spans, "ivf_probe")
        rerank_ms, _ = _span_ms(spans, "ivf_rerank")
        per_query = []
        for q in queries:
            t0 = time.perf_counter()
            eng.query_batch([q], k=TOP_K)
            per_query.append((time.perf_counter() - t0) * 1e3)
        hits = sum(res[i][0].doc_id == f"doc_{entities[c]:05d}.txt"
                   for i, c in enumerate(ent_queries))
        recall16 = statistics.mean(
            len({r.doc_id for r in a} & {r.doc_id for r in b}) / TOP_K
            for a, b in zip(res[len(ent_queries):], want[len(ent_queries):]))
        both = 0
        for a, b in zip(res, want):
            fs = {r.doc_id: r.score for r in b}
            for r in a:
                if r.doc_id in fs:
                    assert r.score == fs[r.doc_id], (r, fs[r.doc_id])
                    both += 1
        recall1 = hits / len(ent_queries)
        if nprobe == 1:
            assert recall1 >= 0.9, recall1
        _log(f"  (c) probe nprobe={nprobe}: entity Recall@1 {recall1:.3f}, "
             f"Recall@16 vs flat (plain queries) {recall16:.3f}, probed "
             f"fraction {fraction:.3%} (mean over the flush), span medians "
             f"ivf_probe {probe_ms:.3f} ms and ivf_rerank {rerank_ms:.3f} ms "
             f"per {len(queries)}-query flush; one query per call "
             f"{statistics.median(per_query):.3f} ms median; {both} "
             "(query, doc) scores shared with flat, equal bit for bit")
        del eng

    # (d) save the trained state, reload, adopt with no retrain
    saved = str(Path(tmp) / "kb_ivf.ragdb")
    kb.save(saved)
    kb2 = KnowledgeBase.load(saved)
    adopted = QueryEngine(kb2, device="cuda", index="ivf", guarantee="exact")
    assert adopted.retrains == 0, adopted.retrains
    assert np.array_equal(adopted.ivf.centroids, exact.ivf.centroids)
    for q, a, w in zip(queries, adopted.query_batch(queries, k=TOP_K),
                       want):
        _same_results(a, w, q, cos_tol=1e-6)
    _log(f"  (d) reloaded container adopted its IVF state (retrains "
         f"{adopted.retrains}, centroids equal) and served the same ids "
         "and scores")
    del adopted, kb2, exact

    # (e) the postings prefilter: subset rows, flat kernel scores
    pre = Retriever(kb, prefilter=True, engine=flat)
    for code, w in zip(ent_queries, want):
        got = pre.query(code, k=TOP_K)
        assert got and got[0].doc_id == f"doc_{entities[code]:05d}.txt"
        _same_results(got, w[:len(got)], code, cos_tol=1e-6)
    _log(f"  (e) prefilter: {len(ent_queries)} entity codes give the flat "
         "top doc, and the flat kernel scores of their subset rows")

    # (f) the single-query path: hsf_score then top_k, counted here
    q_arrays = [flat._query_arrays(q) for q in queries]
    qv = torch.from_numpy(np.stack([a for a, _ in q_arrays])).cuda()
    qs = torch.from_numpy(np.stack([b for _, b in q_arrays])).cuda()
    dv, ds = flat.doc_vecs, flat.doc_sigs
    map_eng = QueryEngine(kb, device="cuda", scoring_path="map")
    map_want = map_eng.query_batch(queries, k=TOP_K)
    ops.reset_counts()
    tk_ops.reset_counts()
    single, from_map = [], []
    for i in range(len(queries)):
        scores = hsf.hsf_scores_kernel(dv, ds, qv[i], qs[i], ALPHA, BETA)
        single.append(tk_ops.top_k(scores, TOP_K))
        from_map.append(tk_ops.top_k(
            hsf.hsf_scores(dv, ds, qv[i], qs[i], ALPHA, BETA), TOP_K))
    torch.cuda.synchronize()
    score_launches = ops.single_counts["launches"]
    topk_launches = tk_ops.counts["launches"]
    assert score_launches == len(queries), score_launches
    assert topk_launches == 2 * len(queries), topk_launches
    pv, pi = ref.hsf_score_topk_ref(dv, ds, qv, qs, ALPHA, BETA, TOP_K + 32)
    kv = torch.stack([v for v, _ in single]).cpu().numpy()
    ki = torch.stack([i for _, i in single]).cpu().numpy()
    err = _check_against_plain(np, kv, ki, pv.cpu().numpy(),
                               pi.cpu().numpy(), tk_ops.ID_SENTINEL,
                               "single-query path")
    for q, (v, i), w in zip(queries, from_map, map_want):
        assert i.tolist() == [flat._row_of[r.doc_id] for r in w], q
        assert v.tolist() == [r.score for r in w], q
    _log(f"  (f) single-query path: hsf_score launches {score_launches}, "
         f"top_k launches {topk_launches}; ids equal the flat kernel path "
         f"under the near-tie rule (max |Δscore| {err:.2e}); top_k of the "
         "map-path scores gives the map engine's ids and scores exactly")
    return score_launches, topk_launches


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    # full f32 in every product the script compares or times
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import get as get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.hsf_score import ops, ref
    from repro_torch.kernels.topk import ops as tk_ops
    from repro_torch.kernels.topk import ref as tk_ref
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _log(f"card: {card}")
    _log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
         f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
         "device(s)")

    _log("phase 1: build")
    t0 = time.perf_counter()
    reports = build.build_all()
    _log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    _log("phase 2: kernels against their plain versions on the card")
    max_err = phase_kernel(torch, np, ops, ref)
    fa_max_err = phase_flash_kernel(torch, fa_ops, fa_ref)
    score_max_err = phase_hsf_score_kernel(torch, np, ops, ref)
    topk_max_err = phase_topk_kernel(torch, np, tk_ops, tk_ref)

    with tempfile.TemporaryDirectory() as tmp:
        _log("phase 3: main path (ingest, serve + generate, reload, serve + "
             "generate)")
        launches, fa_launches, ctx = phase_main_path(torch, ops, fa_ops, tmp)

        _log("phase 4: HSF and top-k timings at the serving shape")
        timing = phase_timings(torch, ops, ref)
        new_timing = phase_new_kernel_timings(torch, ops, ref, tk_ops, tk_ref)

        cfg = get_arch(ARCH).config
        model = _served_model(torch, T, cfg)
        _log(f"phase 5: {ARCH} FULL prefill logits, flash kernel vs blockwise")
        phase_cross_check(torch, T, model, cfg)

        _log("phase 6: flash attention and generation timings")
        fa_timing, _ = phase_generation_timings(torch, T, model, cfg, fa_ops,
                                                fa_ref)
        del model
        torch.cuda.empty_cache()

        _log("phase 7: the IVF index plane at 65,536 docs")
        score_launches, topk_launches = phase_ivf(torch, np, ops, tk_ops,
                                                  ctx, tmp)
    _log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "hsf_score_topk",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hsf_topk.cu",
        "replaces": "src/repro/kernels/hsf_score/hsf_score.py:205",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
        "launches": fa_launches,
        "max_abs_err": fa_max_err,
        **fa_timing,
    }, {
        "name": "hsf_score",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hsf_score.cu",
        "replaces": "src/repro/kernels/hsf_score/hsf_score.py:79",
        "launches": score_launches,
        "max_abs_err": score_max_err,
        **new_timing["score"],
    }, {
        "name": "topk",
        "route": "cuda",
        "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:74",
        "launches": topk_launches,
        "max_abs_err": topk_max_err,
        **new_timing[(N_DOCS, TOP_K)],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
