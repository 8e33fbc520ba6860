#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from ``src/repro_torch/csrc/`` (one ``nvcc`` per source,
   all at once).
2. Kernel against its plain version, on the card: the fused HSF top-k
   at the serving shape (N=65,536 docs, D=4,096, W=128 signature words,
   B=64 queries, k=16) and at its edges (ragged N, n_valid < N, k=128,
   k > n_valid, B=1, duplicated doc rows).
3. Main path: a 65,536-doc synthetic corpus with 64 entity codes,
   served through ``repro_torch.launch.serve.main`` (ingest → container
   save → micro-batched serving), then served again from the reloaded
   container with tracing on (its span breakdown is printed).  Recall@1 must be 1.0 on the entity queries, the kernel's
   launch count must equal the scoring dispatches, and the map path
   must give the same bits on the card and on the CPU.
4. Timings at the serving shape: kernel, plain version, the library
   yardstick, and the bound.

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
SCORE_ATOL = 1e-5
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

_RESULT = re.compile(r"^  ([* ]) (\S+)\s+score=(\S+)$")


def _parse_serve(out: str):
    """{query: [(doc_id, boosted, score_text), ...]} and the flush count
    from the driver's printed output."""
    results, cur = {}, None
    for line in out.splitlines():
        if line.startswith("Q: "):
            cur = line[3:].rsplit("  [generation", 1)[0]
            results[cur] = []
        elif cur is not None and (m := _RESULT.match(line)):
            results[cur].append((m.group(2), m.group(1) == "*", m.group(3)))
    metrics = next(line for line in out.splitlines()
                   if line.startswith("serving metrics:"))
    flushes = int(re.search(r"(\d+) flushes", metrics).group(1))
    return results, flushes, metrics


def _serve(serve, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    assert rc == 0, rc
    out = buf.getvalue()
    results, flushes, metrics = _parse_serve(out)
    lines = out.splitlines()
    # the head (ingest, generation, path), the metrics line, and the
    # span breakdown table when the run was traced
    trace_at = next((i for i, line in enumerate(lines)
                     if line.startswith("trace: ")), len(lines))
    for line in lines[:4] + [metrics] + lines[trace_at:]:
        _log(f"    | {line}")
    _log(f"    ({time.perf_counter() - t0:.1f} s)")
    return results, flushes


def phase_main_path(torch, ops, tmp):
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
              "--queries", *queries]

    # the counts are zeroed just before the main path and read just after
    ops.reset_counts()
    _log("  serve: ingest + save + serve")
    first, flushes_1 = _serve(serve, ["--corpus", corpus, "--dim", str(DIM),
                                      "--save", container, *common])
    _log("  serve: reload the saved container + serve (traced)")
    second, flushes_2 = _serve(serve, [
        "--container", container,
        "--trace", str(Path(tmp) / "trace.json"), *common])
    obs_trace.disable()
    launches = ops.counts["launches"]
    dispatches = flushes_1 + flushes_2
    assert ops.counts["unfused"] == 0, ops.counts
    assert launches == dispatches and launches > 0, (launches, dispatches)

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
         "container round trip serves the same ids and scores")

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
    return launches


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

    from repro_torch.kernels import build
    from repro_torch.kernels.hsf_score import ops, ref

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

    _log("phase 2: kernel against its plain version on the card")
    max_err = phase_kernel(torch, np, ops, ref)

    _log("phase 3: main path (ingest, serve, reload, serve)")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(torch, ops, tmp)

    _log("phase 4: timings at the serving shape")
    timing = phase_timings(torch, ops, ref)
    _log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "hsf_score_topk",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hsf_topk.cu",
        "replaces": "src/repro/kernels/hsf_score/hsf_score.py:205",
        "launches": launches,
        "max_abs_err": max_err,
        **timing,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
