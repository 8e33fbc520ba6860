#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card: name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from ``src/repro_torch/csrc/`` (one ``nvcc`` per source,
   all at once), with each library's registers and spills, and per kernel
   instantiation its registers, static shared memory and spills and
   whether its SASS holds HGMMA (wgmma), UTMALDG (TMA), HMMA
   (mma.sync) and USETMAXREG (setmaxnreg); the wgmma designs must hold
   the first two, the warp-specialised Dh=256 flash design the fourth
   too, MLA's 192/128 flash design no spill, and the top-k radix
   select's four kernels must be there; then each flash design's
   dynamic shared memory and threads per CTA and the CTAs that fit on
   an SM (MLA's design must fit two).
2. Kernels against their plain versions, on the card: the fused HSF
   top-k at the serving shape (N=65,536 docs, D=4,096, W=128 signature
   words, B=64 queries, k=16) and at its edges (ragged N, n_valid < N,
   k=128, k > n_valid, B=1, duplicated doc rows, ragged D=1,000, D=2 and
   W=3 without 16-byte rows, B=100), on shard views (a row slice at an
   odd row offset: D=4,096 keeps the 16-byte TMA path, D=1,001 takes the
   4-byte copies), and 16 queries at B=1 giving the
   bits they get inside B=64; then flash attention at the serving shape
   (B=1, Hq=24, Hkv=8, L=512, Dh=128, bf16, causal, strided operands as
   the projections give them) and at its edges (ragged L, GQA 8:1 at
   Dh=32 in f32, window + softcap at Dh=256, non-causal, q_offset with
   Lq < Lk, kv_len < Lk, fully masked rows, the SMOKE heads of 16 in
   bf16 and f32, Dh=256 in f32, Lq=700 and Lq=1, GQA 3:1 at Dh=64,
   kv_len ending mid-tile in an Lk of 611; at Dh=256 in bf16 a ragged
   last 128-row query tile, Lq=1, kv_len ending mid-tile, fully masked
   rows, non-causal, B=2 contiguous and transposed, GQA 1:1 and 2:1)
   and at phase 11's model
   shapes (gemma2: Dh=256, softcap 50, window 4,096 at L=512 and 8,192;
   gemma3: window 1,024 at L=2,048; qwen3: GQA 8:1), at deepseek's MLA
   heads unpadded (q/k 192, v 128, the design of their own: the serving
   shape laid out as ``models/mla.apply`` gives it, q and k contiguous
   and v a transposed view; ragged L=700, Lq=1, kv_len ending mid-tile,
   q_offset with Lq < Lk, B=2 transposed, fully masked rows, L=8,192),
   and through the route ``mla.apply`` takes (one launch on the
   unpadded heads), and at Dh=256 with logits that reach the softcap
   (q scaled by 12 under a cap of 50, at L=512 and gemma2's 8,192, or
   a cap of 5; with and without a window), each checked to move the
   result by over ten times its atol; bf16 Dh=256 and MLA's heads are
   held at an atol of at most a tenth of the plain result's rms; then the
   single-query HSF score at the serving shape in f32 and bf16 and at
   its edges (ragged N, D without 16-byte rows, W=3, n = 0, the boost
   exactly β); then the top-k radix select at N=65,536 (one launch) and
   16,777,216 with k = 1, 16, 128, duplicate-heavy, -inf-laden, ±0.0
   and +inf scores at both, the recsys shape (1,000,448 with -inf
   padding), all-equal scores at 16,777,216, small N with k = N (ids and
   value bits exactly equal), and a CUDA graph of each launch sequence
   replayed to the eager bits; then the EmbeddingBag kernel
   on a dlrm-rm2 FULL table (48 GB): the serve_p99 and serve_bulk
   batches as bags, one row per bag (bit for bit), rows near row
   187.7 M (byte offsets past 2³¹), empty, unsorted and duplicate
   segments, weights, mean, one huge bag, a bf16 table, E = 7, 10, 16,
   128 and 200.
3. Main path: a 65,536-doc synthetic corpus with 64 entity codes,
   served through ``repro_torch.launch.serve.main`` (ingest → container
   save → micro-batched serving → generation with llama3.2-3b at full
   width in bf16, random weights from seed 0), then served again from
   the reloaded container with tracing on (its span breakdown is
   printed).  Generation replays CUDA graphs of the prefill (one per
   prompt bucket) and decode steps.  Recall@1 must be 1.0 on the entity
   queries, every request must generate, the reloaded run must give the
   same ids, scores and token ids, the HSF kernel's launches must equal
   the scoring dispatches, flash launches must be 28 per prefill (each a
   replay) with no plain call, decode attention launches 28 per decode
   step with no plain call, and the map path must give the same bits
   on the card and on the CPU.
4. Timings of the HSF kernels and the top-k at their serving shapes
   (top-k also at the recsys shape, 1,000,448, and at 16,777,216 scores
   with k = 16 and 128): kernel, plain version, the library yardstick,
   and the bound, as device time of calls queued back to back; then one
   plain read of the 16,777,216 scores, and top-k of all-equal and
   five-valued scores there.
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
   ``top_k`` per query — whose launches the ``kernels`` line reports,
   then its 256 top-k calls timed.
8. The recsys plane at full width: dlrm-rm2 FULL initialised on the
   card (a 48.07 GB table, filled in place) and served through
   ``make_recsys_step(kind="recsys_serve")`` at serve_p99 (512) and
   serve_bulk (262,144), the serve_p99 logits held to the same forward
   on the CPU over the rows the batch touches; the EmbeddingBag path
   (``lookup_bags(use_kernel=True)`` over the served table, launches =
   calls, no plain call), whose launches the ``kernels`` line reports;
   retrieval of 1,000,000 candidates through the top-k kernel (ids and
   values equal the plain top-k's); timings of the EmbeddingBag kernel
   (kernel, sort + offsets, plain, ``F.embedding_bag``, bound) and of
   the forward; a profiled serve step; then deepfm and autoint FULL
   served, checked on the CPU and timed.
9. The compiled serving steps (``launch/steps.py``: a step captured
   once into a CUDA graph over static buffers, then replayed): (a)
   ``RAGPipeline.generate``'s steps on phase 3's container, each prompt
   bucket's prefill replay (two prompts per graph) and the decode
   replay equal to the eager static-shape step bit for bit (logits and
   the whole cache), phase 3's ids, scores and token ids again through
   the graphs, the eager steps' tokens equal, 28 flash launches per
   prefill replay, and prefill and decode timed eager against replay
   with the device's idle share; (b) llama3.2-3b's prefill_32k (batch
   1), decode_32k (batch 8) and long_500k cells, gemma2-9b's
   prefill_32k (batch 1: the window masking inside the Dh=256 kernel)
   and deepseek-v2-lite-16b's decode_32k (the absorbed decode over a
   32,768-slot latent cache, at the largest batch that fits) captured
   and replayed, bit for bit against eager (a decode cell's cache by its
   written slot and exact bit sums), timed, with peak memory; (c) the
   recsys cells
   (dlrm-rm2 serve_p99, serve_bulk and retrieval_cand; deepfm and
   autoint serve_p99 and serve_bulk) likewise, with a second input
   through the same buffers and one top_k launch per retrieval replay.
10. The tenancy plane at full width: 64 per-user containers (8,192
   shared docs ingested once, copied, then 16 own docs per tenant
   appended durably to its journal by a host-side writer session),
   served through ``ServingRuntime(pool=ContainerPool(...))`` on the
   card, every flush through the HSF top-k kernel.  (A) 8 resident,
   Zipf(1.1) traffic from 16 closed-loop clients (2,048 requests, cut at
   90 s): every result equal in ids and scores to a standalone engine on
   the card, own-code Recall@1 1.0, no foreign doc, evictions and more
   than 64 mounts, at most 8 resident after every pin, HSF launches =
   scoring dispatches with no plain call, the device's idle share (leg A
   profiled); (B) a byte budget of four tenants and less than a fifth
   holds exactly 4, pool bytes = ledger device bytes = the distinct
   storages' bytes, peak allocated within (4 + 1) tenants plus a flush's
   working set; (C) a publish that is not durable, then an eviction:
   one journal record more, the remount serves the doc; (D) a hot
   tenant flooding against its quota is rejected with its tenant while
   the others complete (isolation ratio printed); (F) every container
   reloads at its last generation and the card's allocated bytes come
   back to the phase's baseline after every drain; (E) ``serve.main
   --tenant-root`` with no ``--device`` prints the single-tenant
   driver's ids and scores for every tenant, and the ``multi_tenant``
   and ``quickstart`` examples exit 0 on the card.
11. The LM families at full width in bf16, one model at a time:
   gemma2-9b, gemma3-27b, qwen3-moe-30b-a3b (MoE, 61.1 GB) and
   deepseek-v2-lite-16b (MLA + MoE), with random seed-0 weights.  The
   allocated bytes are read at the phase's start (the baseline: no
   table or model of phases 1-10 left) and back at it after each model
   and its graphs are freed.  Per arch: (a) ``serve.main --container
   (phase 3's) --arch <id>`` serves 16 of phase 3's requests, each
   generating, with phase 3's ids and scores, flash launches = layers ×
   prefills and no plain call, decode attention launches = the layers
   it has a design for (gemma3's global ones, all of qwen3's, none of
   gemma2's or deepseek's) × decode steps and no plain call, MoE decode
   launches = the MoE layers (qwen3's 48, deepseek's 26) × decode steps
   and no plain call; the 512 bucket's prefill replay and the
   decode replay equal the eager static-shape steps bit for bit, and two
   served requests again through the graphs give the served tokens and
   the eager steps' tokens; (b) last-position prefill logits through the
   kernel against the blockwise path; (c) for qwen3, its FULL MoE layer
   at T = 512 and T = 1, with its router and with a skewed one (every
   token to expert 0 first, 120 of 128 experts empty), against a plain
   per-expert loop, and a graph replay equal to eager bit for bit; (d)
   prefill and decode at the 512 bucket, eager and replayed, the
   replay's device idle share, the MoE layers' grouped products against
   their bound at T = 512 and 1, the flash kernel at the arch's shape
   against SDPA and its bound (gemma2's also without its softcap: the
   softcap's share; deepseek's at L = 512 and 8,192 beside the route
   that padded its heads to 256, with and without the pad copies), and
   the peak allocated bytes; deepseek's prefill is printed beside the
   padded route's.
12. The sharded retrieval planes, on logical shards of the one card:
   (a) ``build_sharded_retrieve`` on ragdb FULL (dim 4,096, W = 128,
   k = 16, B = 64) at pod_16m's 65,536 docs a shard, S ∈ {1, 4}, whole
   and ragged (1,000 zero rows on the last shard, masked through its
   host ``n_valid``), the fused-kernel and the gemm legs against
   ``single_device_reference`` (phase 2's near-tie rule for ids; kernel
   scores within phase 2's tolerance, gemm scores within rtol 1e-6), S
   kernel launches a call and 0 unfused; one launch over a 65,536-row
   shard view timed against one over 262,144 rows and cuBLAS +
   ``torch.topk`` at both shapes; the ragdb cells (pod_16m and edge_1k
   at S ∈ {1, 4}, both legs) replayed bit-equal to their eager step.
   (b) ``QueryEngine(index="ivf-sharded", guarantee="exact")`` on a
   65,536-doc topical corpus at dim 4,096 for S ∈ {1, 2, 4, 8}: the
   batch's ids, scores and cosines equal the flat map path bit for bit
   at every S, with its time, widen rounds, probed fraction, merge
   seconds and device idle share, and the plane's build seconds and
   bytes; probe mode at nprobe 8; three add_text + publish rounds
   through ``ServingRuntime``, still flat's bits; a flat-written IVF
   state adopted by the sharded engines and the sharded-written state
   by a flat IVF engine, with no retrain; the allocated bytes back at
   the phase's baseline.  (c) The row-sharded recsys lookup at S = 4
   runs inside phase 8, while the 48 GB table is resident: the lookup
   at batch 512, the serve forward and the 1,000,448 candidate scores
   bit-equal to the unsharded ones, no table copied.
13. The training substrate (no kernel is on its path: the flash kernel
   is forward-only, and ``backend="auto"`` under grad raises on the card
   without a launch): (a) llama3.2-3b FULL ``train_4k`` in the optimized
   form (bf16 working copy, float32 master), 8 micro-batches of one
   4,096-token sequence, 3 steps: finite losses, step 0's within 0.5 of
   ln(vocab), the master keeping its bits at the schedule's lr 0 and
   moving in every leaf after, the working copy equal to the master
   after the bf16 cast; step seconds, tokens/s, 6·N·tokens TFLOP/s
   against the bf16 peak, peak memory, the idle share of a profiled
   2-micro-batch window, and one step with TF32 allowed; (b) the five
   LM archs' SMOKE configs, two train steps on the card against the
   same steps on the CPU, each from the CPU's weights, state and tokens
   (loss, update, moments and parameters held per step), and
   qwen3's MoE layer through ``apply_expert_parallel`` on 4 logical
   expert shards against the dropless layer; (c) dlrm-rm2 (its 48.07 GB
   table; 2 steps), deepfm and autoint (3 steps) FULL at ``train_batch``
   (65,536): finite losses, the touched rows against a dense row-wise
   update of those rows alone, the untouched rows and their g2
   bit-unchanged, ms a step, samples/s, peak memory; (d)
   ``launch/train.py --smoke --deterministic`` in a subprocess with
   ``CUBLAS_WORKSPACE_CONFIG`` set: 40 steps with a checkpoint every 20,
   a restart in the same process to step 60, every loss bit-equal to an
   uninterrupted run, save and restore seconds.
14. The analysis plane's guards on the main path (``RAGDB_SANITIZERS=1``:
   no trip and no capture after arming at flush sizes 1-16, the
   unwarmed-step and finite-score trips, the analyzer as a subprocess).
15. The GNN (no kernel of the port is on its path: MACE's message
   passing is ``index_add_``, as the reference's is
   ``jax.ops.segment_sum``): ``launch/dryrun.py`` counts the cells whose
   fit (d) holds on the meta device, in a background subprocess, while
   the card runs (a) mace FULL on its four cells, full_graph_sm,
   minibatch_lg (1,024 seeds sampled (15, 10) from a base graph of
   169,984 nodes) and molecule uncut and ogb_products at the smallest
   ``graph_cut`` the dry run says fits the card, 3 train steps each:
   finite losses, the params' bits kept at lr 0 and moving in every leaf
   after, ms a step, nodes/s, edges/s, peak memory, a profiled step's
   idle share, the allocated bytes back at the phase's baseline after
   each cell; (b) one step and its gradients on the card against the
   CPU from the CPU's params, state and batch (SMOKE on the three kinds,
   FULL on full_graph_sm); (c) ``energy_and_forces`` at FULL on the
   molecule graph: the energy invariant and the forces co-rotating under
   a rotation plus a translation, card = CPU; (d) ``python -m
   repro_torch.launch.dryrun --arch mace --arch dlrm-mlperf --mesh
   single``'s exit 0 over those eight cells, each cell's argument + temp
   bytes and fit verdict against the card's memory, ogb_products uncut
   not fitting and its cut fitting, dlrm-mlperf's cells (its 96.1 GB
   table) not fitting.  The count of every cell runs on the CPU
   (``tests/test_torch_dryrun_cells.py``): it takes minutes of host time
   the script's limit has no room for.
16. The decode attention core (``csrc/decode_attention.cu``): the kernel
   against ``ref.py`` on the card at the benchmark's cache (2,056 slots)
   for qwen3-moe (32:4, qk-norm), llama3.2 (24:8) and gemma3's global
   layers (32:16, qk-norm, query scale), fills 1, 1,024, 1,950 and 2,056
   and two rows of fills 1,950 and 7, then at phase 9's long caches,
   where each split streams many tiles through both stages: the three
   archs at 32,768 slots full, llama3.2 at decode_32k's batch 8 of
   32,768 full and at long_500k's cut of 262,144 full: the output
   within DECODE_TOL of its max, the cache bit-equal but the new slots, those within one bf16
   ulp; a CUDA graph of the call replayed to the eager bits at two
   inputs; the kernel at fill 1,950 beside its bound (K and V read once),
   the plain path and SDPA over the filled slots (attention alone); the
   launches of the core (2 with the kernel) and of a qwen3-moe
   FULL-width decode step a layer (2 layers less 1), with the kernel and
   with the plain path, from a captured graph's nodes and as the
   profiler records them.
17. The MoE decode layer (``csrc/moe_decode.cu``): the kernel against
   ``ref.py`` at qwen3-moe's (128 experts of 768, top 8, renormalised)
   and deepseek-v2-lite's (64 of 1,408, top 6) MoE widths, D 2,048, at
   T = 1, 2, 4, 8, 16 and 32 (the expert ids equal to ``moe.route``'s,
   the gates within 1e-5, the output within MOE_DECODE_TOL); a CUDA graph
   of the call replayed to the eager bits (T = 1 and 2 twice, T = 8
   fifty times); a NaN and an inf in one token's row: ids in range, that
   row NaN, the other rows' bits as with it zeroed; one layer call timed
   at each T, the kernel, ``ref.py`` (what the decode step runs without a
   design) and the grouped path the step ran before (``moe.apply``), each
   as a graph over MOE_DECODE_LAYERS layers' weights in turn, beside the
   kernel's bound (the chosen experts read once) and each path's graph
   nodes, from which the wrapper's MAX_TOKENS is chosen.  The record's
   launches are phase 11's served decode steps.

The second line from the end is a JSON ``kernels`` record; the last is
``{"ok": true, "device": {...}}``.  ``--kernel-timings`` runs phase 1's
build and phase 4's timings alone and prints them as one JSON line;
``--decode-attention`` builds that kernel and runs phase 16 alone, its
result one JSON line; ``--moe-decode`` likewise builds the MoE decode
kernel and runs phase 17 alone.  With no CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
TF32_FLOPS_PER_S = 495e12
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
# phase 11's archs (27-62 bf16 layers): the blockwise path against itself
# in another kv block order can differ by more than LOGIT_REL_TOL (phase
# 11 prints that floor), so there the kernel is held to 1.5 × the floor
# of the same prompt, and to LOGIT_REL_TOL at the least
NOISE_FACTOR = 1.5
# deepseek-v2-lite's MLA prefill heads: q/k nope 128 + rope 64, v 128
MLA_HEADS = dict(h=16, qk=192, v=128)
# deepseek-v2-lite's 512-bucket prefill (eager, replayed; ms) when its
# MLA heads were zero-padded to 256 for the Dh=256 flash design: one
# NVIDIA H100 80GB HBM3 at 700 W, this script's phase 11(d)
MLA_PADDED_PREFILL_MS = (77.729, 25.527)


@contextlib.contextmanager
def _phase(title: str):
    """Log a phase's title, then its seconds when it ends."""
    _log(title)
    t0 = time.perf_counter()
    yield
    _log(f"  ({title.split(':')[0]}: {time.perf_counter() - t0:.1f} s)")


def _log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: what the compiler made of the kernels
# ---------------------------------------------------------------------------

# instantiation -> SASS instructions it must hold: the Hopper designs'
# warpgroup products (HGMMA) and TMA loads (UTMALDG), and the register
# hand-over of the warp-specialised Dh 256 design (USETMAXREG); the radix
# select's kernels must be there (the one-launch cluster, the two reads
# of the multi-launch path and its cluster over the candidate buffer)
_SASS_REQUIRED = {
    "flash_fwd_wgmma<64, 64>": ("HGMMA", "UTMALDG"),
    "flash_fwd_wgmma<128, 128>": ("HGMMA", "UTMALDG"),
    "flash_fwd_wgmma<192, 128>": ("HGMMA", "UTMALDG"),
    "flash_fwd_ws<256, 256>": ("HGMMA", "UTMALDG", "USETMAXREG"),
    "hsf_topk_tiles": ("HGMMA", "UTMALDG"),
    "topk_cluster<1>": (),
    "topk_cluster<0>": (),
    "topk_hist<1>": (),
    "topk_filter<1>": (),
}
# instantiations that must not spill
_SASS_NO_SPILL = ("flash_fwd_wgmma<192, 128>",)


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma<128, 128>`` from an anonymous-namespace mangled name
    (template arguments: integers, names and builtin types)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    args, i = [], 1  # template arguments: literals, names, builtin types
    builtin = {"f": "float", "i": "int", "b": "bool", "j": "unsigned"}
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "L":
            end = rest.find("E", i)
            if end < 0:
                return name
            args.append(re.sub(r"^[a-z]+", "", rest[i + 1:end]))
            i = end + 1
        elif rest[i].isdigit():
            n = re.match(r"\d+", rest[i:]).group()
            start = i + len(n)
            args.append(rest[start:start + int(n)])
            i = start + int(n)
        else:
            args.append(builtin.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def _sass_report(build, reports):
    """Per kernel instantiation, its registers (from the ptxas report)
    and whether its SASS (``cuobjdump -sass``) holds warpgroup products
    (HGMMA), TMA loads (UTMALDG) and mma.sync products (HMMA); raises if a
    Hopper design lacks what it must hold."""
    import shutil

    usage = {}  # mangled name -> registers, static smem and spill bytes
    for report in reports.values():
        for chunk in report.split("Compiling entry function '")[1:]:
            fn = chunk.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", chunk)
            smem = re.search(r"(\d+) bytes smem", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", chunk)
            usage[fn] = (regs.group(1) if regs else "?",
                         int(smem.group(1)) if smem else 0,
                         sum(map(int, spill.groups())) if spill else 0)

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        _log("  SASS: cuobjdump not found in this toolkit; instructions "
             "not checked")
        return
    seen = set()
    for name in sorted(p.stem for p in build.CSRC.glob("*.cu")):
        out = subprocess.run([tool, "-sass", str(build._target(name))],
                             capture_output=True, text=True,
                             check=True).stdout
        for body in re.split(r"\n\s*Function : ", out)[1:]:
            mangled = body.split("\n", 1)[0].strip()
            label = _kernel_label(mangled)
            has = {op: op in body
                   for op in ("HGMMA", "UTMALDG", "HMMA", "USETMAXREG")}
            regs, smem, spill = usage.get(mangled, ("?", 0, 0))
            _log(f"  SASS {name}: {label:28s} {regs:>3s} registers, "
                 f"{smem:6d} B static smem, {spill} B spills, " + " ".join(
                     f"{op} {'yes' if v else 'no'}" for op, v in has.items()))
            for op in _SASS_REQUIRED.get(label, ()):
                assert has[op], f"{label} holds no {op}"
            assert label not in _SASS_NO_SPILL or spill == 0, (label, spill)
            seen.add(label)
    missing = set(_SASS_REQUIRED) - seen
    assert not missing, f"no SASS found for {sorted(missing)}"


def _flash_designs(torch, fa_ops):
    """Each flash design's dynamic shared memory and threads per CTA and
    the CTAs that fit on one SM of this card; MLA's 192/128 design must
    fit two (one warpgroup each, overlapping one's softmax with the
    other's products)."""
    designs = [(dt, d, d) for dt in (torch.bfloat16, torch.float32)
               for d in fa_ops.HEAD_DIMS]
    designs += [(dt, *pair) for dt, pairs in fa_ops.PAIR_DESIGNS.items()
                for pair in pairs]
    for dt, dqk, dv in designs:
        info = fa_ops.design(dt, dqk, dv)
        _log(f"  flash design {str(dt)[6:]:8s} q/k {dqk:3d} v {dv:3d}: "
             f"{info['smem']:6d} B dynamic smem, {info['threads']} threads "
             f"a CTA, {info['ctas_per_sm']} CTA(s) an SM")
        if (dt, dqk, dv) == (torch.bfloat16, MLA_HEADS["qk"], MLA_HEADS["v"]):
            assert info["ctas_per_sm"] >= 2, info


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
        # name, n, b, k, n_valid, dup_rows, d, w
        ("serving shape", N_DOCS, BATCH, TOP_K, None, 0, DIM, SIG_WORDS),
        ("ragged N", 20_011, BATCH, TOP_K, None, 0, DIM, SIG_WORDS),
        ("n_valid < N", 20_011, BATCH, TOP_K, 12_345, 0, DIM, SIG_WORDS),
        ("k = 128", 20_011, BATCH, 128, None, 0, DIM, SIG_WORDS),
        ("k > n_valid (sentinels)", 20_011, BATCH, TOP_K, 7, 0, DIM,
         SIG_WORDS),
        ("B = 1", N_DOCS, 1, TOP_K, None, 0, DIM, SIG_WORDS),
        ("duplicated doc rows", 20_011, BATCH, TOP_K, None, 97, DIM,
         SIG_WORDS),
        # a ragged feature chunk; rows of 8 bytes and signatures of 12
        # (no 16-byte copies); B past one query group
        ("ragged D=1000", 20_011, BATCH, TOP_K, None, 0, 1_000, SIG_WORDS),
        ("D=2 W=3 (4-byte copies)", 20_011, BATCH, TOP_K, None, 0, 2, 3),
        ("B=100 (two query groups)", 5_000, 100, TOP_K, None, 0, DIM,
         SIG_WORDS),
        # phase 10's tenant shape: one container of 8,208 docs, a tenant
        # group of up to 16 queries, and one alone
        ("tenant shape B=16", TENANT_BASE_DOCS + TENANT_OWN_DOCS, 16, TOP_K,
         None, 0, DIM, SIG_WORDS),
        ("tenant shape B=1", TENANT_BASE_DOCS + TENANT_OWN_DOCS, 1, TOP_K,
         None, 0, DIM, SIG_WORDS),
    ]
    worst = 0.0
    for name, n, b, k, n_valid, dup, d, w in cases:
        dv, ds, qv, qs = _make_operands(torch, gen, n, d, w, b, dup_rows=dup)
        kv, ki = ops.hsf_score_batched(dv, ds, qv, qs, k=k, alpha=ALPHA,
                                       beta=BETA, n_valid=n_valid)
        torch.cuda.synchronize()
        # plain list long enough to hold every near-tie of the top k
        # (all copies of a row in the duplicated case; at D = 2 unit rows
        # crowd within SCORE_ATOL of each other)
        extra = n if dup or d < 8 else min(n, k + 32)
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
        _log(f"  kernel == plain: {name:26s} N={n} D={d} W={w} B={b} k={k} "
             f"n_valid={n_valid} max |Δscore| {err:.3e}")
        del dv, ds, qv, qs
    # shard views (phase 12's operands): a row slice of a larger corpus at
    # an odd row offset; D = 4,096 keeps 16-byte rows and base (the TMA
    # path), D = 1,001 takes the 4-byte copies
    for d in (DIM, 1_001):
        dv, ds, qv, qs = _make_operands(torch, gen, 20_011 + 7, d, SIG_WORDS,
                                        BATCH)
        view_v, view_s = dv[7:], ds[7:]
        aligned = view_v.data_ptr() % 16 == 0 and d % 4 == 0
        assert view_v.is_contiguous() and aligned == (d == DIM), d
        kv, ki = ops.hsf_score_batched(view_v, view_s, qv, qs, k=TOP_K,
                                       alpha=ALPHA, beta=BETA)
        pv, pi = ref.hsf_score_topk_ref(view_v, view_s, qv, qs, ALPHA, BETA,
                                        TOP_K + 32)
        err = _check_against_plain(np, kv.cpu().numpy(), ki.cpu().numpy(),
                                   pv.cpu().numpy(), pi.cpu().numpy(),
                                   ops.ID_SENTINEL, f"shard view D={d}")
        worst = max(worst, err)
        _log(f"  kernel == plain: shard view at row 7 of {20_011 + 7} "
             f"N=20011 D={d} W={SIG_WORDS} B={BATCH} k={TOP_K} (base "
             f"{'16-byte aligned, TMA' if aligned else 'not 16-byte rows, 4-byte copies'}"
             f") max |Δscore| {err:.3e}")
        del dv, ds, qv, qs, view_v, view_s
    # a (query, doc) score depends on those two rows alone: 16 queries
    # scored one at a time give the bits they get inside a batch of 64
    dv, ds, qv, qs = _make_operands(torch, gen, N_DOCS, DIM, SIG_WORDS, BATCH)
    kv, ki = ops.hsf_score_batched(dv, ds, qv, qs, k=TOP_K, alpha=ALPHA,
                                   beta=BETA)
    for row in range(0, BATCH, BATCH // 16):
        v1, i1 = ops.hsf_score_batched(
            dv, ds, qv[row:row + 1].contiguous(),
            qs[row:row + 1].contiguous(), k=TOP_K, alpha=ALPHA, beta=BETA)
        assert torch.equal(i1[0], ki[row]) and torch.equal(v1[0], kv[row]), \
            ("B = 1 vs B = 64", row)
    _log("  kernel: 16 queries scored at B = 1 give the ids and score bits "
         "they get inside B = 64")
    del dv, ds, qv, qs
    return max(worst, _nan_cases(torch, np, ops, ref, gen))


def _float_bits(torch, bits):
    """A float32 scalar tensor with the given int32 bit pattern."""
    return torch.tensor([bits], dtype=torch.int32).view(torch.float32)[0]


def _nan_cases(torch, np, ops, ref, gen):
    """The fused HSF top-k on poisoned doc rows against its plain
    version: a NaN score ranks above +inf whatever its sign, NaNs in id
    order, each with its own id; a -inf score is no candidate.  The
    leading NaN and +inf slots must equal the plain version's in ids and
    value bits, the rest as ``_check_against_plain`` holds them."""
    nan = float("nan")
    neg_nan = _float_bits(torch, -4_194_304)  # 0xFFC00000
    n = 20_011
    worst = 0.0

    def case(name, prep, n_valid=None, k=TOP_K, rows=n):
        dv, ds, qv, qs = _make_operands(torch, gen, rows, DIM, SIG_WORDS,
                                        BATCH)
        prep(dv, qv)
        kv, ki = ops.hsf_score_batched(dv, ds, qv, qs, k=k, alpha=ALPHA,
                                       beta=BETA, n_valid=n_valid)
        torch.cuda.synchronize()
        pv, pi = ops._with_sentinels(*ref.hsf_score_topk_ref(
            dv, ds, qv, qs, ALPHA, BETA, min(rows, k + 32),
            n_valid=n_valid))
        kv, ki = kv.cpu().numpy(), ki.cpu().numpy()
        pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
        lead, err = [], 0.0
        for row in range(BATCH):
            # the NaN and +inf head of the row: exact ids and bits
            m = int(np.sum(np.isnan(pv[row, :k]) | np.isposinf(pv[row, :k])))
            assert np.array_equal(ki[row, :m], pi[row, :m]), \
                (name, row, ki[row, :m], pi[row, :m])
            assert np.array_equal(kv[row, :m].view(np.int32),
                                  pv[row, :m].view(np.int32)), \
                (name, row, kv[row, :m].view(np.int32),
                 pv[row, :m].view(np.int32))
            lead.append(m)
            err = max(err, _check_against_plain(
                np, kv[row:row + 1, m:], ki[row:row + 1, m:],
                pv[row:row + 1, m:], pi[row:row + 1, m:], ops.ID_SENTINEL,
                f"{name} row {row}"))
        _log(f"  kernel == plain: {name:34s} N={rows} k={k} "
             f"n_valid={n_valid}: NaN/+inf heads of {min(lead)}-{max(lead)} "
             f"slots equal in ids and value bits, ids "
             f"{ki[0, :min(6, k)].tolist()}..., max |Δscore| {err:.3e}")
        del dv, ds, qv, qs
        return err, ki

    def nan_rows(dv, qv):
        dv[[5, 777, n - 1]] = nan

    err, ki = case("NaN rows", nan_rows)
    assert (ki[:, :3] == [5, 777, n - 1]).all()
    worst = max(worst, err)

    def many_nan(dv, qv):
        dv[torch.arange(40, device="cuda") * 499] = nan

    err, ki = case("40 NaN rows, k = 16", many_nan)
    assert (ki == np.arange(16) * 499).all()
    worst = max(worst, err)

    def signed_nan(dv, qv):
        dv[9] = neg_nan
        dv[3] = nan
        dv[100, 17] = neg_nan  # one NaN element poisons the row

    err, ki = case("NaN with its sign bit set", signed_nan)
    assert (ki[:, :3] == [3, 9, 100]).all()
    worst = max(worst, err)

    def padded_nan(dv, qv):
        dv[[7, 15_000]] = nan  # 15,000 lies past n_valid

    err, ki = case("NaN beside -inf padding", padded_nan, n_valid=12_345)
    assert (ki[:, 0] == 7).all() and not (ki == 15_000).any()
    worst = max(worst, err)

    def few_valid(dv, qv):
        dv[3] = nan

    err, ki = case("NaN, k > n_valid (sentinels)", few_valid, n_valid=7)
    assert (ki[:, 0] == 3).all() and (ki[:, 7:] == ops.ID_SENTINEL).all()
    worst = max(worst, err)

    def infinities(dv, qv):
        # an overflowing product: 3e38 × ±2 is ±inf in f32 on both sides
        dv[11, 0] = 3e38
        qv[:, 0] = torch.tensor([2.0, -2.0], device="cuda").repeat(
            BATCH // 2)
        dv[4] = nan

    err, ki = case("NaN, +inf and -inf scores", infinities)
    assert (ki[:, 0] == 4).all() and (ki[0::2, 1] == 11).all()
    assert not (ki[1::2] == 11).any()
    worst = max(worst, err)

    def mostly_neg_inf(dv, qv):
        dv[5:, 0] = 3e38
        qv[:, 0] = -2.0
        dv[2] = nan

    err, ki = case("-inf docs in the top k", mostly_neg_inf, rows=1_000)
    assert (ki[:, 0] == 2).all() and (ki[:, 5:] == ops.ID_SENTINEL).all()
    return max(worst, err)


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
    """Top-k kernel (radix select) against its plain version: ids and
    values exactly equal, over random, duplicate-heavy, -inf-laden, ±0.0
    and +inf vectors at N = 65,536 (one launch) and 16,777,216, the
    recsys retrieval shape (1,000,448 with -inf padding), all-equal
    scores at 16,777,216, and small N with k = N; then one CUDA-graph
    capture and replay per launch sequence, equal to the eager bits."""
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

    def zeros(n):  # -0.0, +0.0 and -1 at random: the top is all zeros
        pick = torch.randint(0, 3, (n,), device="cuda", generator=gen)
        return torch.tensor([-0.0, 0.0, -1.0], device="cuda")[pick]

    def with_inf(n):  # a few +inf, two of them adjacent, in normal scores
        s = normal(n)
        s[torch.randperm(n, device="cuda", generator=gen)[:5]] = float("inf")
        s[n // 2:n // 2 + 2] = float("inf")
        return s

    def padded(n, real):  # recsys retrieval: padding at -inf
        s = normal(n)
        s[real:] = ninf
        return s

    cases = []
    for n in (N_DOCS, TOPK_LONG_N):
        for k in (1, 16, 128):
            cases.append((f"normal N={n}", normal(n), k))
        cases.append((f"duplicates N={n}", dups(n), 128))
        cases.append((f"40 finite, rest -inf N={n}", sparse(n, 40), 128))
        cases.append((f"±0.0 ties N={n}", zeros(n), 128))
        cases.append((f"+inf present N={n}", with_inf(n), 16))
    for k in (16, 128):
        cases.append((f"recsys N={RETRIEVAL_PAD} (-inf pad)",
                      padded(RETRIEVAL_PAD, RETRIEVAL_N), k))
        cases.append((f"all equal N={TOPK_LONG_N}",
                      torch.full((TOPK_LONG_N,), 0.5, device="cuda"), k))
    for n in (1, 5, 100, 128):
        cases.append((f"k = N = {n}", normal(n), n))
    cases.append(("[1, -inf, 2, -inf, 1]", torch.tensor(
        [1.0, ninf, 2.0, ninf, 1.0], device="cuda"), 5))
    cases.append(("all -inf", torch.full((3000,), ninf, device="cuda"), 7))
    # NaN: above +inf whatever its sign and payload, NaNs in id order,
    # each with its own id and bits (the JAX kernel's order)
    neg_nan = _float_bits(torch, -4_194_304)       # 0xFFC00000
    payload_nan = _float_bits(torch, 2_143_289_635)  # 0x7FC00123

    def with_nan(n, many):
        s = with_inf(n)
        at = torch.randperm(n, device="cuda", generator=gen)[:many + 3]
        s[at[:many]] = float("nan")
        s[at[many]], s[at[many + 1]] = neg_nan, payload_nan
        s[at[many + 2]] = ninf
        return s

    for n in (N_DOCS, TOPK_LONG_N):
        for many, k in ((3, 16), (3, 128), (400, 128)):
            cases.append((f"{many + 2} NaN (±, payload), ±inf N={n}",
                          with_nan(n, many), k))
        cases.append((f"all NaN N={n}",
                      torch.full((n,), float("nan"), device="cuda"), 16))
    nan_pad = padded(RETRIEVAL_PAD, RETRIEVAL_N)
    nan_pad[[17, RETRIEVAL_N - 1, RETRIEVAL_N + 5]] = float("nan")
    nan_pad[99] = neg_nan
    cases.append((f"NaN beside -inf pad N={RETRIEVAL_PAD}", nan_pad, 16))
    few = torch.full((3000,), ninf, device="cuda")
    few[[10, 2999]], few[400] = float("nan"), 1.0
    cases.append(("2 NaN, 1 finite, rest -inf", few, 7))
    cases.append(("all -inf N=1,000,448", torch.full(
        (RETRIEVAL_PAD,), ninf, device="cuda"), 16))
    for name, scores, k in cases:
        kv, ki = tk_ops.top_k(scores, k)
        torch.cuda.synchronize()
        pv, pi = tk_ref.top_k_ref(scores, k)
        assert kv.shape == (k,) and ki.dtype == torch.int32, name
        assert torch.equal(ki, pi), (name, ki[:8].tolist(), pi[:8].tolist())
        # bits, so that -0.0 and +0.0 differ
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32)), \
            (name, kv[:8].tolist(), pv[:8].tolist())
        _log(f"  top_k == plain: {name:32s} k={k:3d} ids and value bits "
             "equal")
    del cases
    lib = tk_ops._lib()
    for n in (N_DOCS, RETRIEVAL_PAD):
        scores = normal(n)
        ev, ei = tk_ops.top_k(scores, TOP_K)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gv, gi = tk_ops.top_k(scores, TOP_K)
        gv.zero_()
        gi.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(gi, ei) and torch.equal(
            gv.view(torch.int32), ev.view(torch.int32)), ("graph", n)
        _log(f"  top_k N={n} k={TOP_K}: a CUDA graph captured once "
             f"({lib.topk_kernels_for(n)} kernel launch(es) a call) and "
             "replayed gives the eager ids and value bits")
    return 0.0


# ---------------------------------------------------------------------------
# phase 2 (embedding bag) and phase 8: the recsys plane
# ---------------------------------------------------------------------------

# configs/dlrm_rm2.py FULL: 26 Criteo fields, E = 64, 187,767,808 table
# rows (48.07 GB f32), at the shapes of configs/shapes.py
SERVE_P99, SERVE_BULK = 512, 262_144
RETRIEVAL_N, RETRIEVAL_PAD = 1_000_000, 1_000_448
# embedding bag, kernel vs plain: f32 sums of the same products in
# another order (the plain version adds with atomics), so per element
# |Δ| <= BAG_REL · Σ|w·x| over the bag + BAG_ABS; a bf16 table adds one
# bf16 rounding of the result (2⁻⁷ relative)
BAG_REL, BAG_ABS, BF16_ULP = 1e-5, 1e-6, 2.0 ** -7
# full-width logits and scores, card against the CPU: the same f32
# products summed in another order, relative to the largest magnitude
RECSYS_TOL = 1e-4


def _bag_magnitude(torch, table, idx, seg, w, n_bags):
    """Σ|w·x| per bag and column, the scale of a sum's rounding error."""
    rows = torch.index_select(table, 0, idx.long()).float().abs()
    if w is not None:
        rows = rows * w.abs()[:, None]
    return torch.zeros((n_bags, table.shape[1]), device=table.device
                       ).index_add_(0, seg.long(), rows)


def _check_bag(torch, bag_ops, bag_ref, table, idx, seg, n_bags, w, mode,
               name):
    """Kernel against plain within the stated tolerance, and the same
    bits on a second call.  Returns (kernel output, max |Δ|)."""
    got = bag_ops.embedding_bag(table, idx, seg, n_bags, w, mode=mode)
    torch.cuda.synchronize()
    want = bag_ref.embedding_bag_ref(table, idx, seg, n_bags, w, mode=mode)
    assert got.shape == want.shape and got.dtype == table.dtype, name
    diff = (got.float() - want.float()).abs()
    tol = BAG_REL * _bag_magnitude(torch, table, idx, seg, w, n_bags) \
        + BAG_ABS
    if table.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.float().abs()
    bad = int((diff > tol).sum())
    assert bad == 0, (name, bad, diff.max().item())
    again = bag_ops.embedding_bag(table, idx, seg, n_bags, w, mode=mode)
    assert torch.equal(got, again), (name, "other bits on a second call")
    err = diff.max().item()
    _log(f"  embedding_bag == plain: {name:36s} n={idx.shape[0]} "
         f"bags={n_bags} E={table.shape[1]} {str(table.dtype)[6:]} {mode}: "
         f"max |Δ| {err:.3e}, same bits twice")
    return got, err


def _serve_bags(torch, sparse, offs):
    """A served batch [B, F] as bags: sample b's F rows are bag b."""
    b, f = sparse.shape
    flat = (torch.from_numpy(sparse).cuda() + offs[None, :]).reshape(-1)
    seg = torch.arange(b, device="cuda", dtype=torch.int32
                       ).repeat_interleave(f)
    return flat, seg


def phase_bag_kernel(torch, bag_ops, bag_ref, emb, rbase, pipeline):
    """EmbeddingBag kernel against its plain version on a dlrm-rm2 FULL
    table (48 GB): the serve_p99 and serve_bulk batches as bags (and
    against ``lookup(...).sum(1)``), one row per bag (the row bit for
    bit, at random places and at the table's last rows), unsorted and
    duplicate segments with empty bags, weights, mean, rows near
    187.7 M, one huge bag; then a bf16 table, deepfm's and autoint's
    tables (E = 10, 16) and E = 7, 128, 200.  Returns the largest |Δ|
    of the f32 cases."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    vocabs = rbase.CRITEO_VOCABS
    t0 = time.perf_counter()
    table = emb.init_tables(gen, vocabs, 64, "cuda")["table"]
    torch.cuda.synchronize()
    v = table.shape[0]
    _log(f"  dlrm-rm2 table {tuple(table.shape)} f32 "
         f"({table.numel() * 4 / 1e9:.2f} GB) filled in "
         f"{time.perf_counter() - t0:.2f} s")
    offs = emb.field_offsets(vocabs, "cuda")
    cursor = pipeline.DataCursor(seed=12)
    worst = 0.0
    for b in (SERVE_P99, SERVE_BULK):
        _, sparse, _ = pipeline.recsys_batch(cursor, b, vocabs, 13)
        flat, seg = _serve_bags(torch, sparse, offs)
        got, err = _check_bag(torch, bag_ops, bag_ref, table, flat, seg, b,
                              None, "sum", f"batch {b}, one bag per sample")
        worst = max(worst, err)
        rows = emb.lookup(table, offs, torch.from_numpy(sparse).cuda())
        torch.testing.assert_close(got, rows.sum(1), rtol=1e-5, atol=1e-5,
                                   msg="bags != lookup(...).sum(1)")
        del flat, seg, got, rows
    n = 4096
    ids = torch.randint(0, v, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    one = bag_ops.embedding_bag(table, ids, torch.arange(
        n, device="cuda", dtype=torch.int32), n)
    assert torch.equal(one, torch.index_select(table, 0, ids)), \
        "one row per bag != the row"
    end = torch.arange(v - 410, v, device="cuda", dtype=torch.int32)
    last = bag_ops.embedding_bag(table, end.flip(0), torch.arange(
        410, device="cuda", dtype=torch.int32), 410)
    assert torch.equal(last, table[v - 410:].flip(0)), "rows near the end"
    _log(f"  embedding_bag: one unweighted row per bag is the row bit for "
         f"bit ({n} random rows; rows {v - 410:,}..{v - 1:,}, byte offsets "
         f"up to {(v - 1) * 64 * 4 / 1e9:.2f} GB)")
    n, bags = 200_000, 60_000  # about 2,150 bags stay empty
    ids = torch.randint(0, v, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    seg = torch.randint(0, bags, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    w = torch.randn(n, device="cuda", generator=gen)
    near_end = torch.randint(v - 1000, v, (n,), device="cuda", generator=gen,
                             dtype=torch.int32)
    huge = torch.zeros(100_000, device="cuda", dtype=torch.int32)
    for name, i, s, nb, ww, mode in (
            ("unsorted duplicate segments, weights", ids, seg, bags, w, "sum"),
            ("the same, mean", ids, seg, bags, w, "mean"),
            ("the same, no weights", ids, seg, bags, None, "sum"),
            ("rows near 187.7 M, weights", near_end, seg, bags, w, "sum"),
            ("one huge bag and an empty one", ids[:100_000], huge, 2,
             w[:100_000], "sum")):
        _, err = _check_bag(torch, bag_ops, bag_ref, table, i, s, nb, ww,
                            mode, name)
        worst = max(worst, err)
    half = table[:1_000_000].to(torch.bfloat16)
    del table, one, last
    torch.cuda.empty_cache()
    small = torch.randint(0, half.shape[0], (n,), device="cuda",
                          generator=gen, dtype=torch.int32)
    _check_bag(torch, bag_ops, bag_ref, half, small, seg, bags, w, "sum",
               "bf16 table, weights")
    _check_bag(torch, bag_ops, bag_ref, half, small, seg, bags, None, "mean",
               "bf16 table, mean")
    del half
    for name, e in (("deepfm table", 10), ("autoint table", 16)):
        vocab = rbase.DEEPFM_VOCABS
        t = emb.init_tables(gen, vocab, e, "cuda")["table"]
        _, sparse, _ = pipeline.recsys_batch(cursor, SERVE_P99, vocab, 0)
        flat, s = _serve_bags(torch, sparse, emb.field_offsets(vocab, "cuda"))
        _, err = _check_bag(torch, bag_ops, bag_ref, t, flat, s, SERVE_P99,
                            None, "sum", f"{name}, batch {SERVE_P99}")
        worst = max(worst, err)
        del t
    for e in (7, 128, 200):  # scalar loads; 32 lanes; two column chunks
        t = torch.randn(50_000, e, device="cuda", generator=gen)
        i = torch.randint(0, 50_000, (20_000,), device="cuda", generator=gen)
        s = torch.randint(0, 3_000, (20_000,), device="cuda", generator=gen)
        _, err = _check_bag(torch, bag_ops, bag_ref, t, i, s, 3_000,
                            w[:20_000].contiguous(), "sum", f"E={e}, weights")
        worst = max(worst, err)
    torch.cuda.empty_cache()
    return worst


def _attn_operands(torch, gen, b, hq, hkv, lq, lk, dh, dtype,
                   strided=False):
    """q, k, v from the standard normal; ``dh`` is one head size or
    (q/k's, v's).  ``strided`` makes them the [B, L, H, Dh] → [B, H, L,
    Dh] transposed views the projections give the kernel; ``"mla"`` lays
    them out as ``models/mla.apply`` does: q and k contiguous (nope and
    rope heads concatenated), v a transposed view."""
    dqk, dv = (dh, dh) if isinstance(dh, int) else dh

    def one(h, l, d, view):
        if view:
            t = torch.randn(b, l, h, d, device="cuda", generator=gen)
            return t.to(dtype).transpose(1, 2)
        return torch.randn(b, h, l, d, device="cuda", generator=gen) \
            .to(dtype)
    qk_view = strided is True
    return (one(hq, lq, dqk, qk_view), one(hkv, lk, dqk, qk_view),
            one(hkv, lk, dv, bool(strided)))


def _flash_cases(torch):
    """Phase 2's flash cases: name, (b, hq, hkv, lq, lk, dh), dtype,
    strided, options."""
    bf16, f32 = torch.bfloat16, torch.float32
    sv = ATTN_SERVE
    mh, mla = MLA_HEADS["h"], (MLA_HEADS["qk"], MLA_HEADS["v"])
    return [
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
        # the wgmma design's edges: a ragged last query tile and a single
        # row; GQA 3:1 at Dh=64; kv_len ending mid-tile in an Lk whose
        # rows end mid-tile too
        ("Lq=700 (ragged query tile)", (1, 24, 8, 700, 700, 128), bf16,
         True, {}),
        ("Lq=1 q_offset=610 Lk=611", (1, 24, 8, 1, 611, 128), bf16, True,
         {"q_offset": 610}),
        ("GQA 24:8 Dh=64", (2, 24, 8, 300, 300, 64), bf16, True, {}),
        ("kv_len=555 < Lk=611 Dh=128", (1, 8, 4, 100, 611, 128), bf16,
         False, {"q_offset": 511, "kv_len": 555}),
        ("kv_len=37 < Lk=611 Dh=64 window 20", (1, 6, 2, 90, 611, 64),
         bf16, True, {"kv_len": 37, "window": 20}),
        # the warp-specialised Dh=256 design's edges: a ragged last
        # 128-row query tile, a single row, kv_len ending mid-tile,
        # fully masked rows, non-causal, B=2 with contiguous operands
        # (TMA row slot 1) and transposed ones (slot 2), GQA 1:1 and 2:1
        ("Dh=256 Lq=700 (ragged query tile)", (1, 16, 8, 700, 700, 256),
         bf16, True, {}),
        ("Dh=256 Lq=1 q_offset=610 Lk=611", (1, 16, 8, 1, 611, 256), bf16,
         True, {"q_offset": 610}),
        ("Dh=256 kv_len=555 < Lk=611", (1, 16, 8, 100, 611, 256), bf16,
         True, {"q_offset": 511, "kv_len": 555}),
        ("Dh=256 fully masked rows (q_offset=-40)",
         (1, 4, 2, 200, 200, 256), bf16, True, {"q_offset": -40}),
        ("Dh=256 non-causal", (2, 4, 2, 300, 300, 256), bf16, True,
         {"causal": False}),
        ("Dh=256 B=2 contiguous", (2, 8, 4, 256, 256, 256), bf16, False,
         {}),
        ("Dh=256 B=2 transposed", (2, 8, 4, 256, 256, 256), bf16, True,
         {}),
        ("Dh=256 GQA 1:1", (1, 8, 8, 400, 400, 256), bf16, True, {}),
        ("Dh=256 GQA 2:1", (1, 8, 4, 400, 400, 256), bf16, True, {}),
        # phase 11's model shapes: gemma2 (Dh 256, softcap 50, window
        # 4,096, which masks at 8,192), gemma3 (window 1,024 masking at
        # 2,048, query scale 168^-1/2), qwen3 (GQA 8:1)
        ("gemma2 L=512 Dh=256 softcap 50 window 4096",
         (1, 16, 8, 512, 512, 256), bf16, True,
         {"window": 4096, "softcap": 50.0}),
        ("gemma2 L=8192 Dh=256 softcap 50 window 4096",
         (1, 16, 8, 8192, 8192, 256), bf16, True,
         {"window": 4096, "softcap": 50.0}),
        ("gemma3 L=2048 window 1024 scale 168^-1/2",
         (1, 32, 16, 2048, 2048, 128), bf16, True,
         {"window": 1024, "scale": 168 ** -0.5}),
        ("qwen3 GQA 32:4 L=512", (1, 32, 4, 512, 512, 128), bf16, True, {}),
        # Dh=256 with logits that reach the softcap (on N(0, 1) logits a
        # cap of 50 moves none by more than ~0.01): q scaled by 12 under
        # gemma2's cap of 50, or a cap of 5; causal at L=512 gives tiles
        # wholly inside the mask and tiles the mask cuts, a window of
        # 300 also cuts tiles below the diagonal
        ("Dh=256 softcap 50 reached (q x12)", (1, 8, 4, 512, 512, 256),
         bf16, True, {"softcap": 50.0, "q_gain": 12.0, "cap_acts": True}),
        ("Dh=256 softcap 50 reached window 300",
         (1, 8, 4, 512, 512, 256), bf16, True,
         {"softcap": 50.0, "window": 300, "q_gain": 12.0, "cap_acts": True}),
        ("Dh=256 softcap 5", (1, 8, 4, 512, 512, 256), bf16, True,
         {"softcap": 5.0, "cap_acts": True}),
        ("Dh=256 softcap 5 window 300", (1, 8, 4, 512, 512, 256), bf16,
         True, {"softcap": 5.0, "window": 300, "cap_acts": True}),
        ("gemma2 L=8192 softcap 50 reached", (1, 16, 8, 8192, 8192, 256),
         bf16, True, {"window": 4096, "softcap": 50.0, "q_gain": 12.0,
                      "cap_acts": True}),
        # deepseek's MLA heads unpadded (the 192/128 design): the serving
        # shape laid out as mla.apply gives it, then its edges
        ("MLA serving shape", (1, mh, mh, sv["l"], sv["l"], mla), bf16,
         "mla", {}),
        ("MLA Lq=700 (ragged query tile)", (1, mh, mh, 700, 700, mla), bf16,
         "mla", {}),
        ("MLA Lq=1 q_offset=610 Lk=611", (1, mh, mh, 1, 611, mla), bf16,
         "mla", {"q_offset": 610}),
        ("MLA kv_len=555 < Lk=611", (1, mh, mh, 100, 611, mla), bf16, "mla",
         {"q_offset": 511, "kv_len": 555}),
        ("MLA q_offset=512 Lq=100 < Lk=612", (1, mh, mh, 100, 612, mla),
         bf16, False, {"q_offset": 512}),
        ("MLA B=2 transposed", (2, mh, mh, 256, 256, mla), bf16, True, {}),
        ("MLA fully masked rows (q_offset=-40)", (1, 4, 4, 200, 200, mla),
         bf16, "mla", {"q_offset": -40}),
        ("MLA L=8192", (1, mh, mh, ATTN_LONG_L, ATTN_LONG_L, mla), bf16,
         "mla", {}),
    ]


def phase_flash_kernel(torch, fa_ops, fa_ref, cases=None):
    """Flash kernel against its plain version over ``cases`` (default:
    all of ``_flash_cases``, then MLA's routes); returns the largest |Δ|
    and {case: (max |Δ|, atol, rms |Δ|)}.  bf16 Dh=256 and MLA cases are
    held at an atol of at most a tenth of the plain result's rms (at
    L=8,192 a typical |o| is ~0.03, under BF16_TOL); a case with
    ``q_gain`` scales q by it,
    and one with ``cap_acts`` must differ from the uncapped result by
    over ten times its atol (the softcap reaches its logits)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32 = torch.float32
    worst, errs = 0.0, {}
    for name, (b, hq, hkv, lq, lk, dh), dtype, strided, opts in (
            cases or _flash_cases(torch)):
        opts = dict(opts)
        gain = opts.pop("q_gain", None)
        cap_acts = opts.pop("cap_acts", False)
        q, k, v = _attn_operands(torch, gen, b, hq, hkv, lq, lk, dh, dtype,
                                 strided)
        if gain is not None:
            q = q * gain  # keeps the transposed strides
        dqk = dh if isinstance(dh, int) else dh[0]
        kw = {"scale": dqk ** -0.5, "causal": True, **opts}
        got = fa_ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa_ref.attention_ref(q, k, v, **kw)
        tol = atol = F32_TOL if dtype == f32 else BF16_TOL
        scaled = dtype != f32 and (dh == 256 or not isinstance(dh, int))
        if scaled:
            rms = want.float().square().mean().sqrt().item()
            atol = min(BF16_TOL, 0.1 * rms)
        assert got.shape == want.shape and got.dtype == dtype, name
        assert torch.isfinite(got).all(), name
        delta = got.float() - want.float()
        err = delta.abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=atol, msg=name)
        q_off = opts.get("q_offset", 0)
        if q_off < 0:  # rows before position 0 see no key: exactly 0
            dead = got[:, :, :-q_off]
            assert dead.numel() and not dead.any(), name
        worst = max(worst, err)
        errs[name] = (err, atol, delta.square().mean().sqrt().item())
        if scaled:
            cap = ""
            if "softcap" in kw:
                bare = {k_: v_ for k_, v_ in kw.items() if k_ != "softcap"}
                moved = (fa_ref.attention_ref(q, k, v, **bare).float()
                         - want.float()).abs().max().item()
                assert not cap_acts or moved > 10 * atol, (name, moved, atol)
                cap = f"; the cap moves it {moved:.3g}"
            _log(f"  flash == plain: {name:34s} {str(dtype)[6:]:8s} "
                 f"max |Δ| {err:.3e}, rms {errs[name][2]:.3e} (rtol "
                 f"{tol:g}, atol {atol:.3g} = min({tol:g}, rms/10){cap})")
        else:
            _log(f"  flash == plain: {name:34s} {str(dtype)[6:]:8s} "
                 f"max |Δ| {err:.3e} (tol {tol:g})")
        del q, k, v, got, want, delta
    if cases is None:
        err = _check_mla_route(torch, fa_ops, fa_ref, gen)
        errs["deepseek MLA route"] = (err, BF16_TOL, None)
        worst = max(worst, err)
    return worst, errs


def _check_mla_route(torch, fa_ops, fa_ref, gen):
    """deepseek-v2-lite's prefill attention at the serving shape through
    ``models/mla.padded_attention`` as ``mla.apply`` calls it in bf16
    (its heads as they are: one launch of the 192/128 design) against
    plain attention; returns the max |Δ|."""
    from repro_torch.models import mla

    m = MLA_HEADS
    q, k, v = _attn_operands(torch, gen, 1, m["h"], m["h"], ATTN_SERVE["l"],
                             ATTN_SERVE["l"], (m["qk"], m["v"]),
                             torch.bfloat16, "mla")
    scale = m["qk"] ** -0.5
    cfg = mla.MLAConfig(nope_head_dim=m["qk"] - 64, rope_head_dim=64,
                        v_head_dim=m["v"])
    head = mla.padded_head_dim(cfg, torch.bfloat16)
    assert head is None, head
    fa_ops.reset_counts()
    got = mla.padded_attention(q, k, v, scale=scale, head_dim=head,
                               backend="kernel")
    torch.cuda.synchronize()
    assert fa_ops.counts == {"launches": 1, "plain": 0}, fa_ops.counts
    want = fa_ref.attention_ref(q, k, v, scale=scale)
    assert got.shape == want.shape == v.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL, msg="MLA route")
    _log(f"  flash == plain: {'deepseek MLA route (mla.apply)':34s} "
         f"bfloat16 max |Δ| {err:.3e} (tol {BF16_TOL:g}; the heads as "
         "they are, one launch)")
    return err


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
    gen_lines = [line for line in lines
                 if line.startswith(("generation:", "generation graphs:"))]
    extra = [line for line in lines if line.startswith("index stats:")]
    trace_at = next((i for i, line in enumerate(lines)
                     if line.startswith("trace: ")), len(lines))
    for line in lines[:5] + gen_lines + [metrics] + extra + lines[trace_at:]:
        _log(f"    | {line}")
    _log(f"    ({time.perf_counter() - t0:.1f} s)")
    return results, tokens, flushes


def phase_main_path(torch, ops, fa_ops, tmp):
    from repro_torch.core.engine import QueryEngine
    from repro_torch.kernels.decode_attention import ops as da_ops
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
    da_ops.reset_counts()
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
    decodes = prefills * MAX_NEW_TOKENS
    da_launches = da_ops.counts["launches"]
    assert da_ops.counts == {"launches": N_LAYERS * decodes, "plain": 0}, \
        (da_ops.counts, decodes)
    _log(f"  generation: {prefills} prefills, flash launches {fa_launches} "
         f"(= {N_LAYERS} layers × {prefills}), plain calls {fa_plain}; "
         f"{decodes} decode steps, decode attention launches {da_launches} "
         f"(= {N_LAYERS} × {decodes}), plain 0; the reloaded run generated "
         "the same token ids")

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
           "flat": first, "tokens": tokens_1, "common": common,
           "decode_launches": da_launches}
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
    kernel_ms = _queued_ms(torch, kernel, 10, 10)
    plain_ms = _queued_ms(torch, plain, 1, 5)
    library_ms = _queued_ms(torch, library, 10, 10)
    kernel_ms_2 = _queued_ms(torch, kernel, 10, 10)
    n, d = dv.shape
    w = ds.shape[1]
    nbytes = 4 * (n * d + n * w + BATCH * d + BATCH * w) + 8 * BATCH * TOP_K
    flops = 2 * BATCH * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the kernel's products: three TF32 products per f32 product
    ops_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    simt_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _log(f"  kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f} ms), plain "
         f"{plain_ms:.4f} ms, library torch.topk(α·q@docsᵀ+β·ind) "
         f"{library_ms:.4f} ms (containment precomputed); device time of "
         "calls queued back to back")
    _log(f"  bound {bound_ms:.4f} ms = max({nbytes / 1e9:.3f} GB / 3.35 TB/s "
         f"= {bytes_ms:.4f} ms, 3 × {flops / 1e9:.1f} GFLOP of 3×TF32 / "
         f"495 TFLOP/s = {ops_ms:.4f} ms); kernel at "
         f"{bound_ms / kernel_ms:.1%} of it (against the f32 SIMT bound of "
         f"the earlier design, {flops / 1e9:.1f} GFLOP / 67 TFLOP/s = "
         f"{simt_ms:.4f} ms: {simt_ms / kernel_ms:.1%})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_new_kernel_timings(torch, ops, ref, tk_ops, tk_ref):
    """Single-query HSF at the serving shape (f32) and top-k of a
    65,536-score vector at k = 16 (the single-query path's shapes), of
    the recsys retrieval shape (1,000,448 scores, the last 448 at -inf,
    k = 16), and of a 16,777,216-score vector: kernel, plain version, library
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
    for n, k, reps in ((N_DOCS, TOP_K, 50), (RETRIEVAL_PAD, TOP_K, 20),
                       (TOPK_LONG_N, TOP_K, 10), (TOPK_LONG_N, 128, 5)):
        scores = torch.randn(n, device="cuda", generator=gen)
        if n == RETRIEVAL_PAD:  # the recsys retrieval step's padding
            scores[RETRIEVAL_N:] = float("-inf")
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
             f"{again:.4f} ms; {tk_ops._lib().topk_kernels_for(n)} kernel "
             f"launch(es) a call), plain (stable sort) "
             f"{t['plain_ms']:.4f} ms, library torch.topk "
             f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
             f"({nbytes / 1e6:.2f} MB / 3.35 TB/s); kernel at "
             f"{t['bound_ms'] / t['ms']:.1%} of it, "
             f"{t['library_ms'] / t['ms']:.2f}× torch.topk's speed")
        out[(n, k)] = t
        del scores
    # what one plain read of the 16.8 M vector takes on this card, the
    # floor under the kernel's first pass; then the inputs whose ties put
    # every candidate in one bucket (whole-cluster passes over N keys)
    scores = torch.randn(TOPK_LONG_N, device="cuda", generator=gen)
    torch.sum(scores)
    read_ms = _queued_ms(torch, lambda: torch.sum(scores), 10, 10)
    _log(f"  one read of {TOPK_LONG_N} scores (torch.sum): {read_ms:.4f} ms, "
         f"{4 * TOPK_LONG_N / read_ms / 1e9:.2f} TB/s")
    for name, scores in (
            ("all equal", torch.full((TOPK_LONG_N,), 0.5, device="cuda")),
            ("five values", torch.randint(0, 5, (TOPK_LONG_N,), device="cuda",
                                          generator=gen).to(torch.float32))):
        kernel = lambda: tk_ops.top_k(scores, 128)  # noqa: E731
        library = lambda: torch.topk(scores, 128)  # noqa: E731
        kernel()
        library()
        _log(f"  top_k N={TOPK_LONG_N} k=128, {name}: kernel "
             f"{_queued_ms(torch, kernel, 2, 3):.4f} ms, library torch.topk "
             f"{_queued_ms(torch, library, 2, 3):.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 5: full-width cross-check, kernel against the blockwise path
# ---------------------------------------------------------------------------

def _served_model(torch, T, cfg):
    """The weights ``serve.py`` serves on the card (seed 0)."""
    return T.init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")


@contextlib.contextmanager
def _blockwise_block_k(block_k: int):
    """The blockwise path with kv blocks of ``block_k``: the same plain
    computation in another summation order (online-softmax rescaling
    at each block edge)."""
    import functools

    from repro_torch.models import attention as attn

    plain = attn.flash_attention_blockwise
    attn.flash_attention_blockwise = functools.partial(plain, block_k=block_k)
    try:
        yield
    finally:
        attn.flash_attention_blockwise = plain


def phase_cross_check(torch, T, model, cfg, lengths=(512, 389, 128, 17),
                      floor_block_k=None):
    """Last-position prefill logits through the flash kernel against the
    blockwise path, within LOGIT_REL_TOL of the largest |logit|.  With
    ``floor_block_k`` the blockwise path also runs with kv blocks of that
    size, and the kernel is held to the larger of LOGIT_REL_TOL and
    NOISE_FACTOR × that plain-against-plain difference (the bf16 noise
    floor of the model's depth).  Returns the largest kernel difference."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for length in lengths:
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
        tol, floor_note = LOGIT_REL_TOL, ""
        if floor_block_k is not None:
            with _blockwise_block_k(floor_block_k):
                alt = T.prefill(model, tokens, cfg, length,
                                backend="blockwise")[0][0, -1].float()
            floor = (alt - lb).abs().max().item() / scale
            tol = max(LOGIT_REL_TOL, NOISE_FACTOR * floor)
            floor_note = (f"; blockwise with kv blocks of {floor_block_k} "
                          f"vs 1,024 {floor:.3e}, so tol max("
                          f"{LOGIT_REL_TOL:g}, {NOISE_FACTOR:g} × floor)")
        assert rel <= tol, (length, rel, tol)
        # each argmax lies in the other's near-tie group
        tie = tol * scale
        ak, ab = int(lk.argmax()), int(lb.argmax())
        assert lb[ak] >= lb.max() - tie and lk[ab] >= lk.max() - tie, \
            (length, ak, ab)
        worst = max(worst, rel)
        _log(f"  L={length:4d}: max |Δlogit| / max |logit| {rel:.3e} "
             f"(tol {tol:.3g}{floor_note}), argmax kernel {ak} blockwise "
             f"{ab}")
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


def _kernel_rows(prof, calls):
    """(device µs per call, launches per call, name) of every kernel and
    copy a ``torch.profiler`` run recorded (operators are left out:
    their kernels count)."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / calls, ev.count // calls, ev.key))
    return rows


def _profile(torch, fn, wall_ms, label, mark="flash_fwd",
             mark_name="flash kernel", calls=1):
    """Device time by kernel over ``calls`` calls of ``fn``
    (torch.profiler), against the CUDA-event wall time of one call
    ``wall_ms``; the kernels whose name holds ``mark`` are summed as
    ``mark_name``.  Times are per call.  Returns the device's idle
    share, or None when no kernel time was recorded."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, calls)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms == 0:
        _log(f"  profiler, {label}: no kernel time recorded (not measured)")
        return None
    rows.sort(reverse=True)
    marked_ms = sum(r[0] for r in rows if mark in r[2]) / 1e3
    _log(f"  profiler, {label}: kernels {busy_ms:.3f} ms of {wall_ms:.3f} ms "
         f"wall (device idle {1 - busy_ms / wall_ms:.1%}); {mark_name} "
         f"{marked_ms:.3f} ms ({marked_ms / busy_ms:.1%} of kernel time)")
    for dev_us, count, key in rows[:6]:
        _log(f"    {dev_us / 1e3:9.3f} ms {dev_us / 1e3 / busy_ms:6.1%} "
             f"x{count:<4d} {key[:80]}")
    return 1 - busy_ms / wall_ms


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
    single, from_map, score_vectors = [], [], []
    for i in range(len(queries)):
        scores = hsf.hsf_scores_kernel(dv, ds, qv[i], qs[i], ALPHA, BETA)
        map_scores = hsf.hsf_scores(dv, ds, qv[i], qs[i], ALPHA, BETA)
        single.append(tk_ops.top_k(scores, TOP_K))
        from_map.append(tk_ops.top_k(map_scores, TOP_K))
        score_vectors += [scores, map_scores]
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
    # the path's top_k launches again, on the same vectors, timed (after
    # the counts were read)
    total_ms = _queued_ms(torch, lambda: [tk_ops.top_k(x, TOP_K)
                                          for x in score_vectors], 1, 5)
    _log(f"  (f) its {len(score_vectors)} top_k calls: {total_ms:.4f} ms of "
         f"device time, {total_ms / len(score_vectors) * 1e3:.2f} us each "
         f"(the earlier k-round design's 0.0246 ms a call: "
         f"{len(score_vectors) * 0.0246:.2f} ms)")
    return score_launches, topk_launches


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def _compact_on_cpu(torch, np, params, cfg, sparse):
    """The rows a batch touches, as a compact CPU model: each field's
    distinct ids become its whole vocabulary.  Returns (params, config,
    remapped ids) for the same forward on the host."""
    import dataclasses

    offsets = np.concatenate([[0], np.cumsum(cfg.vocab_sizes[:-1])])
    rows, counts = [], []
    remapped = np.empty_like(sparse)
    for f in range(sparse.shape[1]):
        uniq, inv = np.unique(sparse[:, f], return_inverse=True)
        remapped[:, f] = inv.reshape(-1)
        counts.append(len(uniq))
        rows.append(uniq.astype(np.int64) + offsets[f])
    rows = torch.from_numpy(np.concatenate(rows)).cuda()
    out = _to_cpu({k: v for k, v in params.items()
                   if k not in ("table", "first_order")})
    for k in ("table", "first_order"):
        if k in params:
            out[k] = params[k][rows].cpu()
    return (out, dataclasses.replace(cfg, vocab_sizes=tuple(counts)),
            remapped)


def _recsys_serve(torch, np, arch, mod, params, cfg, steps, pipeline):
    """(a) ``make_recsys_step(kind="recsys_serve")`` at serve_p99 and
    serve_bulk: finite logits; the serve_p99 batch again on the CPU
    through the rows it touches.  Returns {batch: device batch}."""
    step = steps.make_recsys_step(arch, cfg, "recsys_serve")
    cursor = pipeline.DataCursor(seed=0)
    batches = {}
    for b in (SERVE_P99, SERVE_BULK):
        dense, sparse, _ = pipeline.recsys_batch(cursor, b, cfg.vocab_sizes,
                                                 cfg.n_dense)
        t0 = time.perf_counter()
        logits = step(params, {"dense": dense, "sparse_idx": sparse})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        assert logits.shape == (b,) and logits.dtype == torch.float32, arch
        assert torch.isfinite(logits).all(), arch
        _log(f"  {arch} serve batch {b}: logits finite, mean "
             f"{logits.mean().item():+.4f}, std {logits.std().item():.4f} "
             f"(first call {first_s:.3f} s)")
        batches[b] = {"dense": None if dense is None
                      else torch.from_numpy(dense).cuda(),
                      "sparse_idx": torch.from_numpy(sparse).cuda(),
                      "sparse_np": sparse, "dense_np": dense,
                      "logits": logits}
    p99 = batches[SERVE_P99]
    cpu_params, cpu_cfg, remapped = _compact_on_cpu(
        torch, np, params, cfg, p99["sparse_np"])
    want = mod.forward(cpu_params, None if p99["dense_np"] is None
                       else torch.from_numpy(p99["dense_np"]),
                       torch.from_numpy(remapped), cpu_cfg)
    got = p99["logits"].cpu()
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= RECSYS_TOL * scale, (arch, err, scale)
    _log(f"  {arch} serve batch {SERVE_P99}: card logits == CPU logits of "
         f"the same rows ({cpu_params['table'].shape[0]:,} distinct rows) "
         f"within {RECSYS_TOL:g} × {scale:.3f}: max |Δ| {err:.3e}")
    return batches


def _recsys_timings(torch, arch, params, cfg, steps, batches):
    """Forward ms per batch (CUDA events around the step, inputs already
    on the card) and samples/s at both batches."""
    step = steps.make_recsys_step(arch, cfg, "recsys_serve")
    out = {}
    for b, batch in batches.items():
        inputs = {"dense": batch["dense"], "sparse_idx": batch["sparse_idx"]}
        step(params, inputs)
        torch.cuda.synchronize()
        ms = _median_ms(torch, lambda: step(params, inputs),
                        20 if b == SERVE_P99 else 5)
        out[b] = ms
        _log(f"  {arch} forward batch {b}: {ms:.4f} ms "
             f"({b / ms * 1e3:,.0f} samples/s; CUDA events, median)")
    return out


def _time_bag(torch, F, bag_ops, bag_ref, table, flat, seg, b):
    """embedding_bag at one served batch as bags: the kernel alone on its
    prepared operands, the sort and offsets alone, the whole wrapper,
    the plain version and ``F.embedding_bag`` on the sorted ids, as
    device time of calls queued back to back; and the bound."""
    idx, w, offsets = bag_ops.prepare(flat, seg, b)
    offsets32 = offsets.to(torch.int32)
    kernel = lambda: bag_ops.launch(table, idx, w, offsets)  # noqa: E731
    prep = lambda: bag_ops.prepare(flat, seg, b)  # noqa: E731
    wrapper = lambda: bag_ops.embedding_bag(table, flat, seg, b)  # noqa: E731
    plain = lambda: bag_ref.embedding_bag_ref(table, flat, seg, b)  # noqa: E731
    library = lambda: F.embedding_bag(  # noqa: E731
        idx, table, offsets32, mode="sum", include_last_offset=True)
    torch.testing.assert_close(library(), kernel(), rtol=1e-5, atol=1e-5)
    for fn in (kernel, prep, wrapper, plain, library):
        fn()
    torch.cuda.synchronize()
    reps = 50 if b == SERVE_P99 else 5
    t = {"ms": _queued_ms(torch, kernel, reps, 10),
         "prepare_ms": _queued_ms(torch, prep, reps, 10),
         "wrapper_ms": _queued_ms(torch, wrapper, reps, 10),
         "plain_ms": _queued_ms(torch, plain, reps, 5),
         "library_ms": _queued_ms(torch, library, reps, 10)}
    again = _queued_ms(torch, kernel, reps, 10)
    n, e = flat.shape[0], table.shape[1]
    distinct = torch.unique(flat).numel()
    nbytes = distinct * e * 4 + n * 8 + b * e * 4  # rows, idx + seg, out
    flops = 2 * n * e
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    t.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    _log(f"  embedding_bag batch {b} (n={n:,}, {distinct:,} distinct rows): "
         f"kernel {t['ms']:.4f} ms (again {again:.4f}), sort + offsets "
         f"{t['prepare_ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, plain "
         f"{t['plain_ms']:.4f} ms, library F.embedding_bag "
         f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
         f"({nbytes / 1e6:.1f} MB / 3.35 TB/s) by {t['bound_by']}; kernel at "
         f"{t['bound_ms'] / t['ms']:.1%} of it, "
         f"{nbytes / t['ms'] / 1e9:.2f} TB/s")
    return t


def phase_recsys(torch, np, bag_ops, bag_ref, tk_ops, tk_ref):
    """(a) dlrm-rm2 FULL served at serve_p99 and serve_bulk, checked on
    the CPU; (b) the EmbeddingBag path, ``lookup_bags(use_kernel=True)``
    over the served table, counted; (c) retrieval of 1,000,000
    candidates through the top-k kernel; (d) timings; then deepfm and
    autoint FULL served, checked and timed.  Returns (bag launches,
    bag timings at serve_bulk and at serve_p99)."""
    import torch.nn.functional as F

    from repro_torch.configs import get as get_arch
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models.recsys import autoint, deepfm, dlrm
    from repro_torch.models.recsys import embedding as emb

    torch.cuda.empty_cache()
    _log(f"  peak device memory over phases 1-7: "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("dlrm-rm2").config
    t0 = time.perf_counter()
    params = dlrm.init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    table = params["table"]
    _log(f"  (a) dlrm-rm2 FULL init: table {tuple(table.shape)} f32 "
         f"({table.numel() * 4 / 1e9:.2f} GB) and towers in "
         f"{time.perf_counter() - t0:.2f} s; "
         f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    batches = _recsys_serve(torch, np, "dlrm-rm2", dlrm, params, cfg, steps,
                            pipeline)

    # (b) the kernel's path: counts zeroed just before, read just after
    offs = emb.cached_offsets(cfg.vocab_sizes, table.device)
    f = cfg.n_sparse
    bag_inputs = {}
    for b, batch in batches.items():
        bag_inputs[b] = (batch["sparse_idx"].reshape(-1),
                         torch.arange(f, device="cuda").repeat(b),
                         torch.arange(b, device="cuda").repeat_interleave(f))
    bag_ops.reset_counts()
    bags = {b: emb.lookup_bags(table, offs, idx, field, bag, b,
                               use_kernel=True)
            for b, (idx, field, bag) in bag_inputs.items()}
    torch.cuda.synchronize()
    bag_launches, bag_plain = bag_ops.counts["launches"], bag_ops.counts["plain"]
    assert (bag_launches, bag_plain) == (len(bags), 0), bag_ops.counts
    for b, got in bags.items():
        want = emb.lookup(table, offs, batches[b]["sparse_idx"]).sum(1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=f"lookup_bags at {b}")
        _log(f"  (b) lookup_bags(use_kernel=True) batch {b}: == "
             f"lookup(...).sum(1) within 1e-5 (max |Δ| "
             f"{(got - want).abs().max().item():.3e})")
    _log(f"  (b) embedding_bag launches {bag_launches} = lookup_bags calls "
         f"{len(bags)}, plain calls {bag_plain}")
    del bags

    # (c) retrieval: 1,000,000 candidates padded to 1,000,448 (-inf)
    gen = torch.Generator(device="cuda").manual_seed(9)
    cand = torch.zeros(RETRIEVAL_PAD, device="cuda", dtype=torch.int32)
    cand[:RETRIEVAL_N] = torch.randint(0, cfg.vocab_sizes[0], (RETRIEVAL_N,),
                                       device="cuda", generator=gen,
                                       dtype=torch.int32)
    query = torch.randn(1, cfg.n_dense, device="cuda", generator=gen)
    rbatch = {"query": query, "candidate_ids": cand,
              "n_real_candidates": RETRIEVAL_N}
    retrieve = steps.make_recsys_step("dlrm-rm2", cfg, "recsys_retrieval")
    tk_ops.reset_counts()
    vals, ids = retrieve(params, rbatch)
    torch.cuda.synchronize()
    topk_launches = tk_ops.counts["launches"]
    assert topk_launches == 1, tk_ops.counts
    scores = dlrm.retrieval_scores(params, query, cand, cfg)
    pos = torch.arange(RETRIEVAL_PAD, device="cuda")
    scores = scores.masked_fill(pos >= RETRIEVAL_N, float("-inf"))
    pv, pi = tk_ref.top_k_ref(scores, 16)
    assert torch.equal(ids, pi) and torch.equal(vals, pv), \
        (ids.tolist(), pi.tolist())
    assert (ids < RETRIEVAL_N).all(), ids.tolist()
    q_cpu = layers.dense_mlp_apply(_to_cpu(params["bot"]), query.cpu(),
                                        len(cfg.bot_mlp), True)[0]
    want = table[cand[ids.long()].long()].cpu() @ q_cpu
    err = (vals.cpu() - want).abs().max().item()
    assert err <= RECSYS_TOL * max(1.0, want.abs().max().item()), err
    retrieval_ms = _median_ms(torch, lambda: retrieve(params, rbatch), 10)
    _log(f"  (c) retrieval of {RETRIEVAL_N:,} candidates (padded to "
         f"{RETRIEVAL_PAD:,}, padding at -inf): top_k launches "
         f"{topk_launches}; ids and values equal the plain top-k's; the top "
         f"16 scores equal the CPU's within {RECSYS_TOL:g} (max |Δ| "
         f"{err:.3e}); step {retrieval_ms:.4f} ms (CUDA events, median; "
         "1.178 ms with the earlier k-round top-k)")
    _sharded_lookup(torch, emb, dlrm, params, cfg, batches[SERVE_P99], query,
                    cand)

    # (d) timings
    bag_timing = {b: _time_bag(torch, F, bag_ops, bag_ref, table,
                               *_serve_bags(torch, batches[b]["sparse_np"],
                                            offs), b)
                  for b in (SERVE_P99, SERVE_BULK)}
    forward_ms = {"dlrm-rm2": _recsys_timings(torch, "dlrm-rm2", params, cfg,
                                              steps, batches)}
    step = steps.make_recsys_step("dlrm-rm2", cfg, "recsys_serve")
    for b in (SERVE_P99, SERVE_BULK):
        inputs = {"dense": batches[b]["dense"],
                  "sparse_idx": batches[b]["sparse_idx"]}
        _profile(torch, lambda: step(params, inputs),
                 forward_ms["dlrm-rm2"][b],
                 f"one dlrm-rm2 serve step at batch {b}", "gather",
                 "row gathers (index_select)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, table, batches, bag_inputs, scores, cand
    torch.cuda.empty_cache()

    for arch, mod in (("deepfm", deepfm), ("autoint", autoint)):
        cfg = get_arch(arch).config
        t0 = time.perf_counter()
        params = mod.init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        _log(f"  (a) {arch} FULL init: table "
             f"{tuple(params['table'].shape)} f32 "
             f"({params['table'].numel() * 4 / 1e9:.2f} GB) in "
             f"{time.perf_counter() - t0:.2f} s")
        batches = _recsys_serve(torch, np, arch, mod, params, cfg, steps,
                                pipeline)
        forward_ms[arch] = _recsys_timings(torch, arch, params, cfg, steps,
                                           batches)
        del params, batches
        torch.cuda.empty_cache()
    _log(f"  peak device memory in phase 8: {peak:.2f} GB "
         "(torch.cuda.max_memory_allocated)")
    return bag_launches, bag_timing, forward_ms


# ---------------------------------------------------------------------------
# phase 9: the compiled serving steps (CUDA graphs of launch/steps.py)
# ---------------------------------------------------------------------------

# the reference's LM cells (configs/shapes.py), cut only where one card
# forces it: prefill_32k to batch 1 (each sequence's activations and
# cache), decode_32k to batch 8 (128 sequences' cache is 481 GB);
# long_500k whole when it fits, else its seq halved
LM_CELLS = ((ARCH, "prefill_32k", {"batch": 1}, 3),
            (ARCH, "decode_32k", {"batch": 8}, 5),
            (ARCH, "long_500k", {}, 5),
            # the window masking inside the Dh 256 kernel at full width,
            # and the absorbed decode over a 32,768-slot latent cache at
            # the largest batch that fits (halved from 128)
            ("gemma2-9b", "prefill_32k", {"batch": 1}, 1),
            ("deepseek-v2-lite-16b", "decode_32k", {}, 5))
RECSYS_CELLS = (("dlrm-rm2", ("serve_p99", "serve_bulk", "retrieval_cand")),
                ("deepfm", ("serve_p99", "serve_bulk")),
                ("autoint", ("serve_p99", "serve_bulk")))
DIGEST_CHUNK = 4_096  # cache slots summed at a time by _cache_digest


def _clone(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(torch, v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _same_bits(torch, a, b) -> bool:
    """Tensors (in dicts, lists and tuples) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(torch, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8),
            b.contiguous().view(torch.uint8)))
    return a == b


def _cache_digest(torch, caches) -> list[int]:
    """Per layer and tensor, the exact sum of the cache's bit patterns
    (as int16): a cache too large to copy is compared by these."""
    from repro_torch.models.transformer import slots_view

    sums = []
    for layer in caches:
        for t in layer.values():
            bits = slots_view(t).view(torch.int16)
            acc = torch.zeros((), dtype=torch.int64, device=bits.device)
            for lo in range(0, bits.shape[2], DIGEST_CHUNK):
                acc += bits[:, :, lo:lo + DIGEST_CHUNK].sum(dtype=torch.int64)
            sums.append(acc)
    return torch.stack(sums).tolist()


def _in_turns(torch, eager, replay, runs):
    """CUDA-event medians, eager and replay in turns (eager, replay,
    replay, eager); returns (eager ms, replay ms, both pairs)."""
    e1 = _median_ms(torch, eager, runs)
    r1 = _median_ms(torch, replay, runs)
    r2 = _median_ms(torch, replay, runs)
    e2 = _median_ms(torch, eager, runs)
    return min(e1, e2), min(r1, r2), (e1, r1, r2, e2)


def _prompt(rag, results, question):
    """The prompt ``RAGPipeline.generate`` packs."""
    from repro_torch.core.rag import text_to_tokens

    prompt = rag._pack_context(results) + text_to_tokens(question,
                                                         rag.cfg.vocab)
    return prompt[-rag.max_context_tokens:] or [0]


def _eager_tokens(torch, T, steps, model, cfg, gs, prompt, static):
    """Greedy tokens, eagerly: through the static-shape steps into a cache
    of its own (``static``), or through the unpadded ``T.prefill`` with
    a cache of len(prompt) + MAX_NEW_TOKENS slots."""
    n = len(prompt)
    if static:
        caches = T.init_cache(cfg, 1, gs.max_len, device="cuda")
        bucket = gs.bucket(n)
        tokens = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
        tokens[0, :n] = torch.tensor(prompt)
        logits, _, _ = steps.make_lm_prefill_step(cfg, gs.max_len)(
            model, tokens, torch.tensor([n], dtype=torch.int32,
                                        device="cuda"), caches)
        nxt = int(torch.argmax(logits[0]))
    else:
        tokens = torch.tensor([prompt], dtype=torch.int64, device="cuda")
        logits, caches, _ = T.prefill(model, tokens, cfg,
                                      n + MAX_NEW_TOKENS)
        nxt = int(torch.argmax(logits[0, -1]))
    out = []
    for _ in range(MAX_NEW_TOKENS):
        out.append(nxt)
        n += 1
        logits, caches = T.decode_step(
            model, caches, torch.tensor([[nxt]], device="cuda"),
            torch.tensor([n], dtype=torch.int32, device="cuda"), cfg)
        nxt = int(torch.argmax(logits[0, 0]))
    return out


def phase_compiled_generation(torch, T, steps, fa_ops, cfg, model, ctx):
    """(a) ``RAGPipeline.generate``'s steps at the serving shape: each
    prompt bucket's replay, two prompts through one graph, and the
    decode replay, each bit for bit against the eager static-shape step
    (logits and the whole cache); phase 3's queries retrieved again and
    generated through the graphs (their ids, scores and token ids, and
    the eager steps' tokens); flash launches per prefill replay; prefill
    and decode timed eager against replay, with the device's idle share.
    Returns the timings."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.core.rag import RAGPipeline

    kb = KnowledgeBase.load(ctx["container"])
    rag = RAGPipeline(kb, model, cfg, engine=QueryEngine(kb, device="cuda"))
    gs = rag.generation_steps(MAX_NEW_TOKENS)
    prefill = steps.make_lm_prefill_step(cfg, gs.max_len)
    decode = steps.make_lm_decode_step(cfg)
    eager_caches = T.init_cache(cfg, 1, gs.max_len, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)

    def prompt_of(n, bucket):
        tokens = torch.randint(0, cfg.vocab, (1, bucket), device="cuda",
                               generator=gen)
        tokens[:, n:] = 0
        return tokens, torch.tensor([n], dtype=torch.int32, device="cuda")

    buckets = gs.buckets()
    for bucket in buckets:
        step = gs.prefill(bucket)
        for n in (bucket, bucket // 2 + 1):  # two prompts, one graph
            tokens, length = prompt_of(n, bucket)
            want = _clone(torch, prefill(model, tokens, length,
                                         eager_caches)[0])
            if not step.captured:
                step.capture(tokens, length)
            got = step(tokens, length)[0]
            assert _same_bits(torch, got, want), (bucket, n, "logits")
            assert _same_bits(torch, gs.caches, eager_caches), (bucket, n)
    for i in range(2):  # two tokens through the decode graph
        tok = torch.randint(0, cfg.vocab, (1, 1), device="cuda",
                            generator=gen)
        length = torch.tensor([buckets[-1] // 2 + 2 + i], dtype=torch.int32,
                              device="cuda")
        want = _clone(torch, decode(model, eager_caches, tok, length)[0])
        if not gs.decode.captured:
            gs.decode.capture(tok, length)
        got = gs.decode(tok, length)[0]
        assert _same_bits(torch, got, want), ("decode", i)
        assert _same_bits(torch, gs.caches, eager_caches), ("decode", i)
    _log(f"  (a) prompt buckets {buckets}: each replay equals the eager "
         "static-shape prefill bit for bit (logits and the whole "
         f"{gs.max_len}-slot cache), two prompts per graph; the decode "
         "replay likewise for two tokens; "
         f"{gs.captures} graphs captured in {gs.capture_s:.2f} s")

    # phase 3's requests again: retrieval, then generation through graphs
    queries = ctx["queries"][:2] + ctx["queries"][-2:]
    served = rag.engine.query_batch(queries, k=TOP_K)
    unpadded_same = 0
    for q, results in zip(queries, served):
        assert [(r.doc_id, r.boosted, f"{r.score:.4f}") for r in results] \
            == ctx["flat"][q], q
        out = rag.generate(q, results, MAX_NEW_TOKENS)
        prompt = _prompt(rag, results, q)
        assert out.token_ids == ctx["tokens"][q], (q, out.token_ids)
        eager = _eager_tokens(torch, T, steps, model, cfg, gs, prompt, True)
        assert out.token_ids == eager, (q, out.token_ids, eager)
        unpadded_same += out.token_ids == _eager_tokens(
            torch, T, steps, model, cfg, gs, prompt, False)
    _log(f"  (a) {len(queries)} of phase 3's requests: ids and scores equal "
         f"phase 3's; {MAX_NEW_TOKENS} greedy tokens through the graphs equal "
         "phase 3's and the eager static-shape steps'; the unpadded eager "
         f"path (T.prefill over the prompt alone) gives the same tokens for "
         f"{unpadded_same} of {len(queries)}")

    # flash launches per prefill replay, then timings at the 512 bucket
    bucket = buckets[-1]
    step = gs.prefill(bucket)
    tokens, plen = prompt_of(bucket, bucket)
    reps = 5
    fa_ops.reset_counts()
    for _ in range(reps):
        step(tokens, plen)
    torch.cuda.synchronize()
    assert fa_ops.counts == {"launches": N_LAYERS * reps, "plain": 0}, \
        fa_ops.counts
    _log(f"  (a) flash launches over {reps} prefill replays: "
         f"{fa_ops.counts['launches']} (= {N_LAYERS} a replay), plain 0")
    tok = torch.randint(0, cfg.vocab, (1, 1), device="cuda", generator=gen)
    dlen = plen + 1
    out = {}
    for name, eager, replay, runs in (
            ("prefill", lambda: prefill(model, tokens, plen, eager_caches),
             lambda: step(tokens, plen), 10),
            ("decode", lambda: decode(model, eager_caches, tok, dlen),
             lambda: gs.decode(tok, dlen), 20)):
        eager_ms, replay_ms, pairs = _in_turns(torch, eager, replay, runs)
        _log(f"  (a) {name} at the {bucket}-token bucket: eager "
             f"{eager_ms:.3f} ms, replay {replay_ms:.3f} ms (CUDA events, "
             f"median of {runs}, in turns "
             f"{', '.join(f'{t:.3f}' for t in pairs)})")
        out[name] = (eager_ms, replay_ms,
                     _profile(torch, eager, eager_ms, f"eager {name} step",
                              calls=5),
                     _profile(torch, replay, replay_ms,
                              f"replayed {name} step", calls=5))
    return out


def _lm_cell_fits(torch, cfg, b, s):
    """Whether a decode cell of batch b and s slots fits the free memory:
    the weights, the cache, and twice (the eager pass's pool and the
    graph's) the decode attention's largest transient.  GQA: one layer's
    K (or V) in f32 with its copy broadcast over the G query heads of a
    group (llama's decode_32k at batch 8: reckoned 45.08 GB, and 45.16
    GB measured by phase 9 on an H100).  MLA (absorbed, products in f32
    from bf16 operands): four [B, H, S] f32 score tensors."""
    if cfg.mla is None:
        elems = b * cfg.n_kv_heads * s * cfg.head_dim  # one layer's K
        group = cfg.n_heads // cfg.n_kv_heads
        cache = 2 * 2 * cfg.n_layers * elems
        transient = (1 + group) * 4 * elems
    else:
        m = cfg.mla
        cache = 2 * cfg.n_layers * b * s * (m.kv_lora_rank + m.rope_head_dim)
        transient = 4 * 4 * b * cfg.n_heads * s
    need = 2 * cfg.param_count() + cache + 2 * transient
    free = torch.cuda.mem_get_info()[0]
    _log(f"  {cfg.name}: {s:,}-slot cache at batch {b}: needs about "
         f"{need / 1e9:.1f} GB, {free / 1e9:.1f} GB free")
    return need * 1.02 < free


def phase_compiled_lm_cells(torch, steps, fa_ops):
    """(b) the LM cells of ``LM_CELLS``: captured, replayed, bit for bit
    against the eager step, flash launches per prefill replay, eager and
    replay timed, peak memory.  A decode cell without a batch is cut to
    the largest that fits (halved from the reference's), then its seq
    halved if even that does not.  Returns {(arch, shape): (eager ms,
    replay ms, eager idle, replay idle)}."""
    from repro_torch.configs import get as get_arch
    from repro_torch.configs.shapes import LM_SHAPES
    from repro_torch.models.transformer import slots_view

    out = {}
    for arch, shape_id, cuts, runs in LM_CELLS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_arch(arch).config
        kind = LM_SHAPES[shape_id].kind
        if kind == "lm_decode":
            m = LM_SHAPES[shape_id].meta
            b, s = cuts.get("batch", m["batch"]), m["seq"]
            while "batch" not in cuts and b > 1 \
                    and not _lm_cell_fits(torch, cfg, b, s):
                b //= 2
            while not _lm_cell_fits(torch, cfg, b, s):
                s //= 2
            cuts = {**cuts, **({"batch": b} if b != m["batch"] else {}),
                    **({"seq": s} if s != m["seq"] else {})}
        t0 = time.perf_counter()
        cell = steps.build_cell(arch, shape_id, device="cuda", **cuts)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        step = cell.fn
        if kind == "lm_prefill":
            _, tokens, _, caches = cell.args
            want = _clone(torch, step.fn(*cell.args))
            step.capture()
            fa_ops.reset_counts()
            got = step()
            torch.cuda.synchronize()
            assert fa_ops.counts == {"launches": cfg.n_layers,
                                     "plain": 0}, fa_ops.counts
            assert _same_bits(torch, got[0], want[0]), shape_id
            assert _same_bits(torch, caches, want[1]), shape_id
            del want
            checked = (f"logits and the whole cache bit for bit; flash "
                       f"launches {cfg.n_layers} a replay, plain 0")
            what = f"prefill of {tokens.shape[1]:,} tokens"
        else:
            _, caches, tokens, lengths = cell.args
            slot = cell.meta["max_len"] - 1  # the slot the step writes

            def written():
                return [{n: slots_view(t)[:, :, slot].clone()
                         for n, t in c.items()} for c in caches]

            before = written()

            def restore():
                for c, w in zip(caches, before):
                    for n, t in c.items():
                        slots_view(t)[:, :, slot] = w[n]

            want = step.fn(*cell.args)[0].clone()
            want_slot, want_digest = written(), _cache_digest(torch, caches)
            restore()
            step.capture()
            restore()
            got = step()[0]
            assert _same_bits(torch, got, want), shape_id
            assert _same_bits(torch, written(), want_slot), shape_id
            assert _cache_digest(torch, caches) == want_digest, shape_id
            checked = ("logits and the written slot bit for bit, the whole "
                       "cache's bit sums equal")
            what = (f"decode at batch {tokens.shape[0]}, "
                    f"{cell.meta['max_len']:,}-slot cache")
        eager_ms, replay_ms, pairs = _in_turns(
            torch, lambda: step.fn(*cell.args), step, runs)
        idle = (_profile(torch, lambda: step.fn(*cell.args), eager_ms,
                         f"eager {arch} {shape_id}"),
                _profile(torch, step, replay_ms,
                         f"replayed {arch} {shape_id}"))
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[(arch, shape_id)] = (eager_ms, replay_ms) + idle
        _log(f"  (b) {arch} {shape_id} ({what}; reduced: "
             f"{cell.meta['reduced'] or 'none'}; built in {build_s:.1f} s, "
             f"captured in {step.capture_s:.2f} s): {checked}; eager "
             f"{eager_ms:.3f} ms, replay {replay_ms:.3f} ms (CUDA events, "
             f"median of {runs}, in turns "
             f"{', '.join(f'{t:.3f}' for t in pairs)}); peak "
             f"{peak:.2f} GB")
        del cell, step, caches, tokens
    torch.cuda.empty_cache()
    return out


def phase_compiled_recsys_cells(torch, steps, tk_ops):
    """(c) the recsys serve and retrieval cells at full width: captured,
    replayed, bit for bit against the eager step, a second input
    through the same buffers, top_k launches per retrieval replay,
    eager and replay timed, peak memory.  Returns {(arch, shape):
    (eager ms, replay ms, eager idle, replay idle)}."""
    out = {}
    for arch, shape_ids in RECSYS_CELLS:
        for shape_id in shape_ids:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cell = steps.build_cell(arch, shape_id, device="cuda")
            step = cell.fn
            params, inputs = cell.args
            retrieval = cell.meta["kind"] == "recsys_retrieval"
            want = _clone(torch, step.fn(*cell.args))
            step.capture()
            tk_ops.reset_counts()
            got = step()
            torch.cuda.synchronize()
            assert tk_ops.counts["launches"] == int(retrieval), tk_ops.counts
            assert _same_bits(torch, got, want), (arch, shape_id)
            other = {k: torch.roll(v, 1, 0) if isinstance(v, torch.Tensor)
                     else v for k, v in inputs.items()}
            want = _clone(torch, step.fn(params, other))
            assert _same_bits(torch, step(params, other), want), \
                (arch, shape_id, "second input")
            runs = 20 if shape_id != "serve_bulk" else 5
            eager_ms, replay_ms, pairs = _in_turns(
                torch, lambda: step.fn(*cell.args), step, runs)
            idle = (None, None)
            if shape_id != "serve_bulk":
                idle = (_profile(torch, lambda: step.fn(*cell.args),
                                 eager_ms, f"eager {arch} {shape_id}",
                                 "gather", "row gathers", calls=10),
                        _profile(torch, step, replay_ms,
                                 f"replayed {arch} {shape_id}", "gather",
                                 "row gathers", calls=10))
            out[(arch, shape_id)] = (eager_ms, replay_ms) + idle
            _log(f"  (c) {arch} {shape_id}: replay == eager bit for bit, a "
                 f"second input too; top_k launches a replay "
                 f"{int(retrieval)}; eager {eager_ms:.4f} ms, replay "
                 f"{replay_ms:.4f} ms (median of {runs}, in turns "
                 f"{', '.join(f'{t:.4f}' for t in pairs)}); captured in "
                 f"{step.capture_s:.2f} s; peak "
                 f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del cell, step, params, inputs, want, got, other
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: the tenancy plane at full width
# ---------------------------------------------------------------------------

# 64 per-user containers at configs/ragdb.py FULL widths (dim 4,096, 128
# signature words): 8,192 shared docs and 16 that only the tenant holds;
# eight resident at once, 8 × 138.7 MB, the bytes of phase 3's serving
# shape
N_TENANTS, TENANT_BASE_DOCS, TENANT_OWN_DOCS = 64, 8_192, 16
MT_RESIDENT, MT_CLIENTS, MT_REQUESTS, MT_SKEW = 8, 16, 2_048, 1.1
MT_SERVE_S = 90.0  # leg A issues no request after this; the cut is printed
MT_LEAK_BYTES = 16 << 20


def _tenant(i: int) -> str:
    return f"tenant{i:02d}"


def _own_code(i: int, j: int) -> str:
    return f"T{i:02d}-ENTITY-{j:02d}"


def _own_doc(i: int, j: int) -> str:
    return f"t{i:02d}_own_{j:02d}.txt"


def _tenant_fleet(tmp):
    """The base corpus ingested once on the host and saved; its
    container copied to every tenant; then, per tenant, a host-side
    writer session (no pool, no card) adds the docs only that tenant
    holds and appends them durably to its journal.  Returns (root,
    corpus dir, entity codes, topical queries, container generation by
    tenant)."""
    import shutil

    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.data.corpus import make_corpus, write_corpus_dir

    t0 = time.perf_counter()
    docs, entities = make_corpus(n_docs=TENANT_BASE_DOCS, n_entities=64,
                                 seed=1)
    corpus = Path(tmp) / "mt_corpus"
    write_corpus_dir(str(corpus), docs)
    kb = KnowledgeBase(dim=DIM)
    kb.sync(str(corpus))
    base = Path(tmp) / "mt_base.ragdb"
    # saved without the dense matrix: every tenant's journal adds docs,
    # so each mount re-vectorizes from the term counts anyway
    kb.save(str(base), include_matrix=False)
    t1 = time.perf_counter()
    root = Path(tmp) / "mt_tenants"
    root.mkdir()
    gens = {}
    for i in range(N_TENANTS):
        path = str(root / f"{_tenant(i)}.ragdb")
        shutil.copyfile(base, path)
        writer = KnowledgeBase.load(path)
        for j in range(TENANT_OWN_DOCS):
            writer.add_text(_own_doc(i, j),
                            f"{_own_code(i, j)} private record of "
                            f"{_tenant(i)}, entry {j} of its own ledger")
        gens[_tenant(i)] = writer.save_delta(path)
    words = ["invoice", "server", "latency", "budget", "replication",
             "audit", "schema", "revenue"]
    topical = [f"{a} {b} report" for a in words for b in words
               if a != b][:32]
    _log(f"  fleet: base corpus {TENANT_BASE_DOCS} docs ingested and saved "
         f"in {t1 - t0:.1f} s ({base.stat().st_size / 1e6:.1f} MB without "
         f"the matrix); {N_TENANTS} copies, each with {TENANT_OWN_DOCS} own "
         f"docs appended to its journal, in {time.perf_counter() - t1:.1f} s")
    return root, corpus, entities, topical, gens


def _mt_runtime(root, *, quotas=None, cache=0, **pool_kw):
    """A pool over ``root`` with its own metrics registry, and a runtime
    over it (64-request flushes, 2 ms deadline)."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving import ServingRuntime
    from repro_torch.tenancy import ContainerPool

    reg = MetricsRegistry()
    pool = ContainerPool(str(root), registry=reg, **pool_kw)
    rt = ServingRuntime(pool=pool, quotas=quotas, max_batch=BATCH,
                        flush_deadline=0.002, result_cache_size=cache)
    return pool, rt, reg


def _watch_pins(pool) -> list:
    """The resident count after every pin returns (the flush thread pins
    each tenant group of a flush)."""
    counts = []
    real = pool.pin

    def pin(tenant):
        mt = real(tenant)
        counts.append(len(pool.resident_tenants()))
        return mt
    pool.pin = pin
    return counts


def _closed_loop(rt, reqs, clients, deadline_s):
    """``clients`` threads, each submitting the next of ``reqs`` (tenant,
    query) and waiting for it, until the list ends or ``deadline_s``
    passes.  Returns ([(tenant, query, ServedResult, seconds)], wall s)."""
    import threading

    lock = threading.Lock()
    state = {"next": 0}
    out, errors = [], []
    t0 = time.perf_counter()

    def client():
        while True:
            with lock:
                i = state["next"]
                if i >= len(reqs) or time.perf_counter() - t0 > deadline_s:
                    return
                state["next"] = i + 1
            tenant, q = reqs[i]
            ts = time.perf_counter()
            try:
                served = rt.submit(q, k=TOP_K, tenant=tenant).result(
                    timeout=600)
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
                return
            with lock:
                out.append((tenant, q, served, time.perf_counter() - ts))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, time.perf_counter() - t0


def _latencies(np, served, wall) -> str:
    """QPS, p50/p99, and the worst per-tenant p50 and p99, client side
    (submit to result)."""
    per = {}
    for tenant, _, _, dt in served:
        per.setdefault(tenant, []).append(dt * 1e3)
    every = [dt * 1e3 for *_, dt in served]
    worst50 = max(np.percentile(v, 50) for v in per.values())
    worst99 = max(np.percentile(v, 99) for v in per.values())
    return (f"{len(served)} requests in {wall:.2f} s = "
            f"{len(served) / wall:.2f} QPS; p50 "
            f"{np.percentile(every, 50):.2f} ms, p99 "
            f"{np.percentile(every, 99):.2f} ms; worst per-tenant p50 "
            f"{worst50:.2f} ms, p99 {worst99:.2f} ms over {len(per)} tenants")


def _mount_evict(reg) -> str:
    m = reg.histogram("ragdb_tenant_mount_seconds")
    e = reg.histogram("ragdb_tenant_evict_seconds")
    return (f"mounts {m.n} (p50 {m.percentile(50) * 1e3:.1f} ms, p99 "
            f"{m.percentile(99) * 1e3:.1f} ms), evictions {e.n} (p50 "
            f"{e.percentile(50) * 1e3:.3f} ms, p99 "
            f"{e.percentile(99) * 1e3:.3f} ms)")


def _drained(torch, pool, rt, baseline, label):
    """Stop the runtime, drain the pool, and hold the card's allocated
    bytes to the phase's baseline (no cache emptied, no collection)."""
    rt.stop()
    pool.drain()
    assert pool.resident_tenants() == []
    torch.cuda.synchronize()
    above = torch.cuda.memory_allocated() - baseline
    assert above < MT_LEAK_BYTES, (label, above)
    _log(f"  {label}: drained; allocated bytes {above / 1e6:+.3f} MB from "
         "the phase's baseline")


def _storage_bytes(pool) -> int:
    """Bytes of the distinct storages the resident engines and their
    snapshots hold."""
    seen = {}
    for tenant in pool.resident_tenants():
        with pool.pinned(tenant) as mt:
            eng, snap = mt.snapshots.engine, mt.snapshots.current
            cache = eng._kernel_cache[2:] if eng._kernel_cache else ()
            for t in (eng.doc_vecs, eng.doc_sigs, snap.doc_vecs,
                      snap.doc_sigs, *cache):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _served_against_plain(torch, np, ops, ref, engine, texts, rows,
                          tenant):
    """One tenant's served top-k lists (``rows``: query -> results, one
    list per distinct query in ``texts``) against the HSF kernel's plain
    version over that engine's device tensors.  Returns the largest
    score difference."""
    from repro_torch.core.engine import pack_query_arrays

    qv, qs = pack_query_arrays([engine._query_arrays(t) for t in texts],
                               engine.kb.dim, engine.kb.sig_words)
    dev = engine.doc_vecs.device
    qv = torch.from_numpy(qv[:len(texts)]).to(dev)
    qs = torch.from_numpy(qs[:len(texts)]).to(dev)
    n = engine.n_docs
    pv, pi = ref.hsf_score_topk_ref(engine.doc_vecs, engine.doc_sigs, qv,
                                    qs, engine.alpha, engine.beta,
                                    min(n, TOP_K + 32), n_valid=n)
    index = {d: i for i, d in enumerate(engine.doc_ids)}
    got = [rows[q][0].results for q in texts]
    kv = np.array([[r.score for r in res] for res in got], np.float32)
    ki = np.array([[index[r.doc_id] for r in res] for res in got], np.int32)
    return _check_against_plain(np, kv, ki, pv.cpu().numpy(),
                                pi.cpu().numpy(), ops.ID_SENTINEL,
                                f"(A) {tenant}")


def _mt_leg_a(torch, np, ops, ref, root, topical, baseline):
    """Leg A: 64 tenants, 8 resident, Zipf traffic from 16 closed-loop
    clients; every result against a standalone engine on the card."""
    import random

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.obs import stage_breakdown, trace as obs_trace

    rng = random.Random(1234)
    weights = [1.0 / (r + 1) ** MT_SKEW for r in range(N_TENANTS)]
    reqs = []
    for t in rng.choices(range(N_TENANTS), weights=weights, k=MT_REQUESTS):
        q = (_own_code(t, rng.randrange(TENANT_OWN_DOCS))
             if rng.random() < 0.5 else rng.choice(topical))
        reqs.append((_tenant(t), q))
    pool, rt, reg = _mt_runtime(root, max_resident=MT_RESIDENT)
    after_pin = _watch_pins(pool)
    rt.start()
    obs_trace.enable(capacity=1_000_000)
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        served, wall = _closed_loop(rt, reqs, MT_CLIENTS, MT_SERVE_S)
        torch.cuda.synchronize()
    launches, unfused = ops.counts["launches"], ops.counts["unfused"]
    spans = obs_trace.get().drain()
    obs_trace.disable()
    dispatches = sum(sp.name == "device_dispatch" for sp in spans)
    if len(served) < len(reqs):
        _log(f"  (A) cut: {len(served)} of {len(reqs)} requests served "
             f"before the {MT_SERVE_S:.0f} s deadline")
    _log(f"  (A) {_latencies(np, served, wall)}")
    _log(f"  (A) {_mount_evict(reg)}; resident after every pin <= "
         f"{max(after_pin)} over {len(after_pin)} pins")
    rows = sorted(_kernel_rows(prof, 1), reverse=True)
    busy_ms = sum(dev_us for dev_us, _, _ in rows) / 1e3
    idle = 1 - busy_ms / (wall * 1e3) if busy_ms else None
    _log(f"  (A) device: kernels and copies {busy_ms:.1f} ms of "
         f"{wall * 1e3:.0f} ms wall, idle share "
         f"{'not measured' if idle is None else f'{idle:.2%}'}")
    for dev_us, count, key in rows[:5]:
        _log(f"      {dev_us / 1e3:10.1f} ms x{count:<5d} {key[:70]}")
    br = stage_breakdown(spans)
    for name in ("tenant_mount", "tenant_evict", "snapshot_pin",
                 "query_embed", "device_dispatch", "host_transfer",
                 "flush"):
        if name in br:
            s = br[name]
            _log(f"      span {name:<16} x{s['count']:<5d} total "
                 f"{s['total_s'] * 1e3:10.1f} ms  p50 "
                 f"{s['p50_s'] * 1e3:8.3f} ms  p99 {s['p99_s'] * 1e3:8.3f} ms")
    m = reg.histogram("ragdb_tenant_mount_seconds")
    e = reg.histogram("ragdb_tenant_evict_seconds")
    assert e.n > 0 and m.n > N_TENANTS, (m.n, e.n)
    assert max(after_pin) <= MT_RESIDENT, max(after_pin)
    assert unfused == 0 and launches == dispatches > 0, (launches,
                                                         dispatches)
    _log(f"  (A) hsf_topk launches {launches} = scoring dispatches "
         f"{dispatches} summed over tenant groups; plain calls {unfused}")

    # recall on the tenants' own codes, and no foreign doc anywhere
    own = hits = 0
    for tenant, q, s, _ in served:
        mine = f"t{tenant[-2:]}_own_"
        ids = [r.doc_id for r in s.results]
        assert len(ids) == TOP_K, (tenant, q)
        assert not [d for d in ids if "_own_" in d
                    and not d.startswith(mine)], (tenant, q, ids)
        if q.startswith("T"):
            own += 1
            i, j = int(q[1:3]), int(q[-2:])
            hits += ids[0] == _own_doc(i, j) and s.results[0].boosted
    assert hits == own > 0, (hits, own)
    _log(f"  (A) own-code Recall@1 {hits / own:.3f} ({own} requests); no "
         "tenant returned a doc only another tenant holds")

    # bits: each tenant's results against a standalone engine on the card
    # (the kernel too), and against the kernel's plain version over that
    # engine's tensors at the tenant shape
    by_tenant = {}
    for tenant, q, s, _ in served:
        by_tenant.setdefault(tenant, {}).setdefault(q, []).append(s)
    t0 = time.perf_counter()
    cos_same = checked = 0
    worst = 0.0
    for tenant, rows in sorted(by_tenant.items()):
        engine = QueryEngine(KnowledgeBase.load(str(root / f"{tenant}.ragdb")))
        texts = sorted(rows)
        for q, want in zip(texts, engine.query_batch(texts, k=TOP_K)):
            for s in rows[q]:
                assert s.generation == engine.synced_version
                assert [(r.doc_id, r.score, r.boosted) for r in s.results] \
                    == [(r.doc_id, r.score, r.boosted) for r in want], \
                    (tenant, q)
                cos_same += all(a.cosine == b.cosine
                                for a, b in zip(s.results, want))
                checked += 1
        worst = max(worst, _served_against_plain(torch, np, ops, ref, engine,
                                                 texts, rows, tenant))
        del engine
    _log(f"  (A) bits: {checked} served results over {len(by_tenant)} "
         f"tenants equal a standalone QueryEngine on the card in ids, "
         f"scores and boost flags ({cos_same} in cosines too); against the "
         f"plain version over each engine's tensors, max |Δscore| "
         f"{worst:.3e} ({time.perf_counter() - t0:.1f} s)")
    _drained(torch, pool, rt, baseline, "(A)")
    return launches, idle


def _mt_leg_b(torch, np, root, topical, baseline):
    """Leg B: a byte budget of four tenants and less than a fifth."""
    from repro_torch.obs.ledger import DEVICE_PLANES

    rows = TENANT_BASE_DOCS + TENANT_OWN_DOCS
    one = rows * (DIM + SIG_WORDS) * 4
    pool, rt, reg = _mt_runtime(root, max_resident=N_TENANTS,
                                max_resident_bytes=4 * one + one // 2)
    texts = topical + [_own_code(0, j) for j in range(TENANT_OWN_DOCS)]
    texts = (texts * 2)[:BATCH]
    with pool.pinned(_tenant(0)) as mt:
        assert pool.ledger.tenant_bytes(_tenant(0),
                                        planes=DEVICE_PLANES) == one
        snap = mt.snapshots.current
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        snap.query_batch(texts, k=TOP_K)
        torch.cuda.synchronize()
        working = torch.cuda.max_memory_allocated() - before
    del mt, snap  # no reference of this leg may outlive an eviction
    _log(f"  (B) one tenant {one:,} bytes on the card (ledger == "
         f"{rows} × ({DIM} + {SIG_WORDS}) × 4); a {BATCH}-query flush's "
         f"working set {working / 1e6:.3f} MB")
    after_pin = _watch_pins(pool)
    reqs = [(_tenant(i % 8), topical[i % len(topical)]) for i in range(32)]
    torch.cuda.reset_peak_memory_stats()
    rt.start()
    served, wall = _closed_loop(rt, reqs, MT_CLIENTS, 600.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - baseline
    _log(f"  (B) {_latencies(np, served, wall)}")
    _log(f"  (B) {_mount_evict(reg)}; resident after every pin: "
         f"{sorted(set(after_pin))}")
    # once four are resident, every pin leaves exactly four
    assert 4 in after_pin and max(after_pin) == 4, after_pin
    assert set(after_pin[after_pin.index(4):]) == {4}, after_pin
    resident = pool.resident_bytes()
    ledger = rt.resources()["device_bytes"]
    storages = _storage_bytes(pool)
    assert resident == ledger == storages == 4 * one, (resident, ledger,
                                                       storages)
    limit = 5 * one + working
    assert peak <= limit, (peak, limit)
    _log(f"  (B) exactly 4 resident under churn; pool {resident:,} = ledger "
         f"device {ledger:,} = distinct storages {storages:,} bytes; peak "
         f"allocated {peak / 1e6:.1f} MB above the baseline <= (4 + 1) × "
         f"{one / 1e6:.1f} MB + working set {working / 1e6:.3f} MB")
    _drained(torch, pool, rt, baseline, "(B)")
    return peak


def _mt_leg_c(torch, np, root, topical, gens, baseline):
    """Leg C: a publish that is not durable, then an eviction."""
    from repro_torch.core import container as C

    def records(path):
        return len(C.read_journal(path, C.Container.open(path).uid))

    pool, rt, reg = _mt_runtime(root, max_resident=MT_RESIDENT,
                                cache=2048)
    x = _tenant(5)
    path = str(root / f"{x}.ragdb")
    before = records(path)
    rt.start()
    with rt.tenant_writer(x) as kb:
        kb.add_text("late_leg_c.txt", "late addition LEGC-LATE-0001 to "
                    "the tenant's own ledger")
    gen = rt.publish(tenant=x)
    want = rt.submit("LEGC-LATE-0001", k=TOP_K, tenant=x).result(timeout=600)
    assert want.generation == gen and \
        want.results[0].doc_id == "late_leg_c.txt", want.results[:1]
    assert records(path) == before  # published in memory only
    others = [_tenant(i) for i in range(N_TENANTS)][-MT_RESIDENT:]
    served = []
    t0 = time.perf_counter()
    for i, t in enumerate(others):
        ts = time.perf_counter()
        s = rt.submit(topical[i], k=TOP_K, tenant=t).result(timeout=600)
        served.append((t, topical[i], s, time.perf_counter() - ts))
    wall = time.perf_counter() - t0
    assert not pool.is_resident(x)
    assert records(path) == before + 1, (records(path), before)
    got = rt.submit("LEGC-LATE-0001", k=TOP_K, tenant=x).result(timeout=600)
    assert not got.cached
    assert [(r.doc_id, r.score, r.boosted) for r in got.results] == \
        [(r.doc_id, r.score, r.boosted) for r in want.results]
    with pool.pinned(x) as mt:
        container_gen = mt.kb.loaded_generation
        assert mt.kb.n_docs == TENANT_BASE_DOCS + TENANT_OWN_DOCS + 1
    del mt
    assert container_gen == gens[x] + 1, (container_gen, gens[x])
    gens[x] = container_gen
    _log(f"  (C) the eviction traffic: {_latencies(np, served, wall)}")
    _log(f"  (C) publish of generation {gen} in memory only, then {x} "
         f"evicted by traffic to {MT_RESIDENT} others: its journal gained "
         f"1 record (container generation {container_gen - 1} -> "
         f"{container_gen}); the remount serves the new doc with the "
         f"published generation's ids and scores; {_mount_evict(reg)}")
    _drained(torch, pool, rt, baseline, "(C)")


def _mt_leg_d(torch, root, topical, baseline):
    """Leg D: one hot tenant floods against its quota; the others'
    requests complete.  The isolation ratio is printed, not gated."""
    import threading

    from repro_torch.serving import RequestRejected
    from repro_torch.tenancy import TenantQuotas

    hot, cold = _tenant(1), _tenant(2)
    others = [_tenant(3), _tenant(4)]
    quotas = TenantQuotas()
    quotas.set(hot, rate=200, burst=16)
    pool, rt, _ = _mt_runtime(root, max_resident=MT_RESIDENT,
                              quotas=quotas)
    rt.start()
    for t in (hot, cold, *others):  # mount all four
        rt.submit(topical[0], k=TOP_K, tenant=t).result(timeout=600)
    time.sleep(0.1)  # the hot bucket refills to its burst

    def paced(tenant, n=64, rate=50.0):
        futures = []
        t0 = time.perf_counter()
        for i in range(n):
            delay = t0 + i / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(rt.submit(topical[i % len(topical)], k=TOP_K,
                                     tenant=tenant))
        for f in futures:
            assert f.result(timeout=600).results

    rt.metrics.reset()
    paced(cold)
    solo = rt.tenant_metrics()[cold]["latency_p99_ms"]
    rt.metrics.reset()
    admitted, rejected, other = [], [], []

    def flood():
        for i in range(1000):
            try:
                admitted.append(rt.submit(topical[i % len(topical)],
                                          k=TOP_K, tenant=hot))
            except RequestRejected as exc:
                rejected.append(exc)
            except Exception as exc:  # noqa: BLE001 — gated below
                other.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=flood)] + [
        threading.Thread(target=paced, args=(t,)) for t in (cold, *others)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for f in admitted:
        assert f.result(timeout=600).results
    m = rt.tenant_metrics()
    assert not other, other[:1]
    assert rejected and all(r.tenant == hot for r in rejected)
    assert all(m[t]["completed"] == 64 for t in (cold, *others)), m
    overload = m[cold]["latency_p99_ms"]
    _log(f"  (D) {hot} under rate 200/s, burst 16: {len(admitted)} of 1,000 "
         f"flood submits admitted, {len(rejected)} RequestRejected, each "
         f"with tenant={hot!r}; {cold}, {others[0]}, {others[1]}: 64 of 64 "
         f"each completed in {wall:.2f} s")
    _log(f"  (D) isolation ratio {overload / solo:.2f} ({cold} p99 "
         f"{overload:.2f} ms under the flood against {solo:.2f} ms solo; "
         "printed, not gated)")
    _log(f"  (D) per tenant: " + "; ".join(
        f"{t} qps {s['qps']:.0f} p50 {s['latency_p50_ms']:.2f} p99 "
        f"{s['latency_p99_ms']:.2f} ms rejected {s['rejected']}"
        for t, s in sorted(m.items())))
    _drained(torch, pool, rt, baseline, "(D)")
    return overload / solo


_MT_Q = re.compile(r"^\[(\S+)\] Q: (.*)  \[generation ")


def _parse_mt_serve(out: str) -> dict:
    """{(tenant, query): [(doc_id, boosted, score_text), ...]} from the
    driver's multi-tenant output."""
    results, cur = {}, None
    for line in out.splitlines():
        if (m := _MT_Q.match(line)):
            cur = (m.group(1), m.group(2))
            results[cur] = []
        elif cur is not None and (m := _RESULT.match(line)):
            results[cur].append((m.group(2), m.group(1) == "*", m.group(3)))
    return results


def _mt_leg_e(torch, serve, corpus, entities, topical):
    """Leg E: the entry point with no --device, against the single-tenant
    driver; then the examples on the card."""
    import os

    codes = list(entities)[:8]
    queries = codes + topical[:4]
    common = ["--corpus", str(corpus), "--dim", str(DIM), "--top-k",
              str(TOP_K), "--max-batch", str(BATCH), "--queries", *queries]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    root = Path(corpus).parent / "mt_serve"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        assert serve.main(["--tenant-root", str(root), "--tenants", "4",
                           *common]) == 0
    out = buf.getvalue()
    for line in out.splitlines():
        if line.startswith(("serving ", "pool:", "ledger:",
                            "[tenant00] sync")):
            _log(f"    | {line}")
    _log(f"    ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    above = torch.cuda.memory_allocated() - before
    assert above < MT_LEAK_BYTES, above
    got = _parse_mt_serve(out)
    assert sorted(got) == sorted((_tenant(i % 4), q)
                                 for i, q in enumerate(queries)), sorted(got)
    single, _, _ = _serve(serve, [*common, "--arch", ARCH,
                                  "--max-new-tokens", "1"])
    for (tenant, q), rows in got.items():
        assert rows == single[q] and len(rows) == TOP_K, (tenant, q)
    for code in codes:
        (tenant, _), = [key for key in got if key[1] == code]
        assert got[tenant, code][0][:2] == \
            (f"doc_{entities[code]:05d}.txt", True), code
    _log(f"  (E) serve.main --tenant-root --tenants 4 (no --device): each "
         f"tenant printed the single-tenant driver's ids and scores for its "
         f"{len(queries) // 4} queries; entity Recall@1 1.0; allocated "
         f"bytes {above / 1e6:+.3f} MB after its drain")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for name in ("multi_tenant", "quickstart"):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, (name, run.stderr[-2000:])
        _log(f"  (E) python -m repro_torch.examples.{name}: exit 0 in "
             f"{time.perf_counter() - t0:.1f} s; last line: "
             f"{run.stdout.strip().splitlines()[-1]}")


def _warm_cublas(torch):
    """cuBLAS keeps one workspace per handle in the caching allocator,
    made at a thread's first product and kept for the process; handles
    pass to later threads.  Make the two this phase uses at once (this
    thread's and a runtime's flusher's) before the baseline, so the
    leak gates read the tenancy plane alone."""
    import threading

    a = torch.ones((64, 64), device="cuda")

    def product():
        (a @ a).sum().item()
    product()
    t = threading.Thread(target=product)
    t.start()
    t.join()


def phase_tenancy(torch, np, ops, ref, tmp):
    """Phase 10: the fleet, then legs A–F (see the module docstring).
    Returns (HSF launches on leg A, leg A's idle share)."""
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.launch import serve

    root, corpus, entities, topical, gens = _tenant_fleet(tmp)
    _warm_cublas(torch)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches, idle = _mt_leg_a(torch, np, ops, ref, root, topical, baseline)
    peak = torch.cuda.max_memory_allocated() - baseline
    peak = max(peak, _mt_leg_b(torch, np, root, topical, baseline))
    torch.cuda.reset_peak_memory_stats()
    _mt_leg_c(torch, np, root, topical, gens, baseline)
    _mt_leg_d(torch, root, topical, baseline)
    peak = max(peak, torch.cuda.max_memory_allocated() - baseline)

    # leg F: every container reloads at its last generation
    t0 = time.perf_counter()
    for i in range(N_TENANTS):
        kb = KnowledgeBase.load(str(root / f"{_tenant(i)}.ragdb"))
        assert kb.loaded_generation == gens[_tenant(i)], i
        assert kb.n_docs == TENANT_BASE_DOCS + TENANT_OWN_DOCS + (i == 5), i
    torch.cuda.synchronize()
    above = torch.cuda.memory_allocated() - baseline
    assert above < MT_LEAK_BYTES, above
    _log(f"  (F) all {N_TENANTS} containers reload at their last "
         f"generation ({time.perf_counter() - t0:.1f} s); allocated bytes "
         f"{above / 1e6:+.3f} MB from the baseline after every drain; peak "
         f"{peak / 1e9:.3f} GB above it")
    _mt_leg_e(torch, serve, corpus, entities, topical)
    return launches, idle

# ---------------------------------------------------------------------------
# phase 11: the LM families at full width
# ---------------------------------------------------------------------------

# the four LM archs phase 3 does not serve, loaded one at a time (bf16:
# 18.5, 54.0, 61.1 and 31.4 GB), each through serve.main on phase 3's
# container with 8 of its entity queries and 8 of its plain ones
LM_FAMILIES = ("gemma2-9b", "gemma3-27b", "qwen3-moe-30b-a3b",
               "deepseek-v2-lite-16b")
FAMILY_QUERIES = 8
FAMILY_LEAK_BYTES = 16 << 20
FAMILY_BASELINE_MAX = 2 << 30  # no table or model left from phases 1-10
# grouped products against the per-expert loop, both bf16: the relative
# rounding of a bf16 product's output, over the largest |out|
MOE_TOL = 2e-2


def _allocated(torch) -> int:
    """Allocated bytes with nothing of a dropped model left: the
    collector run, cuBLAS's per-stream workspaces dropped."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _pairs(l, window=None):
    """(query, key) pairs causal attention at Lq = Lk = l computes,
    within ``window`` when one is given."""
    if window is None or window >= l:
        return l * (l + 1) // 2
    return window * (window + 1) // 2 + (l - window) * window


def _time_attention(torch, fa_ops, fa_ref, label, heads, l, opts,
                    padded=None):
    """Kernel, plain version, SDPA (causal, without a softcap or window,
    which it lacks) and the bound for one model's prefill attention at
    L = l.  heads = (hq, hkv, d_qk, d_v); unequal widths are laid out as
    ``models/mla.apply`` gives them.  ``padded`` also times the route
    that zero-pads the heads to that size first (``padded_ms``, the
    padding copies timed with the kernel; ``padded_alone_ms``, the
    kernel on operands padded beforehand).  With a softcap, the kernel
    is also timed without it: the softcap's share of its time."""
    import torch.nn.functional as F

    from repro_torch.models import mla

    hq, hkv, dqk, dv = heads
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = _attn_operands(torch, gen, 1, hq, hkv, l, l, (dqk, dv),
                             torch.bfloat16,
                             strided=True if dv == dqk else "mla")
    scale = opts.get("scale", dqk ** -0.5)
    kw = {k_: v_ for k_, v_ in opts.items() if k_ != "scale"}
    kernel = lambda: fa_ops.flash_attention(  # noqa: E731
        q, k, v, scale=scale, **kw)
    plain = lambda: fa_ref.attention_ref(q, k, v, scale=scale, **kw)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    for fn in (kernel, plain, library):
        fn()
    torch.cuda.synchronize()
    reps = max(1, 4_096 // l)
    out = {"ms": _queued_ms(torch, kernel, reps, 5),
           "plain_ms": _queued_ms(torch, plain, 1, 3),
           "library_ms": _queued_ms(torch, library, reps, 5)}
    pairs = _pairs(l, opts.get("window"))
    nbytes = 2 * l * (hq * dqk + hkv * dqk + hkv * dv + hq * dv)
    flops = 2 * hq * pairs * (dqk + dv)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    out.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    extra = ""
    if "softcap" in kw:
        # the softcap's share of the kernel's time
        bare_kw = {k_: v_ for k_, v_ in kw.items() if k_ != "softcap"}
        no_cap = lambda: fa_ops.flash_attention(  # noqa: E731
            q, k, v, scale=scale, **bare_kw)
        no_cap()
        out["no_softcap_ms"] = _queued_ms(torch, no_cap, reps, 5)
        out["softcap_share"] = 1 - out["no_softcap_ms"] / out["ms"]
        extra = (f" (without the softcap {out['no_softcap_ms']:.4f} ms: "
                 f"the softcap {out['softcap_share']:.1%} of the time)")
    if padded:
        route = lambda: mla.padded_attention(  # noqa: E731
            q, k, v, scale=scale, head_dim=padded, backend="kernel")
        qp, kp, vp = (F.pad(t, (0, padded - t.shape[-1])) for t in (q, k, v))
        bare = lambda: fa_ops.flash_attention(qp, kp, vp, scale=scale)  # noqa: E731
        route()
        bare()
        out["padded_ms"] = _queued_ms(torch, route, reps, 5)
        out["padded_alone_ms"] = _queued_ms(torch, bare, reps, 5)
        again = _queued_ms(torch, kernel, reps, 5)
        extra = (f" (again {again:.4f} ms; heads padded to {padded}: "
                 f"{out['padded_ms']:.4f} ms with the pad copies, "
                 f"{out['padded_alone_ms']:.4f} ms the kernel alone)")
    _log(f"  flash, {label} L={l}: kernel {out['ms']:.4f} ms{extra}, plain "
         f"{out['plain_ms']:.4f} ms, library SDPA {out['library_ms']:.4f} ms "
         f"(causal only: no softcap or window); bound {out['bound_ms']:.4f} "
         f"ms = max({nbytes / 1e6:.1f} MB / 3.35 TB/s, {flops / 1e9:.1f} "
         f"GFLOP / 989 TFLOP/s) by {out['bound_by']}; kernel at "
         f"{out['bound_ms'] / out['ms']:.1%} of it")
    return out


def _family_flash(torch, fa_ops, fa_ref, arch, cfg):
    """The flash kernel at the arch's prefill shape (the 512 bucket);
    gemma2 also at 8,192, where its window of 4,096 masks, and deepseek
    (MLA's 192/128 heads) also at 8,192, each beside its heads padded
    to 256."""
    l = ATTN_SERVE["l"]
    if cfg.mla is not None:
        m = cfg.mla
        heads = (cfg.n_heads, cfg.n_heads, m.qk_head_dim, m.v_head_dim)
        return {f"{arch} L={length}": _time_attention(
            torch, fa_ops, fa_ref, f"{arch} {m.qk_head_dim}/{m.v_head_dim}",
            heads, length, {"scale": cfg.attn_scale}, padded=256)
            for length in (l, ATTN_LONG_L)}
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
    opts = {"scale": cfg.attn_scale}
    if cfg.attn_softcap is not None:
        opts["softcap"] = cfg.attn_softcap
    if cfg.window is not None:
        opts["window"] = cfg.window
    out = {}
    for length in (l, ATTN_LONG_L) if arch == "gemma2-9b" else (l,):
        out[f"{arch} L={length}"] = _time_attention(
            torch, fa_ops, fa_ref, arch, heads, length, opts)
    return out


def _moe_plain(torch, F, params, x, ids, gates):
    """The MoE layer's routed part as a plain loop over the experts,
    each expert's rows found on the host."""
    t, k = ids.shape
    ys = torch.zeros((t, k, x.shape[1]), dtype=torch.float32,
                     device=x.device)
    for e in range(params["w_gate"].shape[0]):
        rows, slots = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(xe @ params["w_gate"][e]) * (xe @ params["w_up"][e])
        ys[rows, slots] = (h @ params["w_down"][e]).float()
    return (ys * gates[..., None]).sum(dim=1)


def _moe_layer_check(torch, steps, moe, cfg, layer):
    """(c) qwen3's FULL MoE layer at T = 512 and T = 1, with its router
    and with a skewed one (every token's first choice expert 0, all
    choices in experts 0-7: 120 of 128 groups empty): against the plain
    per-expert loop on the card; a CUDA-graph replay equal to eager bit
    for bit."""
    import torch.nn.functional as F

    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(14)
    skewed = {name: layer[name] for name in ("w_gate", "w_up", "w_down")}
    router = layer["router"].detach().clone()
    router[:, :m.top_k] = 0.0  # experts 0-7 read feature 0 alone
    router[0, :m.top_k] = torch.linspace(16.0, 9.0, m.top_k, device="cuda")
    skewed["router"] = router
    worst = 0.0
    for t in (512, 1):
        for name, params in (("router", layer), ("skewed", skewed)):
            x = torch.randn((t, cfg.d_model), device="cuda", generator=gen)
            if name == "skewed":  # feature 0 ≥ 2: logits ≥ 18 for 0-7
                x[:, 0] = x[:, 0].abs() + 2.0
            x = x.to(cfg.compute_dtype)
            _, gates, ids = moe.route(params, x, m)
            got, _ = moe.apply(params, x, m)
            want = _moe_plain(torch, F, params, x, ids, gates)
            groups = int((torch.bincount(ids.flatten(),
                                         minlength=m.n_experts) > 0).sum())
            if name == "skewed":
                assert (ids[:, 0] == 0).all() and groups <= m.top_k, groups
            scale = want.abs().max().item()
            rel = (got.float() - want).abs().max().item() / scale
            assert torch.isfinite(got).all() and rel <= MOE_TOL, \
                (t, name, rel)
            step = steps.CapturedStep(lambda xx: moe.apply(params, xx, m)[0],
                                      (x.clone(),), "cuda")
            eager = moe.apply(params, x, m)[0]
            assert _same_bits(torch, step(x), eager), (t, name)
            other = torch.randn((t, cfg.d_model), device="cuda",
                                generator=gen).to(cfg.compute_dtype)
            assert _same_bits(torch, step(other),
                              moe.apply(params, other, m)[0]), (t, name)
            worst = max(worst, rel)
            _log(f"  (c) MoE layer T={t} ({name} routing, {groups} of "
                 f"{m.n_experts} experts get rows): grouped products vs the "
                 f"per-expert loop max |Δ| / max |out| {rel:.3e} (tol "
                 f"{MOE_TOL:g}); graph replay == eager bit for bit, a "
                 "second input too")
            del step
    return worst


def _grouped_timing(torch, moe, cfg, layer, t):
    """Device time of one MoE layer's grouped products at T tokens (the
    layer's router over random activations) against their bound: the
    rows read, the weights of the experts that get rows read once, the
    rows written, over the memory rate; their operations over the bf16
    rate."""
    m = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((t, cfg.d_model), device="cuda", generator=gen) \
        .to(cfg.compute_dtype)
    _, _, ids = moe.route(layer, x, m)
    sorted_expert, order = torch.sort(ids.reshape(-1), stable=True)
    xs = x[order // m.top_k]
    ends = moe.group_ends(sorted_expert, m.n_experts)
    w = [layer[n] for n in ("w_gate", "w_up", "w_down")]
    fn = lambda: moe.expert_products(xs, ends, *w)  # noqa: E731
    fn()
    ms = _queued_ms(torch, fn, 20, 5)
    used = int((torch.bincount(ids.flatten(), minlength=m.n_experts) > 0)
               .sum())
    rows, d, f = xs.shape[0], cfg.d_model, m.d_ff_expert
    nbytes = 2 * (2 * rows * d + used * 3 * d * f)
    flops = 2 * rows * d * f * 3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    _log(f"  (d) MoE grouped products, T={t} ({rows} rows, {used} of "
         f"{m.n_experts} experts): {ms:.4f} ms a layer, bound {bound:.4f} "
         f"ms (weights {used * 3 * d * f * 2 / 1e6:.1f} MB + rows, "
         f"{bytes_ms:.4f} ms by bytes, {ops_ms:.4f} ms by operations); at "
         f"{bound / ms:.1%} of it")
    return {"ms": ms, "bound_ms": bound, "experts": used}


def _family_bits(torch, T, steps, fa_ops, model, cfg, rag):
    """(a) the 512 bucket's prefill replay and the decode replay against
    the eager static-shape steps, bit for bit (logits and the whole
    cache); flash launches per prefill replay.  Returns the inputs and
    steps phase (d) times."""
    gs = rag.generation_steps(MAX_NEW_TOKENS)
    prefill = steps.make_lm_prefill_step(cfg, gs.max_len)
    decode = steps.make_lm_decode_step(cfg)
    eager_caches = T.init_cache(cfg, 1, gs.max_len, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    bucket = gs.bucket(gs.max_context)
    step = gs.prefill(bucket)
    n = bucket - 37  # a padded prompt
    tokens = torch.randint(0, cfg.vocab, (1, bucket), device="cuda",
                           generator=gen)
    tokens[:, n:] = 0
    plen = torch.tensor([n], dtype=torch.int32, device="cuda")
    want = _clone(torch, prefill(model, tokens, plen, eager_caches)[0])
    step.capture(tokens, plen)
    got = step(tokens, plen)[0]
    assert _same_bits(torch, got, want), "prefill logits"
    assert _same_bits(torch, gs.caches, eager_caches), "prefill cache"
    tok = torch.randint(0, cfg.vocab, (1, 1), device="cuda", generator=gen)
    dlen = plen + 1
    want = _clone(torch, decode(model, eager_caches, tok, dlen)[0])
    gs.decode.capture(tok, dlen)
    got = gs.decode(tok, dlen)[0]
    assert _same_bits(torch, got, want), "decode logits"
    assert _same_bits(torch, gs.caches, eager_caches), "decode cache"
    fa_ops.reset_counts()
    for _ in range(3):
        step(tokens, plen)
    torch.cuda.synchronize()
    assert fa_ops.counts == {"launches": 3 * cfg.n_layers, "plain": 0}, \
        fa_ops.counts
    _log(f"  (a) the {bucket}-token bucket's prefill replay (a {n}-token "
         "prompt) and the decode replay equal the eager static-shape steps "
         f"bit for bit (logits and the whole {gs.max_len}-slot cache); "
         f"{cfg.n_layers} flash launches a prefill replay, plain 0; "
         f"{gs.captures} graphs captured in {gs.capture_s:.2f} s")
    return {"prefill": (lambda: prefill(model, tokens, plen, eager_caches),
                        lambda: step(tokens, plen)),
            "decode": (lambda: decode(model, eager_caches, tok, dlen),
                       lambda: gs.decode(tok, dlen))}


def _lm_family(torch, T, steps, serve, fa_ops, fa_ref, arch, ctx):
    """Phase 11 for one arch: (a) serve, replays bit for bit, tokens;
    (b) kernel against blockwise logits; (c) the MoE layer (qwen3);
    (d) times.  Returns what the kernels line and the log report."""
    from repro_torch.configs import get as get_arch
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.core.rag import RAGPipeline
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.moe_decode import ops as md_ops
    from repro_torch.models import moe

    cfg = get_arch(arch).config
    torch.cuda.reset_peak_memory_stats()
    queries = (ctx["queries"][:FAMILY_QUERIES]
               + ctx["queries"][-FAMILY_QUERIES:])
    fa_ops.reset_counts()
    da_ops.reset_counts()
    md_ops.reset_counts()
    _log(f"  (a) {arch}: serve.main --container (phase 3's) --arch {arch} "
         f"({cfg.param_count() / 1e9:.2f} B params, "
         f"{cfg.active_param_count() / 1e9:.2f} B active, "
         f"{2 * cfg.param_count() / 1e9:.1f} GB bf16)")
    results, tokens, _ = _serve(serve, [
        "--container", ctx["container"], "--top-k", str(TOP_K),
        "--max-batch", str(BATCH), "--arch", arch, "--max-new-tokens",
        str(MAX_NEW_TOKENS), "--queries", *queries])
    launches, plain = fa_ops.counts["launches"], fa_ops.counts["plain"]
    assert sorted(tokens) == sorted(queries), len(tokens)
    assert all(len(t) == MAX_NEW_TOKENS for t in tokens.values())
    assert plain == 0 and launches == cfg.n_layers * len(queries) > 0, \
        (launches, plain)
    assert results == {q: ctx["flat"][q] for q in queries}
    designed = _decode_expected_layers(torch, T, da_ops, arch, cfg)
    decodes = len(queries) * MAX_NEW_TOKENS
    assert da_ops.counts == {"launches": designed * decodes, "plain": 0}, \
        (da_ops.counts, designed, decodes)
    moe_layers = _moe_decode_expected_layers(torch, md_ops, arch, cfg)
    assert md_ops.counts == {"launches": moe_layers * decodes, "plain": 0}, \
        (md_ops.counts, moe_layers, decodes)
    _log(f"  (a) {len(queries)} requests generated {MAX_NEW_TOKENS} tokens "
         f"each; ids and scores equal phase 3's; flash launches {launches} "
         f"(= {cfg.n_layers} layers × {len(queries)} prefills), plain 0; "
         f"decode attention launches {da_ops.counts['launches']} (= "
         f"{designed} layers with a design × {decodes} decode steps), "
         f"plain 0; MoE decode launches {md_ops.counts['launches']} (= "
         f"{moe_layers} MoE layers with a design × {decodes} decode steps), "
         "plain 0")

    t0 = time.perf_counter()
    model = _served_model(torch, T, cfg)
    torch.cuda.synchronize()
    _log(f"  the served weights again (seed 0) in "
         f"{time.perf_counter() - t0:.1f} s")
    kb = KnowledgeBase.load(ctx["container"])
    rag = RAGPipeline(kb, model, cfg, engine=QueryEngine(kb, device="cuda"))
    timed = _family_bits(torch, T, steps, fa_ops, model, cfg, rag)
    probe = [queries[0], queries[-1]]
    unpadded = 0
    for q, res in zip(probe, rag.engine.query_batch(probe, k=TOP_K)):
        out = rag.generate(q, res, MAX_NEW_TOKENS)
        assert out.token_ids == tokens[q], (q, out.token_ids, tokens[q])
        prompt = _prompt(rag, res, q)
        gs = rag.steps
        assert out.token_ids == _eager_tokens(torch, T, steps, model, cfg,
                                              gs, prompt, True), q
        unpadded += out.token_ids == _eager_tokens(torch, T, steps, model,
                                                   cfg, gs, prompt, False)
    _log(f"  (a) {len(probe)} served requests again through the graphs: "
         "the served tokens, equal to the eager static-shape steps'; the "
         f"unpadded eager T.prefill/T.decode_step give the same tokens for "
         f"{unpadded} of {len(probe)}")

    _log(f"  (b) {arch} last-position prefill logits, kernel vs blockwise")
    out_err = phase_cross_check(torch, T, model, cfg, lengths=(512, 77),
                                floor_block_k=64)

    out = {"launches": launches, "logit_rel": out_err,
           "decode_launches": designed * decodes,
           "moe_decode_launches": moe_layers * decodes}
    moe_layer = next((lp.mlp for lp in model.layers if lp.moe), None)
    if arch == "qwen3-moe-30b-a3b":
        out["moe_err"] = _moe_layer_check(torch, steps, moe, cfg, moe_layer)

    for name, (eager, replay) in timed.items():
        runs = 5 if name == "prefill" else 10
        eager_ms, replay_ms, pairs = _in_turns(torch, eager, replay, runs)
        idle = _profile(torch, replay, replay_ms,
                        f"{arch} replayed {name} step", calls=3)
        out[name] = (eager_ms, replay_ms, idle)
        before = ""
        if cfg.mla is not None and name == "prefill":
            before = (f"; with the MLA heads padded to 256: eager "
                      f"{MLA_PADDED_PREFILL_MS[0]:.3f} ms, replay "
                      f"{MLA_PADDED_PREFILL_MS[1]:.3f} ms")
        _log(f"  (d) {arch} {name} at the 512 bucket: eager {eager_ms:.3f} "
             f"ms, replay {replay_ms:.3f} ms (CUDA events, median of {runs}, "
             f"in turns {', '.join(f'{t:.3f}' for t in pairs)}){before}")
    if moe_layer is not None:
        out["grouped"] = {t: _grouped_timing(torch, moe, cfg, moe_layer, t)
                          for t in (512, 1)}
    out["flash"] = _family_flash(torch, fa_ops, fa_ref, arch, cfg)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  (d) {arch} peak allocated {out['peak_gb']:.2f} GB")
    return out


def phase_lm_families(torch, T, steps, fa_ops, fa_ref, ctx):
    """Phase 11: the four LM archs at full width, one at a time, with
    the allocated bytes read back to the phase's baseline after each."""
    from repro_torch.launch import serve

    baseline = _allocated(torch)
    _log(f"  baseline: {baseline / 1e6:.3f} MB allocated (phases 1-10's "
         "tables and models freed)")
    assert baseline < FAMILY_BASELINE_MAX, baseline
    out = {}
    for arch in LM_FAMILIES:
        t0 = time.perf_counter()
        out[arch] = _lm_family(torch, T, steps, serve, fa_ops, fa_ref, arch,
                               ctx)
        above = _allocated(torch) - baseline
        assert above < FAMILY_LEAK_BYTES, (arch, above)
        _log(f"  {arch}: {time.perf_counter() - t0:.1f} s; the model and "
             f"its graphs freed, allocated bytes {above / 1e6:+.3f} MB from "
             "the baseline")
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharded retrieval planes
# ---------------------------------------------------------------------------

# configs/ragdb.py FULL at pod_16m's docs per device; the JAX package
# lowers the cell on 256 devices, the card holds up to 4 logical shards
SHARD_DOCS = 65_536
SHARD_RAGGED = 1_000      # zero rows past the real docs on the last shard
ENGINE_SHARDS = (1, 2, 4, 8)
TOPICAL_ENTITIES = 32
SHARD_ROUNDS = 3          # add_text + publish rounds through the runtime


def _shard_bound_ms(n):
    """The fused HSF top-k's bound at N docs (phase 4's formula):
    (bytes ms, operations ms)."""
    nbytes = 4 * (n * DIM + n * SIG_WORDS + BATCH * DIM + BATCH * SIG_WORDS) \
        + 8 * BATCH * TOP_K
    flops = 2 * BATCH * n * DIM
    return nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOPS_PER_S * 1e3


def _shard_timings(torch, ops, ref, dv, ds, qv, qs):
    """One kernel launch over a 65,536-row shard view and over the
    262,144 rows of four, against cuBLAS + ``torch.topk`` at the same
    shapes and the plain version at the shard's; device time of calls
    queued back to back.  Returns the shard's timing record."""
    view_v, view_s = dv[3 * SHARD_DOCS:], ds[3 * SHARD_DOCS:]
    out = {}
    for label, v, s in (("shard", view_v, view_s), ("whole", dv, ds)):
        ind = ref.containment_matrix(s, qs)
        kernel = lambda: ops.hsf_score_batched(  # noqa: E731
            v, s, qv, qs, k=TOP_K, alpha=ALPHA, beta=BETA)
        library = lambda: torch.topk(  # noqa: E731
            ALPHA * (qv @ v.T) + BETA * ind, TOP_K)
        kernel()
        library()
        torch.cuda.synchronize()
        t = {"ms": _queued_ms(torch, kernel, 10, 10),
             "library_ms": _queued_ms(torch, library, 10, 10)}
        if label == "shard":
            plain = lambda: ref.hsf_score_topk_ref(  # noqa: E731
                v, s, qv, qs, ALPHA, BETA, TOP_K)
            plain()
            t["plain_ms"] = _queued_ms(torch, plain, 1, 5)
        t["again_ms"] = _queued_ms(torch, kernel, 10, 10)
        bytes_ms, ops_ms = _shard_bound_ms(v.shape[0])
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        out[label] = t
        del ind
    sh, wh = out["shard"], out["whole"]
    _log(f"  (a) timings: one launch over a {SHARD_DOCS:,}-row shard view "
         f"{sh['ms']:.4f} ms (again {sh['again_ms']:.4f}; plain "
         f"{sh['plain_ms']:.4f}, cuBLAS + torch.topk {sh['library_ms']:.4f}, "
         f"bound {sh['bound_ms']:.4f} by {sh['bound_by']}: "
         f"{sh['bound_ms'] / sh['ms']:.1%}); one launch over "
         f"{4 * SHARD_DOCS:,} rows {wh['ms']:.4f} ms (again "
         f"{wh['again_ms']:.4f}; cuBLAS + torch.topk {wh['library_ms']:.4f}, "
         f"bound {wh['bound_ms']:.4f}: {wh['bound_ms'] / wh['ms']:.1%}); "
         f"4 shard launches {4 * sh['ms']:.4f} ms = "
         f"{4 * sh['ms'] / wh['ms']:.3f}x the one launch")
    return sh


def _sharded_retrieve_legs(torch, np, ops, ret, meshlib, dv, ds, qv, qs):
    """``build_sharded_retrieve`` at S ∈ {1, 4} logical shards, whole and
    ragged, kernel and gemm legs, held to ``single_device_reference``.
    Returns (kernel launches on this path, largest kernel |Δscore|)."""
    launches, worst = 0, 0.0
    for n_shards in (1, 4):
        mesh = meshlib.make_shard_mesh(n_shards, "cuda")
        n_rows = n_shards * SHARD_DOCS
        for ragged in (False, True):
            n_docs = n_rows - (SHARD_RAGGED if ragged else 0)
            pv, ps = dv[:n_rows], ds[:n_rows]
            if ragged:
                # the zero rows pad_corpus appends past the real docs
                pv, ps = pv.clone(), ps.clone()
                pv[n_docs:] = 0.0
                ps[n_docs:] = 0
            rv, ri = ret.single_device_reference(pv, ps, qv, qs, n_docs,
                                                 TOP_K + 32)
            rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
            for use_kernel in (True, False):
                label = (f"S={n_shards} N={n_rows} n_docs={n_docs} "
                         f"{'kernel' if use_kernel else 'gemm'}")
                retrieve = ret.build_sharded_retrieve(
                    mesh, meshlib.all_axes(mesh), n_docs, TOP_K, ALPHA, BETA,
                    use_kernel=use_kernel)
                ops.reset_counts()
                vals, ids = retrieve(pv, ps, qv, qs)
                torch.cuda.synchronize()
                counts = dict(ops.counts)
                want = {"launches": n_shards if use_kernel else 0,
                        "unfused": 0}
                assert counts == want, (label, counts)
                launches += counts["launches"]
                kv, ki = vals.cpu().numpy(), ids.cpu().numpy()
                err = _check_against_plain(np, kv, ki, rv, ri,
                                           ops.ID_SENTINEL, label)
                assert int(ki.max()) < n_docs, label
                if use_kernel:
                    worst = max(worst, err)
                else:
                    np.testing.assert_allclose(kv, rv[:, :TOP_K], rtol=1e-6,
                                               atol=0, err_msg=label)
                same = int((ki == ri[:, :TOP_K]).sum())
                _log(f"  (a) {label}: {counts['launches']} launch(es), 0 "
                     "unfused; ids "
                     f"equal the oracle's at {same} of {ki.size} positions "
                     f"(the rest within near-ties of {SCORE_ATOL:g}); max "
                     f"|Δscore| {err:.3e}")
            del pv, ps
    return launches, worst


def _ragdb_cells(torch, ops, steps):
    """The ragdb cells captured and replayed bit-equal to their eager
    step; the kernel leg's launches a replay.  Returns (launches over
    the replays, {label: (eager ms, replay ms)})."""
    launches, times = 0, {}
    for shape_id in ("pod_16m", "edge_1k"):
        for n_shards in (1, 4):
            for use_kernel in (True, False):
                cell = steps.build_cell("ragdb", shape_id, device="cuda",
                                        n_shards=n_shards,
                                        use_kernel=use_kernel, seed=12)
                label = (f"{shape_id} S={n_shards} "
                         f"{'kernel' if use_kernel else 'gemm'}")
                eager = [t.clone() for t in cell.fn.fn(*cell.args)]
                cell.fn.capture()
                ops.reset_counts()
                vals, ids = cell.fn()
                torch.cuda.synchronize()
                want = n_shards if use_kernel else 0
                assert ops.counts == {"launches": want, "unfused": 0}, \
                    (label, ops.counts)
                launches += want
                assert torch.equal(vals, eager[0]) and \
                    torch.equal(ids, eager[1]), label
                if shape_id == "pod_16m":
                    e, r, turns = _in_turns(
                        torch, lambda: cell.fn.fn(*cell.args), cell.fn, 10)
                    times[label] = (e, r)
                    _log(f"  (a) cell {label} ({cell.meta['n_docs']:,} docs, "
                         f"reduced {cell.meta['reduced']}): replay == eager "
                         f"bit for bit, {want} launch(es) a replay; eager "
                         f"{e:.4f} ms, replay {r:.4f} ms (CUDA events, "
                         "median of 10, in turns "
                         f"{', '.join(f'{x:.4f}' for x in turns)})")
                else:
                    _log(f"  (a) cell {label} ({cell.meta['n_docs']:,} docs): "
                         f"replay == eager bit for bit, {want} launch(es) a "
                         "replay")
                del cell, eager, vals, ids
    return launches, times


def phase_sharded_retrieve(torch, np, ops, ref, steps):
    """(a) ``build_sharded_retrieve`` on ragdb FULL at pod_16m's 65,536
    docs a shard: S ∈ {1, 4}, whole and ragged, both legs against the
    oracle; the per-shard kernel timed; the ragdb cells replayed.
    Returns (the kernel's launches on this path, its largest |Δscore|,
    the shard's timing record)."""
    from repro_torch.core import retrieval as ret
    from repro_torch.launch import mesh as meshlib

    gen = torch.Generator(device="cuda").manual_seed(12)
    dv, ds, qv, qs = _make_operands(torch, gen, 4 * SHARD_DOCS, DIM,
                                    SIG_WORDS, BATCH)
    _log(f"  (a) corpus {4 * SHARD_DOCS:,} x {DIM} f32 "
         f"({dv.numel() * 4 / 1e9:.2f} GB) + signatures "
         f"({ds.numel() * 4 / 1e6:.0f} MB), {BATCH} queries, k={TOP_K}")
    launches, worst = _sharded_retrieve_legs(torch, np, ops, ret, meshlib,
                                             dv, ds, qv, qs)
    timing = _shard_timings(torch, ops, ref, dv, ds, qv, qs)
    del dv, ds, qv, qs
    torch.cuda.empty_cache()
    cell_launches, _ = _ragdb_cells(torch, ops, steps)
    return launches + cell_launches, worst, timing


def _topical_kb(tmp):
    """A topical corpus of SHARD_DOCS docs at dim 4,096, ingested on the
    host and saved with its matrix; its first half of entity codes and
    one query per topic (three core words) make a 64-query batch."""
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.data.corpus import make_topical_corpus

    t0 = time.perf_counter()
    docs, entities, cores = make_topical_corpus(
        n_docs=SHARD_DOCS, n_entities=TOPICAL_ENTITIES, seed=3)
    kb = KnowledgeBase(dim=DIM)
    for i, d in enumerate(docs):
        kb.add_text(f"doc_{i:05d}.txt", d)
    t1 = time.perf_counter()
    path = str(Path(tmp) / "topical.ragdb")
    kb.save(path)
    _log(f"  (b) topical corpus: {SHARD_DOCS:,} docs ingested in "
         f"{t1 - t0:.1f} s, saved with its matrix in "
         f"{time.perf_counter() - t1:.1f} s")
    queries = list(entities) + [" ".join(c[:3]) for c in cores]
    return path, entities, queries[:BATCH]


def _same_batch(a, b, label):
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        _same_results(x, y, (label, i))


def _sharded_engine_at(torch, kb, queries, want, n_shards):
    """One sharded exact engine on ``kb`` (adopting its state): the plane
    rebuilt and timed, the batch's bits against flat, its time, stats
    and idle share."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.index import ShardedIVFIndex

    eng = QueryEngine(kb, device="cuda", index="ivf-sharded",
                      guarantee="exact", n_shards=n_shards)
    assert eng.retrains == 0 and eng.scoring_path == "map", eng.retrains
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plane = ShardedIVFIndex.from_base(eng.ivf.base, eng.doc_vecs,
                                      eng.doc_sigs, n_shards=n_shards)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in
                 plane.dv_blocks + plane.ds_blocks + plane.gid_blocks)
    del plane
    _same_batch(eng.query_batch(queries, k=TOP_K), want, f"S={n_shards}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.query_batch(queries, k=TOP_K)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    st = eng.index_stats()
    # one query per call, where the probe can prune: 8 entity codes and
    # 8 topical queries, each against its flat result
    single = {"ms": [], "fraction": [], "rounds": []}
    for q, w in list(zip(queries, want))[:8] + list(zip(queries, want))[-8:]:
        t0 = time.perf_counter()
        res = eng.query_batch([q], k=TOP_K)[0]
        single["ms"].append((time.perf_counter() - t0) * 1e3)
        _same_results(res, w, (n_shards, q))
        one = eng.index_stats()
        single["fraction"].append(one["probed_fraction"])
        single["rounds"].append(one["rounds"])
    idle = _profile(torch, lambda: eng.query_batch(queries, k=TOP_K), wall,
                    f"one sharded exact batch at S={n_shards}", "add",
                    "the add tree (elementwise adds)")
    _log(f"  (b) S={n_shards} ({eng.ivf.placement}): {len(queries)} queries "
         f"equal the flat map path bit for bit (ids, scores, cosines, "
         f"boosts); batch {wall:.1f} ms (median of 3, host clock; "
         f"{', '.join(f'{w:.1f}' for w in walls)}); widen rounds "
         f"{st['rounds']}, probed fraction {st['probed_fraction']:.3%}, "
         f"candidate rows {st['candidate_rows']:,}, merge "
         f"{st['merge_seconds'] * 1e3:.3f} ms; shard rows "
         f"{eng.ivf.shard_sizes()}, block {eng.ivf.block_len:,} rows; plane "
         f"build {build_s:.3f} s, {nbytes / 1e9:.3f} GB; device idle "
         f"{'not measured' if idle is None else f'{idle:.1%}'}")
    _log(f"  (b) S={n_shards}, one query per call (8 entity codes, 8 topical "
         f"queries; each equal to its flat result bit for bit): median "
         f"{statistics.median(single['ms']):.1f} ms; probed fraction mean "
         f"{statistics.mean(single['fraction'][:8]):.1%} (entity), "
         f"{statistics.mean(single['fraction'][8:]):.1%} (topical); widen "
         f"rounds mean {statistics.mean(single['rounds']):.2f}, max "
         f"{max(single['rounds'])}")
    return eng


def _sharded_probe(kb, entities, queries, want):
    """Probe mode at nprobe 8 on 4 shards: entity Recall@1, and the
    scores it shares with flat equal bit for bit."""
    from repro_torch.core.engine import QueryEngine

    eng = QueryEngine(kb, device="cuda", index="ivf-sharded", nprobe=8,
                      n_shards=4)
    assert eng.retrains == 0
    res = eng.query_batch(queries, k=TOP_K)
    st = eng.index_stats()
    hits = sum(r[0].doc_id == f"doc_{entities[q]:05d}.txt"
               for q, r in zip(queries, res) if q in entities)
    shared = 0
    for a, b in zip(res, want):
        fs = {r.doc_id: r.score for r in b}
        for r in a:
            if r.doc_id in fs:
                assert r.score == fs[r.doc_id], (r, fs[r.doc_id])
                shared += 1
    n_ent = sum(q in entities for q in queries)
    assert hits >= 0.9 * n_ent, (hits, n_ent)
    _log(f"  (b) probe nprobe=8, S=4: entity Recall@1 {hits / n_ent:.3f}, "
         f"probed fraction {st['probed_fraction']:.3%}, {shared} (query, "
         "doc) scores shared with flat, equal bit for bit")


def _sharded_runtime(kb, queries, flat):
    """SHARD_ROUNDS add_text + publish rounds through a ServingRuntime on
    4 shards: after each, the served batch (with the new docs' codes)
    equals the flat map engine on the same KB bit for bit."""
    from repro_torch.serving import ServingRuntime

    runtime = ServingRuntime(kb, max_batch=BATCH, index="ivf-sharded",
                             guarantee="exact", n_shards=4, device="cuda",
                             result_cache_size=0)
    codes = []
    with runtime:
        for rnd in range(SHARD_ROUNDS):
            for j in range(4):
                code = f"LIVE-{rnd}{j}-7777"
                codes.append(code)
                kb.add_text(f"live_{rnd}_{j}.txt",
                            f"fresh record {code} about "
                            f"{queries[TOPICAL_ENTITIES + j]}")
            t0 = time.perf_counter()
            gen = runtime.publish()
            publish_s = time.perf_counter() - t0
            batch = (codes + queries)[:BATCH]
            got = runtime.query_batch(batch, k=TOP_K)
            want = flat.query_batch(batch, k=TOP_K)
            _same_batch(got, want, f"round {rnd}")
            assert all(got[i][0].doc_id.startswith("live_")
                       for i in range(min(len(codes), len(batch)))), rnd
            _log(f"  (b) runtime round {rnd}: 4 docs added, generation "
                 f"{gen} published in {publish_s:.2f} s; {len(batch)} "
                 "served results equal the flat map engine bit for bit, "
                 "the new codes first")
        assert runtime.snapshots.current.ivf is runtime.engine.ivf
    return runtime.engine


def phase_sharded_engine(torch, np, tmp):
    """(b) ``QueryEngine(index="ivf-sharded", guarantee="exact")`` on a
    topical corpus at S ∈ {1, 2, 4, 8}, against the flat map path; probe
    mode; live rounds through the runtime; containers adopted both ways
    with no retrain; allocated bytes back at the baseline."""
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.ingest import KnowledgeBase

    baseline = _allocated(torch)
    path, entities, queries = _topical_kb(tmp)
    # a flat-IVF engine trains and writes a flat state; every sharded
    # engine below adopts it (flat-written → sharded)
    kb = KnowledgeBase.load(path)
    t0 = time.perf_counter()
    trained = QueryEngine(kb, device="cuda", index="ivf", guarantee="exact")
    assert trained.retrains == 1 and "n_shards" not in kb.index_state
    _log(f"  (b) flat IVF engine trained in {time.perf_counter() - t0:.2f} s "
         f"({trained.ivf.n_clusters} clusters); its state is the one the "
         "sharded engines adopt")
    kb.save(path)
    del trained
    kb = KnowledgeBase.load(path)
    flat = QueryEngine(kb, device="cuda", scoring_path="map")
    want = flat.query_batch(queries, k=TOP_K)
    for n_shards in ENGINE_SHARDS:
        eng = _sharded_engine_at(torch, kb, queries, want, n_shards)
        del eng
    _sharded_probe(kb, entities, queries, want)
    engine = _sharded_runtime(kb, queries, flat)
    # sharded-written → flat IVF: the runtime's engine wrote its state
    assert int(kb.index_state["n_shards"]) == 4
    saved = str(Path(tmp) / "topical_sharded.ragdb")
    kb.save(saved)
    adopted = QueryEngine(KnowledgeBase.load(saved), device="cuda",
                          index="ivf", guarantee="exact", scoring_path="map")
    assert adopted.retrains == 0, adopted.retrains
    assert np.array_equal(adopted.ivf.assign, engine.ivf.assign)
    batch = queries[:16]
    _same_batch(adopted.query_batch(batch, k=TOP_K),
                flat.query_batch(batch, k=TOP_K), "flat IVF adopted")
    _log("  (b) containers: the flat-written state adopted by the sharded "
         "engines at every S (retrains 0), and the runtime's sharded-written "
         "state adopted by a flat IVF engine (retrains 0, same assignments, "
         "flat bits)")
    del adopted, engine, flat, kb, want
    above = _allocated(torch) - baseline
    assert above < FAMILY_LEAK_BYTES, above
    _log(f"  (b) engines freed: allocated bytes {above / 1e6:+.3f} MB from "
         f"the phase's baseline ({baseline / 1e6:.3f} MB)")


def _sharded_lookup(torch, emb, dlrm, params, cfg, batch, query, cand):
    """Phase 12 (c), run here while dlrm-rm2's table is resident: the
    row-sharded lookup at S = 4 (views of the one table) bit-equal to
    the unsharded one, for the lookup, a serve forward at batch 512 and
    the 1,000,448-candidate scores."""
    from repro_torch.launch.mesh import make_shard_mesh

    table = params["table"]
    offs = emb.cached_offsets(cfg.vocab_sizes, table.device)
    sparse, dense = batch["sparse_idx"], batch["dense"]
    plain = (emb.lookup(table, offs, sparse),
             dlrm.forward(params, dense, sparse, cfg),
             dlrm.retrieval_scores(params, query, cand, cfg))
    before = torch.cuda.memory_allocated()
    with emb.sharding_ctx(make_shard_mesh(4, "cuda")):
        sharded = (emb.lookup(table, offs, sparse),
                   dlrm.forward(params, dense, sparse, cfg),
                   dlrm.retrieval_scores(params, query, cand, cfg))
        torch.cuda.synchronize()
        lookup_ms = _median_ms(torch, lambda: emb.lookup(table, offs, sparse),
                               20)
    for name, a, b in zip(("lookup", "forward", "retrieval scores"), plain,
                          sharded):
        assert torch.equal(a, b), name
    extra = torch.cuda.memory_allocated() - before
    plain_ms = _median_ms(torch, lambda: emb.lookup(table, offs, sparse), 20)
    _log(f"  phase 12 (c), here while the {table.numel() * 4 / 1e9:.2f} GB "
         f"table is resident: row-sharded lookup at S=4 (views of the one "
         f"table, {extra / 1e6:+.1f} MB allocated after) bit-equal to the "
         f"unsharded one for the lookup at batch {sparse.shape[0]}, the "
         f"serve forward and {cand.shape[0]:,} candidate scores; lookup "
         f"{lookup_ms:.4f} ms sharded, {plain_ms:.4f} ms unsharded (CUDA "
         "events, median of 20)")

# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: the training substrate
# ---------------------------------------------------------------------------

TRAIN_MICRO = 8           # micro-batches of one sequence a step (ref.: 256)
TRAIN_SEQ = 4_096         # train_4k's sequence, not cut
TRAIN_STEPS = 3           # gated steps, then one profiled, one with TF32
PROFILE_MICRO = 2         # micro-batches in the profiled window
LOSS_NEAR_LN_V = 0.5      # step 0's loss within this of ln(vocab)
# (b) the card's steps against the CPU's from the same weights, state and
# tokens (f32 SMOKE configs, TF32 off), from the end of the warm-up (lr
# 3e-4), each step from the CPU's state: Adam's normalised step moves an
# element whose gradient is rounding noise by up to its learning rate in
# either direction, and the next step's gradients carry that far beyond
# rounding, so two steps in a row on each side are not comparable leaf by
# leaf.  Per step: the loss within rtol 1e-5; the update, leaf by leaf,
# within SMOKE_UPDATE_REL of its norm (a dropped, halved or sign-flipped
# update is off by half its norm or more); the moments, which carry the
# gradients, within SMOKE_MOMENT_TOL of each leaf's largest magnitude (f32
# sums in other orders, atomics in the embedding's backward); the
# parameters within 2 × the step's learning rate + 1e-7 elementwise
SMOKE_TRAIN_SHAPE = (2, 2, 64)  # micro-batches, sequences each, seq
SMOKE_TRAIN_STEPS = 2
SMOKE_UPDATE_REL = 1e-2
SMOKE_MOMENT_TOL = 1e-4
EP_SHARDS = 4
RECSYS_TRAIN_STEPS = {"dlrm-rm2": 2, "deepfm": 3, "autoint": 3}
# (c) the table against a row-wise update from a gradient recomputed on
# the card by the unchanged forward: deepfm's and autoint's dense table
# gradient and a whole-table update (DENSE_REFERENCE); dlrm-rm2's 48 GB
# table leaves no room for a dense gradient beside it, so its reference
# takes the touched rows' gradient through a gathered table (the step's
# own method, so a fault in the gather or the offsets would be shared).
# Rows with no gradient must keep their bits.  The embedding's backward
# adds with atomics, so the two gradients agree to ~1e-5 of the largest
# row's scale, not to the bit.  A row moves by lr·g/√g2, normalised by
# its own gradient, so each row is held to lr · ROW_GRAD_REL · max√g2 /
# (√g2 + ε) + 1e-6 (a row whose gradient is rounding noise may move by
# up to a step; one with a real gradient may not), g2 within
# ROW_GRAD_REL of its largest
DENSE_REFERENCE = ("deepfm", "autoint")
ROW_GRAD_REL = 1e-5
UNTOUCHED_SAMPLE = 1 << 20  # untouched rows compared bit for bit
RESTART = dict(steps=60, first=40, every=20)


def _word_sum(torch, t, chunk: int = 1 << 28) -> int:
    """Σ of ``t``'s 32-bit words (int64): a digest that moves when any
    word does (save for changes that cancel).  Summed ``chunk`` words at
    a time: the int64 sum takes a widened copy of what it sums."""
    words = t.contiguous().view(torch.int32).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, words.numel(), chunk):
        total += words[lo:lo + chunk].sum(dtype=torch.int64)
    return int(total)


def _lm_train_full(torch, np, steps, T, tree_lib):
    """(a) llama3.2-3b FULL, the optimized form, 8 micro-batches of one
    4,096-token sequence a step."""
    from repro_torch.configs import get as get_arch

    arch = "llama3.2-3b"
    cfg = get_arch(arch).config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = steps.build_cell(arch, "train_4k", device="cuda",
                            batch=TRAIN_MICRO, seq=TRAIN_SEQ)
    model, opt, toks, tgts = cell.args
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    _log(f"  (a) {arch} FULL train_4k cell in {time.perf_counter() - t0:.1f} "
         f"s: {n_params / 1e9:.3f} B params (d_model {cfg.d_model}, "
         f"{cfg.n_layers} layers, vocab {cfg.vocab}), bf16 working copy + "
         f"f32 master + m + v; {cell.meta['n_micro']} micro-batches of "
         f"{cell.meta['micro']} x {toks.shape[2]} tokens; reduced: "
         f"{cell.meta['reduced']}; {torch.cuda.memory_allocated() / 1e9:.2f}"
         " GB allocated")
    params = T.param_tree(model)
    master = opt["master"]
    tokens = toks.numel()

    def run_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, new_opt, loss = cell.fn(*cell.args)
        loss = float(loss)
        torch.cuda.synchronize()
        return new_opt, loss, time.perf_counter() - t

    step_s = []
    for i in range(TRAIN_STEPS):
        before = [_word_sum(torch, t) for t in tree_lib.leaves(master)]
        m_before = _word_sum(torch, tree_lib.leaves(opt["m"])[0])
        lr = float(steps.warmup_cosine(opt["step"], 3e-4, steps.WARMUP_STEPS,
                                       steps.TOTAL_STEPS))
        opt, loss, dt = run_step()
        after = [_word_sum(torch, t) for t in tree_lib.leaves(master)]
        changed = sum(a != b for a, b in zip(before, after))
        assert math.isfinite(loss), f"step {i}: loss {loss}"
        if i == 0:
            near = abs(loss - math.log(cfg.vocab))
            assert near <= LOSS_NEAR_LN_V, (
                f"step 0 loss {loss:.4f}, ln(vocab) "
                f"{math.log(cfg.vocab):.4f}")
        if lr == 0.0:
            # the reference's schedule starts at lr 0: the master keeps
            # its bits, the moments take the gradients
            assert changed == 0, f"step {i} at lr 0 moved {changed} leaves"
            assert _word_sum(torch, tree_lib.leaves(opt["m"])[0]) != m_before
        else:
            assert changed == len(before), (
                f"step {i}: {len(before) - changed} master leaves unchanged")
        for p, mp in zip(tree_lib.leaves(params), tree_lib.leaves(master)):
            assert torch.equal(p.detach(), mp.to(torch.bfloat16)), \
                "working copy != master after the bf16 cast"
        step_s.append(dt)
        _log(f"    step {i}: loss {loss:.4f} (ln V {math.log(cfg.vocab):.4f}), "
             f"lr {lr:.3e}, {dt:.2f} s, master leaves changed "
             f"{changed}/{len(before)}, working copy = bf16(master)")
    steady = statistics.median(step_s[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    tflops = 6 * n_params * tokens / steady / 1e12
    _log(f"    step {steady:.3f} s (median of steps 1-{TRAIN_STEPS - 1}; "
         f"step 0 {step_s[0]:.3f} s), {tokens / steady:,.0f} tokens/s, "
         f"6·N·tokens {tflops:.1f} TFLOP/s = {tflops / 989:.1%} of the 989 "
         f"TFLOP/s dense bf16 peak; peak {peak:.2f} GB allocated")
    # the profiled window: a step over PROFILE_MICRO of the micro-batches
    # (the same loop body and update; a whole step's trace is ~4x larger)
    part = steps.make_lm_train_step(cfg, PROFILE_MICRO, bf16_params=True)

    def window():
        part(model, opt, toks[:PROFILE_MICRO], tgts[:PROFILE_MICRO])

    window()
    torch.cuda.synchronize()
    t = time.perf_counter()
    window()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t) * 1e3
    idle = _profile(torch, window, window_ms,
                    f"a train step of {PROFILE_MICRO} micro-batches",
                    mark="gemm", mark_name="GEMM kernels")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, _, tf32_s = run_step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _log(f"    with TF32 allowed (the script keeps it off): {tf32_s:.3f} s a "
         f"step ({steady / tf32_s:.2f}x); peak "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del cell, model, opt, params, master
    return {"step_s": steady, "tokens_per_s": tokens / steady,
            "tflops": tflops, "peak_gb": peak, "idle": idle,
            "tf32_step_s": tf32_s}


def _auto_refuses_grad(torch, fa_ops):
    """``backend="auto"`` on the card under grad raises instead of
    running the forward-only kernel, and launches nothing."""
    from repro_torch.models import attention as attn

    q, k, v = (torch.randn((1, 4, 64, 64), device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    fa_ops.reset_counts()
    try:
        attn.attention(q, k, v, scale=0.125, backend="auto")
    except RuntimeError as exc:
        assert "no backward" in str(exc), exc
    else:
        raise AssertionError("flash kernel ran under grad")
    assert fa_ops.counts == {"launches": 0, "plain": 0}, fa_ops.counts
    with torch.no_grad():
        attn.attention(q, k, v, scale=0.125, backend="auto")
    assert fa_ops.counts["launches"] == 1
    fa_ops.reset_counts()
    _log("  backend='auto' under grad on the card raises (no launch, no "
         "plain fallback); under no_grad it launches the kernel")


def _smoke_states(torch, T, steps, cfg, device, seed=0):
    """The same f32 training weights (from a CPU generator) on ``device``,
    with fresh AdamW state at the end of the warm-up (lr 3e-4)."""
    from repro_torch.optim import adamw_init

    gen = torch.Generator().manual_seed(seed)
    cpu = T.init(cfg, gen, "cpu", leaf_dtype=torch.float32)
    model = T.LM(cfg, T.param_tree(cpu), device, leaf_dtype=torch.float32,
                 requires_grad=True)
    opt = adamw_init(T.param_tree(model))
    opt["step"] = torch.tensor(steps.WARMUP_STEPS, dtype=torch.int32,
                               device=device)
    return model, opt


def _lm_train_smoke(torch, np, steps, T, tree_lib):
    """(b) each LM arch's SMOKE config: train steps on the card against
    the same steps on the CPU, each step from the CPU's state, its loss,
    update, moments and parameters held leaf by leaf; qwen3's MoE layer
    through ``apply_expert_parallel`` on 4 logical expert shards."""
    from repro_torch.configs import ARCHS, get as get_arch
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe

    def leaves(state, k=None):
        model, opt = state
        return tree_lib.leaves(T.param_tree(model) if k is None else opt[k])

    n_micro, micro, seq = SMOKE_TRAIN_SHAPE
    for arch in [a for a, s in ARCHS.items() if s.family == "lm"]:
        cfg = get_arch(arch).smoke_config
        toks, tgts = pipeline.lm_batch(pipeline.DataCursor(seed=0),
                                       n_micro * micro, seq, cfg.vocab)
        toks, tgts = (torch.from_numpy(a.reshape(n_micro, micro, seq))
                      for a in (toks, tgts))
        t0 = time.perf_counter()
        states = {where: _smoke_states(torch, T, steps, cfg, where)
                  for where in ("cpu", "cuda")}
        step = steps.make_lm_train_step(cfg, n_micro)
        losses = {"cpu": [], "cuda": []}
        worst = dict.fromkeys(("update", "m", "v", "params"), 0.0)
        for i in range(SMOKE_TRAIN_STEPS):
            with torch.no_grad():
                for k in (None, "m", "v"):
                    for dst, src in zip(leaves(states["cuda"], k),
                                        leaves(states["cpu"], k)):
                        dst.copy_(src)
            states["cuda"][1]["step"] = states["cpu"][1]["step"].cuda()
            lr = float(steps.warmup_cosine(states["cpu"][1]["step"], 3e-4,
                                           steps.WARMUP_STEPS,
                                           steps.TOTAL_STEPS))
            old = [p.detach().clone() for p in leaves(states["cpu"])]
            for where, (model, opt) in states.items():
                _, _, loss = step(model, opt, toks.to(where), tgts.to(where))
                losses[where].append(float(loss))
            a, b = losses["cpu"][-1], losses["cuda"][-1]
            assert abs(a - b) <= 1e-5 * abs(a), (arch, i, a, b)
            for o, a, b in zip(old, leaves(states["cpu"]),
                               leaves(states["cuda"])):
                a, b = a.detach(), b.detach().cpu()
                size = float((a - o).norm())
                assert size > 0, f"{arch} step {i}: a leaf did not move"
                err = float((b - a).norm()) / size
                worst["update"] = max(worst["update"], err)
                assert err <= SMOKE_UPDATE_REL, (arch, i, err)
                assert torch.allclose(b, a, rtol=1e-4, atol=2 * lr + 1e-7), \
                    (arch, i)
                worst["params"] = max(worst["params"],
                                      float((a - b).abs().max()))
            for k in ("m", "v"):
                for a, b in zip(leaves(states["cpu"], k),
                                leaves(states["cuda"], k)):
                    scale = float(a.abs().max()) + 1e-30
                    err = float((a - b.cpu()).abs().max()) / scale
                    worst[k] = max(worst[k], err)
                    assert err <= SMOKE_MOMENT_TOL, (arch, i, k, err)
        _log(f"  (b) {arch} SMOKE: {SMOKE_TRAIN_STEPS} steps of {n_micro} x "
             f"{micro} x {seq} tokens from step {steps.WARMUP_STEPS} (lr "
             f"3e-4), each from the CPU's state, card vs CPU: losses "
             f"{losses['cuda']} vs {losses['cpu']}; updates within "
             f"{worst['update']:.2e} of their norm (bound "
             f"{SMOKE_UPDATE_REL:.0e}); moments within {worst['m']:.1e} / "
             f"{worst['v']:.1e} of their largest (bound "
             f"{SMOKE_MOMENT_TOL:.0e}), params within {worst['params']:.1e} "
             f"(atol 2 lr + 1e-7); {time.perf_counter() - t0:.1f} s")
        if cfg.moe is not None and arch == "qwen3-moe-30b-a3b":
            layer = T.param_tree(states["cuda"][0])["layers"][0]["mlp"]
            x = torch.randn((n_micro * micro * seq, cfg.d_model),
                            device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
            with torch.no_grad():
                want, aux = moe.apply(layer, x, cfg.moe)
                got, got_aux = moe.apply_expert_parallel(
                    layer, x, cfg.moe,
                    meshlib.make_host_mesh(EP_SHARDS, "cuda"), ("data",),
                    capacity_factor=16.0)
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()) + 1e-6, err
            assert abs(float(got_aux) - float(aux)) <= 1e-6
            _log(f"      apply_expert_parallel on {EP_SHARDS} logical expert "
                 f"shards (capacity factor 16, T = {x.shape[0]}) vs dropless: "
                 f"max |diff| {err:.2e}, aux equal")


def _table_reference(torch, mod, cfg, params, inputs, rows, offs, flat,
                     dense: bool):
    """(loss, {table key: (index, gradient)}) at the step's weights, from
    the unchanged forward: over the whole table (``dense``; the index
    takes every row), or, for a table too large for a dense gradient
    beside it, over a gathered table of the touched rows ``rows`` with
    the field offsets folded into the indices (the step's own method)."""
    from repro_torch.models.recsys import base as rbase
    from repro_torch.optim import rowwise
    from repro_torch.optim import tree as tree_lib

    tabs, towers = rowwise.split_tree(params)
    live = tree_lib.map_(lambda t: t.detach().clone().requires_grad_(),
                         towers)
    if dense:
        sub = {k: t.detach().clone().requires_grad_()
               for k, t in tabs.items()}
        idx = inputs["sparse_idx"]
        index = slice(None)
    else:
        sub = {k: t[rows].requires_grad_() for k, t in tabs.items()}
        inverse = torch.searchsorted(rows, flat.reshape(-1).to(torch.int64))
        idx = (inverse.view(flat.shape) - offs[None, :]).to(torch.int32)
        index = rows
    loss = rbase.bce_with_logits(
        mod.forward({**live, **sub}, inputs.get("dense"), idx, cfg),
        inputs["labels"])
    loss.backward()
    return loss.item(), {k: (index, t.grad) for k, t in sub.items()}


def _recsys_train(torch, np, steps, arch, tree_lib):
    """(c) one recsys arch FULL at train_batch (65,536): its steps with
    the untouched rows' bits and the touched rows against a dense
    row-wise update."""
    from repro_torch.models.recsys import embedding as emb
    from repro_torch.optim import rowwise

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = steps.build_cell(arch, "train_batch", device="cuda")
    params, opt, inputs = cell.args
    cfg = steps.configs.get(arch).config
    torch.cuda.synchronize()
    b = inputs["sparse_idx"].shape[0]
    table = params["table"]
    dense_ref = arch in DENSE_REFERENCE
    _log(f"  (c) {arch} FULL train_batch ({b:,}): table {tuple(table.shape)}"
         f" ({table.numel() * 4 / 1e9:.2f} GB) + g2 in "
         f"{time.perf_counter() - t0:.1f} s; reference: "
         + ("the dense table gradient and a whole-table row-wise update"
            if dense_ref else "the touched rows' gradient (no room for a "
            "dense one beside the table) and their row-wise update"))
    mod = steps.RECSYS_MODULES[arch]
    row_cfg = rowwise.RowwiseAdagradConfig()
    offs = emb.cached_offsets(cfg.vocab_sizes, table.device)
    flat = (inputs["sparse_idx"].to(torch.int32) + offs[None, :])
    rows = torch.unique(flat.reshape(-1)).to(torch.int64)
    times = []
    gen = torch.Generator("cuda").manual_seed(7)
    for i in range(RECSYS_TRAIN_STEPS[arch]):
        tabs, _ = rowwise.split_tree(params)
        before = {k: (_word_sum(torch, t), _word_sum(torch, t[rows]),
                      opt["g2"][k].clone()) for k, t in tabs.items()}
        untouched = torch.ones(table.shape[0], dtype=torch.bool,
                               device="cuda")
        untouched[rows] = False
        sample = torch.randint(0, table.shape[0], (2 * UNTOUCHED_SAMPLE,),
                               device="cuda", generator=gen)
        sample = sample[untouched[sample]][:UNTOUCHED_SAMPLE]
        sample_before = {k: t[sample].clone() for k, t in tabs.items()}
        loss_chk, grads = _table_reference(torch, mod, cfg, params, inputs,
                                           rows, offs, flat, dense_ref)
        want = {}
        for k, (index, g) in grads.items():
            t0_ = tabs[k][index]
            new_t, new = rowwise.rowwise_update(
                g if g.dim() == 2 else g[:, None],
                {"g2": before[k][2][index]},
                t0_ if t0_.dim() == 2 else t0_[:, None], row_cfg)
            want[k] = (index, new_t, new["g2"], (g == 0).reshape(
                g.shape[0], -1).all(dim=1))
        del grads
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, new_opt, loss = cell.fn(*cell.args)
        loss = float(loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        opt = new_opt
        assert math.isfinite(loss) and abs(loss - loss_chk) <= 1e-5, (
            loss, loss_chk)
        worst = 0.0
        for k, t_ in rowwise.split_tree(params)[0].items():
            full0, rsum0, g2_0 = before[k]
            index, want_t, want_g2, zero = want[k]
            got = t_[index] if t_.dim() == 2 else t_[index][:, None]
            # rows with no gradient: the dense update leaves them as they
            # were, bit for bit; rows with one: within the bound
            assert torch.equal(got[zero], want_t[zero]), (arch, k)
            assert torch.equal(opt["g2"][k][index][zero], want_g2[zero])
            diff = (got - want_t).abs().amax(dim=1)[~zero]
            root = want_g2[~zero].sqrt()
            allowed = (row_cfg.lr * ROW_GRAD_REL * root.max()
                       / (root + row_cfg.eps) + 1e-6)
            worst = max(worst, float((diff / allowed).max()))
            assert bool((diff <= allowed).all()), (arch, k)
            g2_err = (opt["g2"][k][index] - want_g2).abs().max()
            assert float(g2_err) <= ROW_GRAD_REL * float(want_g2.max()), (
                arch, k)
            # untouched rows: the table's word sum less the touched rows'
            # is unchanged, a sample of them is bit-equal, g2 bit-equal
            assert (_word_sum(torch, t_) - _word_sum(torch, t_[rows])
                    == full0 - rsum0), f"{arch} {k}: untouched rows moved"
            assert torch.equal(t_[sample], sample_before[k])
            assert torch.equal(opt["g2"][k][untouched], g2_0[untouched])
        del want
        _log(f"    step {i}: loss {loss:.5f}, {rows.numel():,} touched rows "
             f"(against the {'whole-table' if dense_ref else 'touched-row'} "
             f"row-wise update: rows without a gradient bit-equal, worst "
             f"row at {worst:.2f} of its bound), untouched rows and g2 "
             f"bit-unchanged ({UNTOUCHED_SAMPLE:,} rows compared, word sums "
             f"equal), {times[-1] * 1e3:.2f} ms")
    steady = statistics.median(times[1:]) if len(times) > 1 else times[0]
    _log(f"    {arch}: {steady * 1e3:.2f} ms a step (median after the first, "
         f"{times[0] * 1e3:.2f} ms), {b / steady:,.0f} samples/s, peak "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del cell, params, opt, inputs, table
    return {"step_ms": steady * 1e3, "samples_per_s": b / steady,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def restart_replay(ckpt_dir: str) -> int:
    """(d)'s body, run in its own process (``chip_smoke.py
    --restart-replay DIR``) with ``CUBLAS_WORKSPACE_CONFIG`` set, so that
    deterministic algorithms are allowed: ``launch/train.py --smoke
    --deterministic`` for 40 steps with a checkpoint every 20, then a
    restart in this process to step 60, against an uninterrupted 60-step
    run; prints one JSON line."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import train

    common = ["--smoke", "--device", "cuda", "--deterministic",
              "--ckpt-every", str(RESTART["every"])]
    straight = train.run(train.parse_args(
        common + ["--steps", str(RESTART["steps"])]))
    ck = ["--ckpt-dir", ckpt_dir]
    first = train.run(train.parse_args(
        common + ck + ["--steps", str(RESTART["first"])]))
    second = train.run(train.parse_args(
        common + ck + ["--steps", str(RESTART["steps"])]))
    replayed = {**first["losses"], **second["losses"]}
    print(json.dumps({
        "start": second["start"],
        "equal": [s for s in range(RESTART["steps"])
                  if replayed[s] == straight["losses"][s]],
        "losses": [straight["losses"][s] for s in (0, 20, 40, 59)],
        "save_s": first["save_s"], "restore_s": second["restore_s"]}))
    return 0


def _restart_replay_on_the_card(tmp):
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--restart-replay",
         str(Path(tmp) / "train_ckpt")],
        capture_output=True, text=True, env=env, timeout=600)
    if out.returncode != 0:
        _log(out.stdout[-4000:])
        _log(out.stderr[-4000:])
        raise AssertionError(f"restart-replay exited {out.returncode}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["start"] == RESTART["first"], res
    assert res["equal"] == list(range(RESTART["steps"])), res["equal"]
    _log(f"  (d) launch/train.py --smoke --deterministic on the card: "
         f"{RESTART['first']} steps (checkpoint every {RESTART['every']}), "
         f"restart at {res['start']} to {RESTART['steps']} in the same "
         f"process: all {RESTART['steps']} losses bit-equal to an "
         f"uninterrupted run (losses at 0/20/40/59: {res['losses']}); save "
         f"calls {[round(s, 4) for s in res['save_s']]} s (async), restore "
         f"{res['restore_s']:.4f} s; {time.perf_counter() - t0:.1f} s with "
         "the process start")


def phase_training(torch, np, fa_ops, tmp):
    """Phase 13: the training substrate on the card."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree as tree_lib

    _auto_refuses_grad(torch, fa_ops)
    full = _lm_train_full(torch, np, steps, T, tree_lib)
    torch.cuda.empty_cache()
    _lm_train_smoke(torch, np, steps, T, tree_lib)
    recsys = {arch: _recsys_train(torch, np, steps, arch, tree_lib)
              for arch in RECSYS_TRAIN_STEPS}
    torch.cuda.empty_cache()
    _restart_replay_on_the_card(tmp)
    return full, recsys


# ---------------------------------------------------------------------------
# phase 14: the analysis plane's guards on the main path
# ---------------------------------------------------------------------------

SANITIZED_MAX_BATCH = 16  # the runtime's flush cap: sizes 1..16 driven
POISON_ROW = 4_321        # the doc row poisoned in a copy of the tensors


def _trips(rule: str) -> float:
    from repro_torch.obs.metrics import global_registry

    return sum(c.value for labels, c in global_registry().series(
        "ragdb_sanitizer_trips_total").items()
        if dict(labels).get("rule") == rule)


def _poisoned_paths(torch, sanitizers, snap, entities):
    """A copy of the served tensors with one doc row poisoned (NaN, then
    +inf), served through the snapshot's scoring on the map, gemm and
    kernel paths: each must trip the finite-score guard once (the
    poisoned row scores NaN, which ranks first on every path); the
    unpoisoned copy serves finite scores on each path first."""
    import dataclasses

    code, doc_idx = next(iter(entities.items()))
    out = []
    for path in ("map", "gemm", "kernel"):
        clean = dataclasses.replace(snap, scoring_path=path,
                                    kernel_operands=None)
        top = clean.query_batch([code], k=TOP_K)[0][0]
        assert top.doc_id == f"doc_{doc_idx:05d}.txt" and top.boosted, \
            (path, top)
        for poison in (float("nan"), float("inf")):
            dv = snap.doc_vecs.clone()
            dv[POISON_ROW] = poison
            bad = dataclasses.replace(clean, doc_vecs=dv)
            before = _trips("finite-scores")
            try:
                bad.query_batch([code], k=TOP_K)
            except sanitizers.SanitizerError as exc:
                assert "non-finite" in str(exc), exc
            else:
                raise AssertionError(f"{path}: a {poison} row did not trip")
            assert _trips("finite-scores") == before + 1, (path, poison)
            out.append(f"{path}/{poison}")
            del bad, dv
        torch.cuda.synchronize()
    return out


def phase_sanitized_serving(torch, ops, fa_ops, ctx):
    """Phase 14: phase 3's container served at full width through
    ``ServingRuntime`` + ``RAGPipeline`` under ``RAGDB_SANITIZERS=1``:
    the guards armed at k = 16 (every query bucket warmed, every prompt
    bucket and the decode step captured), then every flush size 1 ..
    SANITIZED_MAX_BATCH with generation — phase 3's ids, scores and
    tokens, no trip, no capture; a generation step the runtime did not
    warm, captured after arming, raising once and counting one trip; a
    poisoned copy of the served tensors tripping the finite-score guard
    on the map, gemm and kernel paths; and the static analyzer, strict
    against the committed audit, as a subprocess.  Returns the HSF and
    flash launches of the served flushes."""
    import os

    from repro_torch.analysis import sanitizers
    from repro_torch.configs import get as get_arch
    from repro_torch.core.ingest import KnowledgeBase
    from repro_torch.core.rag import RAGPipeline
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingRuntime

    os.environ[sanitizers.ENV_FLAG] = "1"
    sanitizers._enabled = None  # read the flag
    assert sanitizers.enabled()
    t0 = time.perf_counter()
    kb = KnowledgeBase.load(ctx["container"])
    cfg = get_arch(ARCH).config
    model = _served_model(torch, T, cfg)
    rt = ServingRuntime(kb, max_batch=SANITIZED_MAX_BATCH,
                        flush_deadline=0.05, result_cache_size=0)
    assert rt.engine.device.type == "cuda"
    assert rt.engine.scoring_path == "kernel"
    rag = RAGPipeline(kb, model, cfg, engine=rt.engine)
    _log(f"  set-up: container loaded, {cfg.name} FULL initialised "
         f"({time.perf_counter() - t0:.1f} s)")
    retrace0 = _trips("retrace")
    queries, flat, tokens = ctx["queries"], ctx["flat"], ctx["tokens"]
    with rt:
        t1 = time.perf_counter()
        rt.arm_sanitizers(k=TOP_K, rag=rag, max_new_tokens=MAX_NEW_TOKENS)
        steps = rag.steps
        assert rt.retrace_guard.armed and rag.retrace_guard is rt.retrace_guard
        assert steps.captures == len(steps.buckets()) + 1, steps.captures
        armed_counts = sanitizers.capture_counts()
        _log(f"  arm_sanitizers(k={TOP_K}): query buckets 1..."
             f"{SANITIZED_MAX_BATCH} warmed, prompt buckets "
             f"{steps.buckets()} + decode captured ({steps.captures} graphs,"
             f" {time.perf_counter() - t1:.2f} s)")

        # the counts are zeroed just before the served flushes, read after
        ops.reset_counts()
        fa_ops.reset_counts()
        before = rt.metrics.snapshot()
        t2 = time.perf_counter()
        at, served = 0, 0
        for size in range(1, SANITIZED_MAX_BATCH + 1):
            batch = [queries[(at + j) % len(queries)] for j in range(size)]
            at += size
            futs = [rt.submit(q, k=TOP_K) for q in batch]
            for q, fut in zip(batch, futs):
                res = fut.result(timeout=120).results
                assert [(r.doc_id, r.boosted, f"{r.score:.4f}")
                        for r in res] == flat[q], (size, q)
                out = rag.generate(q, res, MAX_NEW_TOKENS)
                assert out.token_ids == tokens[q], (size, q, out.token_ids)
                served += 1
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t2
        launches = dict(ops.counts)
        fa = dict(fa_ops.counts)
        after = rt.metrics.snapshot()
        flushes = after["batches"] - before["batches"]
        assert flushes == SANITIZED_MAX_BATCH, (flushes, before, after)
        assert after["batch_occupancy_max"] == SANITIZED_MAX_BATCH, after
        assert launches["launches"] == flushes and launches["unfused"] == 0, \
            launches
        assert fa == {"launches": N_LAYERS * served, "plain": 0}, fa
        assert rt.retrace_guard.report() == {}
        assert sanitizers.capture_counts() == armed_counts
        assert _trips("retrace") == retrace0
        _log(f"  flush sizes 1..{SANITIZED_MAX_BATCH}: {served} requests in "
             f"{flushes} flushes, each generating {MAX_NEW_TOKENS} tokens "
             f"({drive_s:.1f} s): phase 3's ids, scores and tokens; HSF "
             f"launches {launches['launches']} (= flushes, 0 unfused), flash "
             f"launches {fa['launches']} (= {N_LAYERS} × {served}, 0 plain); "
             "0 trips, 0 captures after arming")

        # a generation step the runtime did not warm, wired to its guard
        q = queries[0]
        res = rt.submit(q, k=TOP_K).result(timeout=120).results
        cold = RAGPipeline(kb, model, cfg, engine=rt.engine)
        cold.retrace_guard = rt.retrace_guard
        try:
            cold.generate(q, res, MAX_NEW_TOKENS)
        except sanitizers.SanitizerError as exc:
            msg = str(exc)
        else:
            raise AssertionError("a capture after arming did not trip")
        bucket = cold.steps.bucket(len(_prompt(cold, res, q)))
        grew = re.search(re.escape(f"{cfg.name}.prefill[{bucket}]: ")
                         + r"(\d+)→(\d+)", msg)
        assert grew and int(grew[2]) == int(grew[1]) + 1, msg
        assert _trips("retrace") == retrace0 + 1
        again = cold.generate(q, res, MAX_NEW_TOKENS)  # rebased: silent
        assert again.token_ids == tokens[q]
        assert _trips("retrace") == retrace0 + 1
        _log(f"  a prompt through an unwarmed GenerationSteps after arming: "
             f"one SanitizerError, one retrace trip ({msg[:120]}...); the "
             "guard rebased, the next request silent with phase 3's tokens")
        del cold

        poisoned = _poisoned_paths(torch, sanitizers, rt.snapshots.current,
                                   ctx["entities"])
        _log(f"  a copy of the served tensors with doc row {POISON_ROW} "
             f"poisoned: the finite-score guard tripped once each on "
             f"{', '.join(poisoned)}; the clean copy served the entity doc "
             "first on each path")
    del rag, model, kb, rt
    os.environ.pop(sanitizers.ENV_FLAG)
    sanitizers._enabled = None
    torch.cuda.empty_cache()

    t3 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--check-audit", "docs/ANALYSIS_AUDIT_TORCH.md"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:],
                                  proc.stderr[-2000:])
    _log(f"  python -m repro_torch.analysis --strict --check-audit "
         f"docs/ANALYSIS_AUDIT_TORCH.md: exit 0, "
         f"{proc.stdout.strip().splitlines()[-1]} "
         f"({time.perf_counter() - t3:.1f} s)")
    return launches["launches"], fa["launches"]


# ---------------------------------------------------------------------------
# phase 15: the GNN (mace) on the card
# ---------------------------------------------------------------------------

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule", "ogb_products")
GNN_STEPS = 3             # train steps a cell: lr 0, then two that move
# (b) card against CPU: one step on each side from the CPU's params, state
# and batch after GNN_WARM_STEPS steps on the CPU (Adam's moments carried,
# so an element whose gradient is rounding noise is not moved a whole
# learning rate), held to tests/test_torch_gnn.py's train-step bounds:
# the loss within rtol 1e-5, each gradient leaf within GNN_GRAD_TOL of its
# largest magnitude, the parameters within rtol 1e-5, atol 1e-6 (f32 with
# TF32 off; the card's index_add_ sums in atomic order)
GNN_WARM_STEPS = 2
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_TOL = 1e-4
GNN_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
GNN_CARD_VS_CPU = (("full_graph_sm", True), ("minibatch_lg", True),
                   ("molecule", True), ("full_graph_sm", False))
# (c) energy and forces at FULL on the molecule graph: invariance under a
# rotation plus a translation with the reference's tolerances
# (tests/test_models_gnn_recsys.py: energy rtol = atol = 2e-4, forces rtol
# = atol = 1e-3), and the card against the CPU with tests/test_torch_gnn.py's
# (energy 1e-5, forces 1e-4)
E3_ENERGY_TOL, E3_FORCE_TOL = 2e-4, 1e-3
GNN_ENERGY_TOL, GNN_FORCE_TOL = 1e-5, 1e-4
# (d) the dry run's cells: the GNN's (ogb_products uncut must not fit)
# and dlrm-mlperf's (its table alone is past the card)
GNN_DRYRUN_ARCHS = ("mace", "dlrm-mlperf")
# its worker processes: 4 collected it 25.8 s after the phase's start on
# the H100 host, 2 in 30.3 s, 8 in 42.3 s (workers crowding the phase's
# own CPU steps)
GNN_DRYRUN_JOBS = 4
GNN_DRYRUN_TIMEOUT = 300


def _gnn_cfg(smoke: bool, shape: str):
    """The cell's config: mace FULL or SMOKE at the shape's d_feat."""
    from dataclasses import replace

    from repro_torch.configs import get as get_arch
    from repro_torch.configs import shapes

    arch = get_arch("mace")
    cfg = arch.smoke_config if smoke else arch.config
    return replace(cfg, d_feat=shapes.GNN_SHAPES[shape].meta["d_feat"])


def _gnn_train_cell(torch, steps, tree_lib, shape, cut, baseline):
    """(a) one mace FULL cell on the card: GNN_STEPS steps, timed, the
    params' words moving in every leaf once the lr is above 0, a profiled
    step's idle share, the allocated bytes back at ``baseline``."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = steps.build_cell("mace", shape, device="cuda",
                            graph_cut=cut if shape == "ogb_products" else None)
    params, opt = cell.args[:2]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = cell.meta
    times, losses = [], []
    for i in range(GNN_STEPS):
        before = [_word_sum(torch, t) for t in tree_lib.leaves(params)]
        lr = float(steps.warmup_cosine(opt["step"], 3e-4, steps.WARMUP_STEPS,
                                       steps.TOTAL_STEPS))
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(cell.fn(*cell.args)[2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        after = [_word_sum(torch, t) for t in tree_lib.leaves(params)]
        changed = sum(a != b for a, b in zip(before, after))
        assert math.isfinite(loss), (shape, i, loss)
        # the reference's schedule starts at lr 0: the params keep their
        # bits; after it every leaf moves
        want = 0 if lr == 0.0 else len(before)
        assert changed == want, (shape, i, lr, changed, len(before))
        losses.append(loss)
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    _log(f"  (a) mace FULL {shape} ({m['kind']}): {m['n_nodes']:,} nodes, "
         f"{m['n_edges']:,} edges in {m['pad_nodes']:,} / "
         f"{m['pad_edges']:,} slots, d_feat {params['embed'].shape[0]}"
         + (f" (a base graph of {m['base_nodes']:,} nodes, "
            f"{m['base_edges']:,} edges; {m['sampled_nodes']:,} nodes, "
            f"{m['sampled_edges']:,} edges sampled)"
            if "base_nodes" in m else "")
         + f"; reduced: {m['reduced']}; built in {build_s:.1f} s")
    _log(f"    losses {[round(x, 5) for x in losses]} (finite; step 0 at lr "
         f"0 left every param's bits, steps 1-{GNN_STEPS - 1} moved every "
         f"leaf); {step_s * 1e3:.2f} ms a step (median of steps "
         f"1-{GNN_STEPS - 1}; step 0 {times[0] * 1e3:.2f} ms), "
         f"{m['n_nodes'] / step_s:,.0f} nodes/s, "
         f"{m['n_edges'] / step_s:,.0f} edges/s, peak {peak:.2f} GB "
         "allocated")
    idle = _profile(torch, lambda: cell.fn(*cell.args), step_s * 1e3,
                    f"a mace {shape} train step", mark="index",
                    mark_name="gathers and index_add_")
    del cell, params, opt
    now = _allocated(torch)
    assert now == baseline, (shape, now, baseline)
    return {"step_ms": step_s * 1e3, "nodes_per_s": m["n_nodes"] / step_s,
            "edges_per_s": m["n_edges"] / step_s, "peak_gb": peak,
            "idle": idle, "reduced": m["reduced"]}


def _gnn_grads(torch, steps, tree_lib, cfg, kind, params, batch):
    """The loss and its gradient leaves (zeros where the loss does not
    read a leaf) at ``params``."""
    live = tree_lib.map_(lambda p: p.detach().clone().requires_grad_(),
                         params)
    loss = steps.gnn_loss(live, batch, cfg, kind)
    loss.backward()
    return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in tree_lib.leaves(live)]


def _gnn_card_vs_cpu(torch, steps, tree_lib, shape, smoke):
    """(b) one train step and its gradients on the card against the CPU,
    from the CPU's params, state and batch."""
    from repro_torch.configs import shapes

    t0 = time.perf_counter()
    spec = shapes.GNN_SHAPES[shape]
    cfg = _gnn_cfg(smoke, shape)
    cpu = steps.build_cell("mace", shape, smoke=smoke, device="cpu")
    for _ in range(GNN_WARM_STEPS):
        cpu.fn(*cpu.args)
    card = tree_lib.map_(lambda t: t.cuda(), list(cpu.args))
    batches = [{**args[2], "n_graphs_static": spec.meta["n_graphs"]}
               for args in (cpu.args, card)]
    (l_cpu, g_cpu), (l_card, g_card) = (
        _gnn_grads(torch, steps, tree_lib, cfg, spec.kind, args[0], b)
        for args, b in zip((cpu.args, card), batches))
    assert abs(l_card - l_cpu) <= GNN_LOSS_RTOL * abs(l_cpu), (l_card, l_cpu)
    worst_g = 0.0
    for a, b in zip(g_cpu, g_card):
        scale = float(a.abs().max())
        err = float((b.cpu() - a).abs().max())
        assert err <= GNN_GRAD_TOL * scale, (shape, smoke, err, scale)
        worst_g = max(worst_g, err / scale if scale else 0.0)
    _, _, loss_cpu = cpu.fn(*cpu.args)
    _, _, loss_card = cpu.fn(*card)
    loss_cpu, loss_card = float(loss_cpu), float(loss_card)
    assert abs(loss_card - loss_cpu) <= GNN_LOSS_RTOL * abs(loss_cpu)
    worst_p = 0.0
    for a, b in zip(tree_lib.leaves(cpu.args[0]), tree_lib.leaves(card[0])):
        b = b.cpu()
        assert torch.allclose(b, a, **GNN_PARAM_TOL), (shape, smoke)
        worst_p = max(worst_p, float((b - a).abs().max()))
    _log(f"  (b) mace {'SMOKE' if smoke else 'FULL'} {shape}: card vs CPU "
         f"after {GNN_WARM_STEPS} CPU steps: loss {l_card:.6f} vs "
         f"{l_cpu:.6f}, gradients within {worst_g:.1e} of each leaf's "
         f"largest (bound {GNN_GRAD_TOL:.0e}); one step: loss "
         f"{loss_card:.6f} vs {loss_cpu:.6f}, params within {worst_p:.1e} "
         f"(rtol 1e-5, atol 1e-6); {time.perf_counter() - t0:.1f} s")
    del card


def _gnn_forces(torch, np, steps, tree_lib):
    """(c) ``energy_and_forces`` at FULL on the molecule graph (128
    graphs): invariance and co-rotation on the card, card = CPU."""
    from repro_torch.models.gnn import mace

    cfg = _gnn_cfg(False, "molecule")
    cpu = steps.build_cell("mace", "molecule", device="cpu")
    params, _, batch = cpu.args
    rng = np.random.default_rng(11)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.from_numpy(q.astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=(1, 3)).astype(np.float32))

    def run(p, b, pos):
        return mace.energy_and_forces(
            p, b["node_feats"], pos, b["senders"], b["receivers"], cfg,
            edge_mask=b["edge_mask"], graph_ids=b["graph_ids"],
            n_graphs=128)

    cp = tree_lib.map_(lambda t: t.cuda(), params)
    cb = {k: v.cuda() for k, v in batch.items()}
    e0, f0 = run(cp, cb, cb["positions"])
    e1, f1 = run(cp, cb, cb["positions"] @ rot.cuda().T + shift.cuda())
    e0, e1 = float(e0), float(e1)
    assert abs(e1 - e0) <= E3_ENERGY_TOL * (1 + abs(e0)), (e0, e1)
    want = f0 @ rot.cuda().T
    assert torch.allclose(f1, want, rtol=E3_FORCE_TOL, atol=E3_FORCE_TOL)
    e_cpu, f_cpu = run(params, batch, batch["positions"])
    e_cpu = float(e_cpu)
    assert abs(e0 - e_cpu) <= GNN_ENERGY_TOL * (1 + abs(e_cpu)), (e0, e_cpu)
    assert torch.allclose(f0.cpu(), f_cpu, rtol=GNN_FORCE_TOL,
                          atol=GNN_FORCE_TOL)
    _log(f"  (c) mace FULL energy_and_forces on molecule (128 graphs, "
         f"{int(batch['edge_mask'].sum()):,} edges): E {e0:.6f}, under a "
         f"rotation + translation {e1:.6f} (|ΔE| {abs(e1 - e0):.2e}), forces "
         f"co-rotate within {float((f1 - want).abs().max()):.2e} (largest "
         f"|F| {float(f0.abs().max()):.3f}); CPU E {e_cpu:.6f}, forces within "
         f"{float((f0.cpu() - f_cpu).abs().max()):.2e}")
    del cp, cb, f0, f1, want


class _DryRun:
    """``python -m repro_torch.launch.dryrun --arch mace --arch
    dlrm-mlperf --mesh single --out DIR`` in the background, started at
    phase 15's start so that its counting overlaps the card's work.  Its
    process group (its workers too) is killed and its directory removed
    at exit if it is still there."""

    def __init__(self):
        import atexit
        import os

        self.dir = tempfile.TemporaryDirectory()
        self.out = self.dir.name
        self.t0 = time.perf_counter()
        archs = [a for arch in GNN_DRYRUN_ARCHS for a in ("--arch", arch)]
        # a session of its own, so that its workers die with it
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *archs,
             "--mesh", "single", "--out", self.out, "--jobs",
             str(GNN_DRYRUN_JOBS)], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(SRC)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        atexit.register(self.stop)

    def stop(self) -> None:
        import os
        import signal

        if self.proc.returncode is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            with contextlib.suppress(subprocess.TimeoutExpired):
                self.proc.communicate(timeout=30)
        self.dir.cleanup()


def _gnn_dryrun(dry: _DryRun, cut: int, cut_rec: dict):
    """(d) the dry run's exit and its records: every cell of
    ``GNN_DRYRUN_ARCHS`` counted, the fit verdicts printed and held."""
    from repro_torch import configs

    proc = dry.proc
    try:
        stdout, stderr = proc.communicate(timeout=GNN_DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        dry.stop()
        raise
    assert proc.returncode == 0, (proc.returncode, stdout[-3000:],
                                  stderr[-3000:])
    recs = {}
    for path in Path(dry.out).glob("*.json"):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"])] = rec
    assert set(recs) == {c for c in configs.cells()
                         if c[0] in GNN_DRYRUN_ARCHS}, sorted(recs)
    first = next(iter(recs.values()))
    _log(f"  (d) python -m repro_torch.launch.dryrun "
         f"{' '.join('--arch ' + a for a in GNN_DRYRUN_ARCHS)} --mesh "
         f"single: exit 0, {len(recs)} cells counted on meta, collected "
         f"{time.perf_counter() - dry.t0:.1f} s after its start (card: "
         f"{first['card']}, {first['card_bytes'] / 1e9:.2f} GB); argument + "
         "temp GB, fits one card:")
    for (arch, shape), rec in sorted(recs.items()):
        mem = rec["memory"]
        _log(f"    {arch:22s} {shape:15s} "
             f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:10.2f} "
             f"{rec['fits_one_card']}")
    assert not recs[("mace", "ogb_products")]["fits_one_card"]
    assert cut_rec["fits_one_card"], cut_rec["memory"]
    mlperf = [s for a, s in recs if a == "dlrm-mlperf"]
    assert mlperf and not any(recs[("dlrm-mlperf", s)]["fits_one_card"]
                              for s in mlperf)
    mem = cut_rec["memory"]
    _log(f"    ogb_products uncut does not fit; at graph_cut {cut} "
         f"({cut_rec['reduced']}) "
         f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.2f} GB fits; "
         f"dlrm-mlperf's {len(mlperf)} cells (its 96.1 GB table) do not fit")
    return recs


def phase_gnn(torch, np):
    """Phase 15: mace on the card, the dry run counting meanwhile and
    collected last."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps
    from repro_torch.optim import tree as tree_lib

    dry = _DryRun()
    try:
        cut, rec = dryrun.smallest_fitting_cut("mace", "ogb_products")
        mem = rec["memory"]
        _log(f"  the dry run's smallest graph_cut of ogb_products that fits "
             f"one card: {cut} (argument + temp "
             f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.2f} GB of "
             f"{rec['card_bytes'] / 1e9:.2f})")
        baseline = _allocated(torch)
        cells = {shape: _gnn_train_cell(torch, steps, tree_lib, shape, cut,
                                        baseline) for shape in GNN_SHAPES}
        for shape, smoke in GNN_CARD_VS_CPU:
            _gnn_card_vs_cpu(torch, steps, tree_lib, shape, smoke)
        _gnn_forces(torch, np, steps, tree_lib)
        assert _allocated(torch) == baseline
        _gnn_dryrun(dry, cut, rec)
    finally:
        dry.stop()
    return cut, cells


# ---------------------------------------------------------------------------
# phase 16: the decode attention core (csrc/decode_attention.cu)
# ---------------------------------------------------------------------------

# the benchmark's decode cache: the 2,048 bucket plus 8 answer tokens
DECODE_SLOTS = 2_056
DECODE_FILLS = (1, 1_024, 1_950, 2_056)
DECODE_TIMED_FILL = 1_950  # the benchmark's prompts, ~1,950 tokens
# kernel vs plain, of the plain output's max |o|: p rounded to bf16 at
# the split's running max instead of the global one, another summation
# order, and the output rounded to bf16 (a few bf16 ulps)
DECODE_TOL = 2e-2
DECODE_ARCHS = ("qwen3-moe-30b-a3b", "llama3.2-3b", "gemma3-27b")
# phase 9's long caches, (arch, batch, slots), each filled to the end: a
# split streams 8 (qwen3) to 125 (long_500k) 64-row tiles on an H100's
# 132 SMs, so both stages of the kernel's pipeline are refilled many times
DECODE_LONG = (("qwen3-moe-30b-a3b", 1, 32_768), ("llama3.2-3b", 1, 32_768),
               ("gemma3-27b", 1, 32_768), ("llama3.2-3b", 8, 32_768),
               ("llama3.2-3b", 1, 262_144))
# the layers each arch's decode step sends to the kernel, from the
# config alone (not has_design): every layer of the GQA archs with Dh
# 128, gemma3's global layers (its local ones use a ring cache), none of
# gemma2's (Dh 256, softcap) or deepseek's (MLA's absorbed decode)
DECODE_DESIGNED = {
    "llama3.2-3b": lambda cfg: cfg.n_layers,
    "qwen3-moe-30b-a3b": lambda cfg: cfg.n_layers,
    "gemma3-27b": lambda cfg: cfg.layer_kinds.count("global"),
    "gemma2-9b": lambda cfg: 0,
    "deepseek-v2-lite-16b": lambda cfg: 0,
}


def _decode_expected_layers(torch, T, da_ops, arch, cfg) -> int:
    """DECODE_DESIGNED's count for the arch, checked against what
    ``has_design`` accepts of the decode step's operands."""
    want = DECODE_DESIGNED[arch](cfg)
    got = _decode_designed_layers(torch, T, da_ops, cfg)
    assert got == want, (arch, got, want)
    return want


# the MoE layers each arch's decode step sends to the MoE decode kernel,
# from the config alone: every MoE layer of the two MoE archs (bf16
# experts, a float32 router, widths the kernel tiles), none of the dense
# archs'
MOE_DECODE_DESIGNED = {
    "llama3.2-3b": lambda cfg: 0,
    "gemma2-9b": lambda cfg: 0,
    "gemma3-27b": lambda cfg: 0,
    "qwen3-moe-30b-a3b": lambda cfg: cfg.n_layers,
    "deepseek-v2-lite-16b": lambda cfg: cfg.n_layers - cfg.n_dense_head_layers,
}


def _moe_decode_expected_layers(torch, md_ops, arch, cfg) -> int:
    """MOE_DECODE_DESIGNED's count for the arch, checked against what
    ``has_design`` accepts of one decode token's operands (as the served
    model holds them: compute-dtype experts, a float32 router), as shapes
    on the meta device."""
    want = MOE_DECODE_DESIGNED[arch](cfg)
    got = 0
    if cfg.moe is not None:
        m, d, dt = cfg.moe, cfg.d_model, cfg.compute_dtype
        e, f = m.n_experts, m.d_ff_expert

        def meta(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device="meta")

        params = {"router": meta(d, e, dtype=torch.float32),
                  "w_gate": meta(e, d, f), "w_up": meta(e, d, f),
                  "w_down": meta(e, f, d)}
        if md_ops.has_design(meta(1, d), params, m):
            got = cfg.n_layers - cfg.n_dense_head_layers
    assert got == want, (arch, got, want)
    return want


def _decode_designed_layers(torch, T, da_ops, cfg) -> int:
    """The layers whose decode attention the kernel has a design for:
    ``has_design`` on the operands the decode step gives it, as shapes
    on the meta device."""
    hd, dt = cfg.head_dim, cfg.compute_dtype
    q = torch.empty((1, cfg.n_heads, 1, hd), dtype=dt, device="meta")
    kv = torch.empty((1, cfg.n_kv_heads, 1, hd), dtype=dt, device="meta")
    return sum(da_ops.has_design(
        q, kv, kv, c["k"], c["v"], softcap=cfg.attn_softcap,
        window=cfg.window if kind == "local" else None)
        for kind, c in zip(cfg.layer_kinds,
                           T.init_cache(cfg, 1, 2, device="meta"))
        if "k" in c)


def _decode_operands(torch, cfg, b, seed, n_slots=DECODE_SLOTS):
    """q, k_new, v_new as the projections give them ([B, 1, H, Dh]
    transposed views), a filled bf16 cache of ``n_slots`` slots, the
    qk-norm gains (or None) and the arguments of the call."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    r = lambda *shape: torch.randn(  # noqa: E731
        shape, device="cuda", generator=gen).to(torch.bfloat16)
    q = r(b, 1, hq, hd).transpose(1, 2)
    k_new = r(b, 1, hkv, hd).transpose(1, 2)
    v_new = r(b, 1, hkv, hd).transpose(1, 2)
    caches = (r(b, hkv, n_slots, hd), r(b, hkv, n_slots, hd))
    gains = [0.3 * torch.randn(hd, device="cuda", generator=gen)
             for _ in range(2)] if cfg.qk_norm else [None, None]
    kw = dict(scale=cfg.attn_scale, rope_base=cfg.rope_base,
              q_norm=gains[0], k_norm=gains[1])
    return (q, k_new, v_new), caches, kw


def _decode_against_plain(torch, da_ops, da_ref, arch, cfg, fills,
                          n_slots=DECODE_SLOTS):
    """One call of the kernel against ref.py on copies of one cache of
    ``n_slots`` slots: the output within DECODE_TOL, every slot but the
    new ones bit-equal, the new slots within one bf16 ulp.  Returns
    max |Δ| / max |o|."""
    heads, caches, kw = _decode_operands(torch, cfg, len(fills), seed=sum(
        fills), n_slots=n_slots)
    lengths = torch.tensor(fills, dtype=torch.int32, device="cuda")
    mine = [c.clone() for c in caches]
    plain = [c.clone() for c in caches]
    got = da_ops.decode_attention(*heads, *mine, lengths, **kw)
    want = da_ref.decode_attention_ref(*heads, *plain, lengths, **kw)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item() / scale
    assert torch.isfinite(got).all() and err <= DECODE_TOL, (arch, fills, err)
    rows = torch.arange(len(fills), device="cuda")
    slots = (lengths.long() - 1) % n_slots
    new_err, new_equal = 0.0, True
    for m, p in zip(mine, plain):
        new_m, new_p = m[rows, :, slots], p[rows, :, slots]
        new_equal &= _same_bits(torch, new_m, new_p)
        new_err = max(new_err, (new_m.float() - new_p.float()).abs().max()
                      .item() / new_p.float().abs().max().item())
        m[rows, :, slots] = new_p
        assert _same_bits(torch, m, p), (arch, fills, "cache")
    assert new_err <= 2 ** -7, (arch, fills, new_err)
    shown = list(fills) if len(set(fills)) > 1 or len(fills) == 1 \
        else f"{len(fills)} × {fills[0]}"
    n_split = da_ops.splits(len(fills), cfg.n_kv_heads, n_slots,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    chunk = -(-max(fills) // n_split)  # the kernel's rows a split
    _log(f"  {arch} (Hq {cfg.n_heads}, Hkv {cfg.n_kv_heads}, qk-norm "
         f"{cfg.qk_norm}), fills {shown} of {n_slots} ({n_split} splits, "
         f"{-(-chunk // da_ops.TILE)} tiles a split): max |Δ| / "
         f"max |o| {err:.2e} (tol {DECODE_TOL:g}); the cache bit-equal but "
         f"the new slots, which are {'bit-equal' if new_equal else 'within'}"
         f" {new_err:.1e} of their max (one bf16 ulp {2 ** -7:.1e})")
    return err


def _decode_graph(torch, steps, da_ops, cfg):
    """A CUDA graph of the call replays the eager call's bits (output
    and whole cache), a second input too; each replay counts a launch."""
    heads, caches, kw = _decode_operands(torch, cfg, 1, seed=21)
    lengths = torch.tensor([DECODE_TIMED_FILL], dtype=torch.int32,
                           device="cuda")
    eager = [c.clone() for c in caches]
    graphed = [c.clone() for c in caches]
    fn = lambda q, kn, vn, kc, vc, ln: da_ops.decode_attention(  # noqa: E731
        q, kn, vn, kc, vc, ln, **kw)
    step = steps.CapturedStep(fn, (*heads, *graphed, lengths), "cuda")
    before = da_ops.counts["launches"]
    got = step()
    want = fn(*heads, *eager, lengths)
    assert _same_bits(torch, got, want) and _same_bits(torch, graphed, eager)
    other, _, _ = _decode_operands(torch, cfg, 1, seed=22)
    lengths2 = lengths - 700
    got = step(*other, *graphed, lengths2)
    want = fn(*other, *eager, lengths2)
    assert _same_bits(torch, got, want) and _same_bits(torch, graphed, eager)
    assert da_ops.counts["launches"] == before + 4, da_ops.counts
    _log(f"  a CUDA graph of the call: replays equal the eager calls bit for "
         "bit (output and the whole cache), at two fills and inputs; one "
         "launch counted a replay")


def _decode_timing(torch, da_ops, da_ref, arch, cfg):
    """The kernel at the benchmark's fill, beside its bound (the filled
    K and V read once), the plain path and SDPA on the rotated q over
    the filled slots (attention alone: the library yardstick)."""
    import torch.nn.functional as F

    heads, caches, kw = _decode_operands(torch, cfg, 1, seed=23)
    fill = DECODE_TIMED_FILL
    lengths = torch.tensor([fill], dtype=torch.int32, device="cuda")
    positions = (lengths - 1)[:, None].to(torch.int64)
    q_rot = da_ref.rotate(heads[0], kw["q_norm"], positions, kw["rope_base"])
    kc, vc = caches
    kernel = lambda: da_ops.decode_attention(  # noqa: E731
        *heads, *caches, lengths, **kw)
    plain = lambda: da_ref.decode_attention_ref(  # noqa: E731
        *heads, *caches, lengths, **kw)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q_rot, kc[:, :, :fill], vc[:, :, :fill], scale=kw["scale"],
        enable_gqa=True)
    for fn in (kernel, plain, library):
        fn()
    torch.cuda.synchronize()
    out = {"ms": _queued_ms(torch, kernel, 50, 5),
           "plain_ms": _queued_ms(torch, plain, 10, 3),
           "library_ms": _queued_ms(torch, library, 50, 5)}
    again = _queued_ms(torch, kernel, 50, 5)
    nbytes = 2 * cfg.n_kv_heads * fill * cfg.head_dim * 2
    out.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    _log(f"  {arch} at fill {fill}: kernel {out['ms'] * 1e3:.2f} us (again "
         f"{again * 1e3:.2f}), bound {out['bound_ms'] * 1e3:.2f} us "
         f"({nbytes / 1e6:.2f} MB of K and V / 3.35 TB/s; kernel at "
         f"{out['bound_ms'] / out['ms']:.1%} of it), plain path "
         f"{out['plain_ms'] * 1e3:.2f} us, SDPA (attention alone) "
         f"{out['library_ms'] * 1e3:.2f} us")
    return out


def _launches_profiled(torch, fn):
    """Kernels (and copies, memsets) the profiler records for one call.
    After many profiler sessions in one process it can lose records
    (phase 16 of a whole run read 0 and 28 where a run of the phase alone
    read 2 and 87), so it is printed beside the exact count below."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(count for _, count, _ in _kernel_rows(prof, 1))


def _graph_nodes(torch, fn) -> int:
    """The nodes (kernels, copies, memsets) of a CUDA graph captured from
    one call of ``fn``: the launches a replay of it makes (the driver's
    ``cuGraphGetNodes``)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert err == 0, f"cuGraphGetNodes: CUresult {err}"
    del graph
    return n.value


def _decode_launch_counts(torch, T, da_ops, da_ref):
    """Launches of the attention core alone, kernel and plain, and of an
    eager qwen3-moe FULL-width decode step a layer (the step at 2 layers
    less at 1), with the kernel and with the plain path: exact from a
    captured graph's nodes, and as the profiler records them."""
    import dataclasses

    from repro_torch.configs import get as get_arch

    cfg = get_arch("qwen3-moe-30b-a3b").config
    heads, caches, kw = _decode_operands(torch, cfg, 1, seed=24)
    lengths = torch.tensor([DECODE_TIMED_FILL], dtype=torch.int32,
                           device="cuda")
    calls = {"kernel": lambda: da_ops.decode_attention(
        *heads, *caches, lengths, **kw),
        "plain": lambda: da_ref.decode_attention_ref(
            *heads, *caches, lengths, **kw)}
    out = {"core": {k: _graph_nodes(torch, fn) for k, fn in calls.items()},
           "core_profiled": {k: _launches_profiled(torch, fn)
                             for k, fn in calls.items()}}
    assert out["core"]["kernel"] == 2, out
    step, profiled = {}, {}
    designed = da_ops.has_design
    for route in ("kernel", "plain"):
        if route == "plain":
            da_ops.has_design = lambda *a, **k: False
        try:
            counts = []
            for n_layers in (1, 2):
                c = dataclasses.replace(cfg, n_layers=n_layers)
                model = T.init(c, torch.Generator(device="cuda").manual_seed(
                    25))
                _, cache, _ = T.prefill(
                    model, torch.zeros((1, 16), dtype=torch.int64,
                                       device="cuda"), c, DECODE_SLOTS)
                tok = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
                fn = lambda: T.decode_step(  # noqa: E731
                    model, cache, tok, lengths, c)
                counts.append((_graph_nodes(torch, fn),
                               _launches_profiled(torch, fn)))
                del model, cache, fn
            step[route] = counts[1][0] - counts[0][0]
            profiled[route] = counts[1][1] - counts[0][1]
        finally:
            da_ops.has_design = designed
    assert step["plain"] - step["kernel"] == \
        out["core"]["plain"] - out["core"]["kernel"], (step, out)
    out.update(step_per_layer=step, step_per_layer_profiled=profiled)
    torch.cuda.empty_cache()
    _log(f"  launches (a captured graph's nodes; the profiler's count in "
         f"brackets): the attention core {out['core']['kernel']} "
         f"[{out['core_profiled']['kernel']}] with the kernel, "
         f"{out['core']['plain']} [{out['core_profiled']['plain']}] plain; "
         f"a qwen3-moe FULL decode step a layer {step['kernel']} "
         f"[{profiled['kernel']}] with the kernel, {step['plain']} "
         f"[{profiled['plain']}] with the plain path")
    return out


def phase_decode_attention(torch, T, steps, da_ops, da_ref):
    """Phase 16: the kernel against ref.py at the benchmark's cache for
    qwen3-moe (32:4, qk-norm), llama3.2 (24:8) and gemma3's global layers
    (32:16, qk-norm, query scale), at fills 1, 1,024, 1,950 and 2,056 and
    two rows of other fills, then at DECODE_LONG's caches; a graph replay against eager; times; the
    launches the profiler counts before and after."""
    from repro_torch.configs import get as get_arch

    da_ops.reset_counts()
    worst, times = 0.0, {}
    for arch in DECODE_ARCHS:
        cfg = get_arch(arch).config
        for fill in DECODE_FILLS:
            worst = max(worst, _decode_against_plain(
                torch, da_ops, da_ref, arch, cfg, (fill,)))
        worst = max(worst, _decode_against_plain(
            torch, da_ops, da_ref, arch, cfg, (DECODE_TIMED_FILL, 7)))
    for arch, b, n_slots in DECODE_LONG:
        worst = max(worst, _decode_against_plain(
            torch, da_ops, da_ref, arch, get_arch(arch).config,
            (n_slots,) * b, n_slots))
        torch.cuda.empty_cache()
    _decode_graph(torch, steps, da_ops, get_arch(DECODE_ARCHS[0]).config)
    for arch in DECODE_ARCHS:
        times[arch] = _decode_timing(torch, da_ops, da_ref, arch,
                                     get_arch(arch).config)
    launches = _decode_launch_counts(torch, T, da_ops, da_ref)
    assert da_ops.counts["plain"] == 0, da_ops.counts
    return {"max_abs_err": worst, **times[DECODE_ARCHS[0]],
            "by_shape": times, "launch_counts": launches}


# ---------------------------------------------------------------------------
# phase 17: the MoE decode layer (csrc/moe_decode.cu)
# ---------------------------------------------------------------------------

MOE_DECODE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
# the tokens a call is timed at, kernel against the grouped path: the
# wrapper's MAX_TOKENS is chosen from these
MOE_DECODE_TOKENS = (1, 2, 4, 8, 16, 32)
# kernel vs ref.py, of ref's max |out|: another summation order in the
# products, which can move a bf16 rounding of g, u, h or y by one ulp
MOE_DECODE_TOL = 2e-2
# distinct layers' weights a timed graph runs through in turn, so that
# each call reads its experts from device memory as a decode step does
# (one layer's K experts, 75.5 MB for qwen3, outgrow the 50 MB L2 alone)
MOE_DECODE_LAYERS = 4


def _moe_decode_layer(torch, moe, cfg, seed):
    """One MoE layer's routed experts at the arch's widths as the serving
    model holds them: ``moe.init``'s distributions, bf16 experts, a float32
    router; no shared experts."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = moe.init(gen, cfg.moe, cfg.d_model, device="cuda")
    return {n: w if n == "router" else w.to(torch.bfloat16)
            for n, w in params.items()}


def _moe_decode_bytes(cfg, ids) -> int:
    """The bytes a call must read: the experts its tokens chose (three bf16
    matrices each), once; the router and the activations left out."""
    m = cfg.moe
    return len(set(ids.flatten().tolist())) * 3 * cfg.d_model \
        * m.d_ff_expert * 2


def _moe_decode_against_ref(torch, md_ops, md_ref, moe, arch, cfg, params,
                            t):
    """One call at T tokens against ref.py: the same expert ids, the gates
    within 1e-5, the output within MOE_DECODE_TOL.  Returns max |Δ| / max
    |out|."""
    gen = torch.Generator(device="cuda").manual_seed(100 + t)
    x = torch.randn((t, cfg.d_model), device="cuda", generator=gen) \
        .to(torch.bfloat16)
    got, gates, ids = md_ops._launch(x, params, cfg.moe)
    _, want_gates, want_ids = moe.route(params, x, cfg.moe)
    want = md_ref.moe_decode_ref(x, params, cfg.moe)
    torch.cuda.synchronize()
    assert torch.equal(ids.long(), want_ids), (arch, t, ids, want_ids)
    gate_err = (gates - want_gates).abs().max().item()
    assert gate_err <= 1e-5, (arch, t, gate_err)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item() / scale
    assert torch.isfinite(got).all() and err <= MOE_DECODE_TOL, (arch, t, err)
    return err


# replays of a captured call held to the eager bits, by T: the down
# kernel reads ids and gates before its wait (``moe_decode_launch``), so
# T = 8, the most the wrapper takes, is replayed many times
MOE_DECODE_REPLAYS = {1: 2, 2: 2, 8: 50}


def _moe_decode_graph(torch, steps, md_ops, cfg, params):
    """A CUDA graph of the call replays the eager call's bits on new
    inputs, MOE_DECODE_REPLAYS times at each T; each replay counts one
    launch."""
    for t, n in MOE_DECODE_REPLAYS.items():
        gen = torch.Generator(device="cuda").manual_seed(200 + t)
        xs = [torch.randn((t, cfg.d_model), device="cuda", generator=gen)
              .to(torch.bfloat16) for _ in range(n)]
        fn = lambda x: md_ops.moe_decode(x, params, cfg.moe)  # noqa: E731
        step = steps.CapturedStep(fn, (xs[0].clone(),), "cuda")
        before = md_ops.counts["launches"]
        for x in xs:
            got = step(x)
            assert _same_bits(torch, got, fn(x)), t
        assert md_ops.counts["launches"] == before + 2 * n, md_ops.counts
        del step


def _moe_decode_non_finite(torch, md_ops, md_ref, moe, cfg, params):
    """A NaN, then an inf, in one of four tokens: no fault, every id in
    [0, E), that token routed to experts 0 .. k-1 (``moe.route``'s order:
    NaN above every number) with NaN gates and a NaN output row, the
    other tokens' ids and bits as with that row zeroed; then a clean call
    matches ref.py."""
    m = cfg.moe
    for bad in (float("nan"), float("inf")):
        gen = torch.Generator(device="cuda").manual_seed(250)
        x = torch.randn((4, cfg.d_model), device="cuda", generator=gen) \
            .to(torch.bfloat16)
        x[2, 100] = bad
        got, gates, ids = md_ops._launch(x, params, m)
        torch.cuda.synchronize()
        assert bool(((ids >= 0) & (ids < m.n_experts)).all()), ids
        assert ids[2].tolist() == list(range(m.top_k)), ids
        assert bool(torch.isnan(gates[2]).all() & torch.isnan(got[2]).all())
        rest, clean = [0, 1, 3], x.clone()
        clean[2] = 0
        want, _, want_ids = md_ops._launch(clean, params, m)
        assert torch.equal(ids[rest], want_ids[rest])
        assert torch.equal(ids[rest].long(),
                           moe.route(params, clean, m)[2][rest])
        assert _same_bits(torch, got[rest], want[rest])
    x = torch.randn((1, cfg.d_model), device="cuda", generator=gen) \
        .to(torch.bfloat16)
    want = md_ref.moe_decode_ref(x, params, m).float()
    err = (md_ops.moe_decode(x, params, m).float() - want).abs().max()
    assert err <= MOE_DECODE_TOL * want.abs().max(), err


def _moe_decode_timing(torch, md_ops, md_ref, moe, cfg, layers, t):
    """Device time of one MoE layer call at T tokens in ms: the kernel
    (``ms``), its plain version ``ref.py`` (``plain_ms``: route, sort,
    grouped products, combine; what the decode step runs without a
    design) and the grouped path the decode step ran before the kernel
    (``apply_ms``: ``moe.apply``, the same and the aux loss), each a CUDA
    graph over MOE_DECODE_LAYERS layers in turn, replayed back to back;
    the kernel's bound (the chosen experts read once at 3.35 TB/s); each
    path's graph nodes a call.  No library computes the layer
    (``library_ms`` None)."""
    gen = torch.Generator(device="cuda").manual_seed(300 + t)
    x = torch.randn((t, cfg.d_model), device="cuda", generator=gen) \
        .to(torch.bfloat16)
    paths = {"": lambda p: md_ops._launch(x, p, cfg.moe)[0],
             "plain_": lambda p: md_ref.moe_decode_ref(x, p, cfg.moe),
             "apply_": lambda p: moe.apply(p, x, cfg.moe)[0]}
    out = {}
    for name, fn in paths.items():
        def run(fn=fn):
            for p in layers:
                fn(p)
        run()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()
        out[f"{name}ms"] = _queued_ms(torch, graph.replay, 20, 5) \
            / len(layers)
        out[f"{name}nodes"] = _graph_nodes(torch, lambda: fn(layers[0]))
        del graph
    nbytes = statistics.mean(
        _moe_decode_bytes(cfg, moe.route(p, x, cfg.moe)[2]) for p in layers)
    out.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    return out


def phase_moe_decode(torch, steps, md_ops, md_ref):
    """Phase 17: the kernel against ref.py at qwen3-moe's and
    deepseek-v2-lite's MoE widths, T = 1 … 32; graph replays against
    eager; a NaN and an inf in x; the kernel, ref.py and the grouped path
    timed at each T against the kernel's bound."""
    from repro_torch.configs import get as get_arch
    from repro_torch.models import moe

    md_ops.reset_counts()
    worst, times = 0.0, {}
    for arch in MOE_DECODE_ARCHS:
        cfg = get_arch(arch).config  # the routed experts alone
        m = dataclasses.replace(cfg.moe, n_shared=0)
        cfg = dataclasses.replace(cfg, moe=m)
        layers = [_moe_decode_layer(torch, moe, cfg, seed=400 + i)
                  for i in range(MOE_DECODE_LAYERS)]
        errs = [_moe_decode_against_ref(torch, md_ops, md_ref, moe, arch,
                                        cfg, layers[0], t)
                for t in MOE_DECODE_TOKENS]
        worst = max(worst, *errs)
        _moe_decode_graph(torch, steps, md_ops, cfg, layers[0])
        _moe_decode_non_finite(torch, md_ops, md_ref, moe, cfg, layers[0])
        _log(f"  {arch} (E {m.n_experts}, top {m.top_k}, F {m.d_ff_expert}, "
             f"D {cfg.d_model}, norm_topk {m.norm_topk}): ids equal to "
             "moe.route's, gates within 1e-5, max |Δ| / max |out| "
             + ", ".join(f"T={t} {e:.2e}" for t, e in
                         zip(MOE_DECODE_TOKENS, errs))
             + f" (tol {MOE_DECODE_TOL:g}); graph replays == eager bit for "
             "bit (" + ", ".join(f"T={t} {n}×" for t, n in
                                 MOE_DECODE_REPLAYS.items())
             + "), one launch counted a replay; a NaN and an inf in x: ids "
             "in range, that token's row NaN, the others' bits unchanged")
        times[arch] = {}
        for t in MOE_DECODE_TOKENS:
            r = times[arch][t] = _moe_decode_timing(torch, md_ops, md_ref,
                                                    moe, cfg, layers, t)
            _log(f"  {arch} T={t}: kernel {r['ms'] * 1e3:.2f} us "
                 f"({r['nodes']} nodes), ref.py {r['plain_ms'] * 1e3:.2f} us "
                 f"({r['plain_nodes']} nodes), moe.apply "
                 f"{r['apply_ms'] * 1e3:.2f} us ({r['apply_nodes']} nodes), "
                 f"bound {r['bound_ms'] * 1e3:.2f} us (kernel at "
                 f"{r['bound_ms'] / r['ms']:.1%} of it); "
                 f"{'within' if t <= md_ops.MAX_TOKENS else 'above'} "
                 f"MAX_TOKENS {md_ops.MAX_TOKENS}")
        del layers
        torch.cuda.empty_cache()
    assert md_ops.counts["plain"] == 0, md_ops.counts
    return {"max_abs_err": worst, **times[MOE_DECODE_ARCHS[0]][1],
            "by_shape": {f"{arch},T={t}": r for arch, by_t in times.items()
                         for t, r in by_t.items()}}


def moe_decode_only(torch) -> int:
    """``python3 chip_smoke.py --moe-decode``: the MoE decode kernel's
    build (its ptxas report) and phase 17 alone, the result as one JSON
    line."""
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_decode import ops as md_ops
    from repro_torch.kernels.moe_decode import ref as md_ref
    from repro_torch.launch import steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _log(f"card: {card}")
    reports = build.build_all(["moe_decode"])
    # no report where the kernel was built before, by this checkout
    _log(reports.get("moe_decode", "moe_decode: built before")[-3000:])
    with _phase("phase 17: the MoE decode layer"):
        out = phase_moe_decode(torch, steps, md_ops, md_ref)
    print(json.dumps({"moe_decode": out, "card": card}))
    return 0


def decode_attention_only(torch) -> int:
    """``python3 chip_smoke.py --decode-attention``: the decode attention
    kernel's build (with its SASS lines) and phase 16 alone, the result
    as one JSON line."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    reports = build.build_all(["decode_attention"])
    _log(reports["decode_attention"][-2000:])
    with _phase("phase 16: the decode attention core"):
        out = phase_decode_attention(torch, T, steps, da_ops, da_ref)
    print(json.dumps({"decode_attention": out}))
    return 0


def kernel_timings(torch) -> int:
    """``python3 chip_smoke.py --kernel-timings``: phase 1's build and
    phase 4's timings alone, as one JSON line (kernel ms of each shape).
    A copy of this script beside another checkout's ``src/`` times that
    checkout's kernels with the same code, so two versions compare
    within one call (parent, change, change, parent)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.hsf_score import ops, ref
    from repro_torch.kernels.topk import ops as tk_ops
    from repro_torch.kernels.topk import ref as tk_ref

    build.build_all()
    topk = phase_timings(torch, ops, ref)
    rest = phase_new_kernel_timings(torch, ops, ref, tk_ops, tk_ref)
    print(json.dumps({
        "source": str(SRC), "hsf_score_topk": topk["ms"],
        "hsf_score": rest["score"]["ms"],
        "top_k": {f"{n},{k}": t["ms"] for key, t in rest.items()
                  if key != "score" for n, k in [key]}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--restart-replay"]:
        return restart_replay(argv[1])
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
    if argv[:1] == ["--kernel-timings"]:
        return kernel_timings(torch)
    if argv[:1] == ["--decode-attention"]:
        return decode_attention_only(torch)
    if argv[:1] == ["--moe-decode"]:
        return moe_decode_only(torch)

    from repro_torch.configs import get as get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_decode import ops as md_ops
    from repro_torch.kernels.moe_decode import ref as md_ref
    from repro_torch.data import pipeline
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag import ref as bag_ref
    from repro_torch.kernels.hsf_score import ops, ref
    from repro_torch.kernels.topk import ops as tk_ops
    from repro_torch.kernels.topk import ref as tk_ref
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.recsys import base as rbase
    from repro_torch.models.recsys import embedding as emb

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _log(f"card: {card}")
    _log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
         f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
         "device(s)")
    with _phase("phase 1: build"):
        t0 = time.perf_counter()
        reports = build.build_all()
        _log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
        for name, report in sorted(reports.items()):
            regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                               report)]
            spill = sum(int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", report))
            _log(f"  {name}: {len(regs)} kernel instantiations, "
                 f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
                 f"{spill} bytes of spills")
        _sass_report(build, reports)
        _flash_designs(torch, fa_ops)

    with _phase("phase 2: kernels against their plain versions on the card"):
        max_err = phase_kernel(torch, np, ops, ref)
        fa_max_err, _ = phase_flash_kernel(torch, fa_ops, fa_ref)
        score_max_err = phase_hsf_score_kernel(torch, np, ops, ref)
        topk_max_err = phase_topk_kernel(torch, np, tk_ops, tk_ref)
        bag_max_err = phase_bag_kernel(torch, bag_ops, bag_ref, emb, rbase,
                                       pipeline)

    with tempfile.TemporaryDirectory() as tmp:
        with _phase("phase 3: main path (ingest, serve + generate, reload, "
                    "serve + generate)"):
            launches, fa_launches, ctx = phase_main_path(torch, ops, fa_ops,
                                                         tmp)
            ctx_decode_launches = ctx["decode_launches"]

        with _phase("phase 4: HSF and top-k timings at the serving shape"):
            timing = phase_timings(torch, ops, ref)
            new_timing = phase_new_kernel_timings(torch, ops, ref, tk_ops,
                                                  tk_ref)

        cfg = get_arch(ARCH).config
        model = _served_model(torch, T, cfg)
        with _phase(f"phase 5: {ARCH} FULL prefill logits, flash kernel vs "
                    "blockwise"):
            phase_cross_check(torch, T, model, cfg)

        with _phase("phase 6: flash attention and generation timings"):
            fa_timing, _ = phase_generation_timings(torch, T, model, cfg,
                                                    fa_ops, fa_ref)
        del model
        torch.cuda.empty_cache()

        with _phase("phase 7: the IVF index plane at 65,536 docs"):
            score_launches, topk_launches = phase_ivf(torch, np, ops, tk_ops,
                                                      ctx, tmp)
        with _phase("phase 8: the recsys plane at full width (dlrm-rm2, "
                    "deepfm, autoint)"):
            bag_launches, bag_timing, _ = phase_recsys(
                torch, np, bag_ops, bag_ref, tk_ops, tk_ref)

        with _phase("phase 9: compiled serving steps (CUDA graphs, "
                    "replayed)"):
            model = _served_model(torch, T, cfg)
            phase_compiled_generation(torch, T, steps, fa_ops, cfg, model,
                                      ctx)
            del model
            torch.cuda.empty_cache()
            phase_compiled_lm_cells(torch, steps, fa_ops)
            phase_compiled_recsys_cells(torch, steps, tk_ops)
            torch.cuda.empty_cache()

        with tempfile.TemporaryDirectory() as mt_tmp, _phase(
                f"phase 10: the tenancy plane ({N_TENANTS} containers of "
                f"{TENANT_BASE_DOCS + TENANT_OWN_DOCS} docs, {MT_RESIDENT} "
                "resident)"):
            mt_launches, _ = phase_tenancy(torch, np, ops, ref, mt_tmp)

        with _phase("phase 11: the LM families at full width ("
                    f"{', '.join(LM_FAMILIES)})"):
            families = phase_lm_families(torch, T, steps, fa_ops, fa_ref, ctx)

        with _phase("phase 12: the sharded retrieval planes (ragdb FULL, "
                    f"{SHARD_DOCS:,} docs a shard)"):
            shard_launches, shard_err, shard_timing = phase_sharded_retrieve(
                torch, np, ops, ref, steps)
            phase_sharded_engine(torch, np, tmp)

        with _phase("phase 13: the training substrate (llama3.2-3b FULL "
                    "train_4k, five LM SMOKE configs card vs CPU, recsys "
                    "train_batch FULL, launch/train.py restart-replay)"):
            phase_training(torch, np, fa_ops, tmp)

        with _phase("phase 14: the analysis plane's guards on the main path "
                    f"({ARCH} FULL, RAGDB_SANITIZERS=1)"):
            san_launches, san_fa_launches = phase_sanitized_serving(
                torch, ops, fa_ops, ctx)
        del ctx
        torch.cuda.empty_cache()
        with _phase("phase 15: the GNN (mace FULL, four cells; card vs CPU; "
                    "forces; the dry run)"):
            phase_gnn(torch, np)
        with _phase("phase 16: the decode attention core"):
            decode = phase_decode_attention(torch, T, steps, da_ops, da_ref)
        with _phase("phase 17: the MoE decode layer"):
            moe_decode = phase_moe_decode(torch, steps, md_ops, md_ref)
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    _log(f"card: {card}")  # again, near the end, for readers of the tail

    _log(f"hsf_score_topk launches on its paths: phase 3 {launches}, "
         f"phase 10 (A) {mt_launches}, phase 12 {shard_launches}, phase 14 "
         f"{san_launches}")
    fa_paths = {"phase3": fa_launches, **{
        f"phase11_{arch}": f["launches"] for arch, f in families.items()},
        "phase14": san_fa_launches}
    fa_shapes = {name: t for f in families.values()
                 for name, t in f["flash"].items()}
    _log(f"flash_attention launches on its paths: {fa_paths}")
    da_paths = {"phase3": ctx_decode_launches, **{
        f"phase11_{arch}": f["decode_launches"]
        for arch, f in families.items()}}
    _log(f"decode_attention launches on its paths: {da_paths}")
    md_paths = {f"phase11_{arch}": f["moe_decode_launches"]
                for arch, f in families.items()}
    _log(f"moe_decode launches on its paths: {md_paths}")
    print(json.dumps({"kernels": [{
        "name": "hsf_score_topk",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hsf_topk.cu",
        "replaces": "src/repro/kernels/hsf_score/hsf_score.py:205",
        # the sum over its paths, each counted from 0 in this run
        "launches": launches + mt_launches + shard_launches + san_launches,
        "launches_by_path": {"phase3": launches, "phase10_A": mt_launches,
                             "phase12": shard_launches,
                             "phase14": san_launches},
        "max_abs_err": max(max_err, shard_err),
        **timing,
        # phase 12's shard shape: one launch over a 65,536-row shard view
        "by_shape": {"shard_65536": shard_timing},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
        # the sum over its paths, each counted from 0 in this run
        "launches": sum(fa_paths.values()),
        "launches_by_path": fa_paths,
        "max_abs_err": fa_max_err,
        **fa_timing,
        # phase 11's model shapes (timing keys as above)
        "by_shape": fa_shapes,
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
    }, {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:44",
        "launches": bag_launches,
        "max_abs_err": bag_max_err,
        **{k: bag_timing[SERVE_BULK][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        # the JAX package's decode attention is plain jnp
        "replaces": None,
        "launches": sum(da_paths.values()),
        "launches_by_path": da_paths,
        **decode,
    }, {
        "name": "moe_decode",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_decode.cu",
        # the JAX package's MoE layer is plain jnp
        "replaces": None,
        # the served decode steps of phase 11's MoE archs, counted from 0
        "launches": sum(md_paths.values()),
        "launches_by_path": md_paths,
        **moe_decode,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
