"""RAG serving driver: knowledge container + generation plane, fronted
by the concurrent serving runtime, on the card.

Loads (or builds) a knowledge container, instantiates the serving
runtime (micro-batching scheduler → generation-pinned snapshot →
QueryEngine — docs/ARCHITECTURE.md §7) and an LM, then serves requests:
every query is ``submit()``-ed individually and the scheduler coalesces
them into batched scoring dispatches; generation (pack → prefill →
decode) runs per request on the resolved retrievals, each prefill and
decode step a CUDA graph replayed on the card (captured at first use;
the count and seconds of the captures are printed).  Prints each
query's ranked documents and generated token ids, the generation times,
and the serving metrics snapshot (p50/p99, QPS, batch occupancy, cache
hit rate) at the end.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --corpus /path/to/docs --max-batch 8 \\
        --queries "what is INV-2024?" ...

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--arch`` is any
of the five LM archs (``llama3.2-3b``, the default; ``gemma2-9b``,
``gemma3-27b``, ``qwen3-moe-30b-a3b``, ``deepseek-v2-lite-16b``).  On
``cuda`` the LM is the arch's full configuration in bf16 (llama3.2-3b:
28 layers, d_model 3072, 6.4 GB; gemma3-27b 54.0 GB, the most) with
random weights from ``torch.Generator`` seed 0; on the CPU it is the
arch's SMOKE configuration, as the JAX driver serves on its CPU host.
For an MoE arch the active parameter count is printed beside the
total.  ``--index ivf`` serves through the clustered index plane
(k-means on the serving device at first use, or the container's
persisted index state adopted without a retrain; ``--nprobe``,
``--guarantee exact`` for results provably equal to the flat scan);
``--index ivf-sharded`` partitions the clusters over ``--shards`` shards
(by default the CUDA device count on the card, 1 with ``--device cpu``),
one per card when the host has that many and logical shards on one
device otherwise, each reranking its own clusters with the bit-stable
map path.  ``--tenant-root DIR`` serves many tenants through one runtime instead:
a container pool rooted at ``DIR`` (``DIR/<tenant>.ragdb`` each), lazy
mounts and LRU eviction under ``--resident-budget``, per-tenant quotas
(``--quota-rate``, ``--quota-burst``), queries round-robined over
``--tenants`` tenant ids; it serves retrieval only, as the JAX driver
does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.configs import get as get_arch
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.rag import RAGPipeline
from repro_torch.models import transformer as T
from repro_torch.obs import (
    SLOTargets,
    format_breakdown,
    trace as obs_trace,
    write_chrome_trace,
)
from repro_torch.serving import RequestRejected, ServingRuntime


def _slo_from_args(args) -> SLOTargets | None:
    if args.slo_p99_ms is not None:
        return SLOTargets(p99_ms=args.slo_p99_ms)
    return None


def _print_health(runtime) -> None:
    h = runtime.health()
    print(f"health: {h['status']}")
    for reason in h["reasons"]:
        print(f"  - {reason}")
    print(json.dumps(h, indent=2, sort_keys=True, default=str))


def _shard_kwargs(args) -> dict:
    """``n_shards`` for the engine when the sharded plane is asked for
    with a count (the JAX package's serve.py ignores ``--shards``
    otherwise)."""
    if args.index == "ivf-sharded" and args.shards:
        return {"n_shards": args.shards}
    return {}


def _generation_summary(gens, max_new_tokens: int) -> str:
    """Medians over the served requests; each time ends in a device →
    host read of a token, so it includes the device work."""
    prefill_ms = statistics.median(g.prefill_s for g in gens) * 1e3
    line = (f"generation: {len(gens)} requests, prompt tokens p50 "
            f"{statistics.median(g.prompt_len for g in gens):.0f}, "
            f"prefill p50 {prefill_ms:.2f} ms")
    if max_new_tokens:
        per_tok = statistics.median(g.decode_s for g in gens) \
            / max_new_tokens * 1e3
        line += f", decode p50 {per_tok:.2f} ms/token"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="the LM: llama3.2-3b, gemma2-9b, gemma3-27b, "
                    "qwen3-moe-30b-a3b or deepseek-v2-lite-16b")
    ap.add_argument("--container", default=None, help=".ragdb to load")
    ap.add_argument("--corpus", default=None, help="directory to ingest")
    ap.add_argument("--save", default=None, help="save container here")
    ap.add_argument("--queries", nargs="+", required=True)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--max-batch", "--batch-size", dest="max_batch",
                    type=int, default=8,
                    help="scheduler flush cap (requests per dispatch)")
    ap.add_argument("--flush-deadline-ms", type=float, default=2.0,
                    help="micro-batch flush deadline (latency bound)")
    ap.add_argument("--scoring-path", default="auto",
                    choices=["auto", "map", "gemm", "kernel"],
                    help="auto = the CUDA kernel on a CUDA device, the "
                    "bit-stable map path on the CPU")
    ap.add_argument("--use-kernel", action="store_true",
                    help="legacy alias for --scoring-path kernel")
    ap.add_argument("--index", default="flat",
                    choices=["flat", "ivf", "ivf-sharded"],
                    help="flat = full scan; ivf = clustered probe/rerank "
                    "(sublinear, exact HSF within the probed set); "
                    "ivf-sharded = the cluster plane partitioned across "
                    "the shard mesh (--shards)")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="clusters probed per query (index=ivf)")
    ap.add_argument("--guarantee", default="probe",
                    choices=["probe", "exact"],
                    help="exact = widen probes until top-k provably "
                    "matches the flat scan (index=ivf)")
    ap.add_argument("--shards", type=int, default=None,
                    help="cluster shards for index=ivf-sharded (default: "
                    "the CUDA device count, 1 on the CPU; logical shards "
                    "on one device when devices are fewer)")
    ap.add_argument("--tenant-root", default=None, metavar="DIR",
                    help="serve multi-tenant: one container pool rooted "
                    "here (<DIR>/<tenant>.ragdb per tenant), lazy mounts "
                    "+ LRU eviction under --resident-budget "
                    "(docs/ARCHITECTURE.md §13); queries round-robin "
                    "over --tenants tenant ids")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenant count to drive in --tenant-root mode")
    ap.add_argument("--resident-budget", type=int, default=8,
                    help="max tenants mounted at once (LRU beyond this)")
    ap.add_argument("--quota-rate", type=float, default=None,
                    help="per-tenant admission quota: sustained "
                    "requests/s (token bucket; rejections surface as "
                    "RequestRejected)")
    ap.add_argument("--quota-burst", type=int, default=None,
                    help="per-tenant quota burst size (default: rate)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda; "
                    "pass cpu to run on the host)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus exposition (serving "
                    "registry + global obs registry) and the engine's "
                    "index_stats() after the run")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="enable request tracing and write a Chrome "
                    "trace-event JSON (load in Perfetto / "
                    "chrome://tracing; inspect with "
                    "`python -m repro_torch.obs FILE`)")
    ap.add_argument("--explain", action="store_true",
                    help="submit every query with explain=True and print "
                    "its EXPLAIN plan (cache disposition, stage "
                    "durations)")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="p99 latency SLO target for --health (default "
                    "SLOTargets otherwise)")
    ap.add_argument("--health", action="store_true",
                    help="print the SLO health verdict "
                    "(runtime.health(): ok | degraded | critical with "
                    "reasons) after the run")
    args = ap.parse_args(argv)

    if args.trace:
        obs_trace.enable()

    if args.tenant_root:
        return _serve_multitenant(args)

    if args.container:
        kb = KnowledgeBase.load(args.container)
        print(f"loaded container: {kb.n_docs} docs")
    else:
        kb = KnowledgeBase(dim=args.dim)
    if args.corpus:
        stats = kb.sync(args.corpus)
        print(f"sync: +{stats.added} ~{stats.updated} -{stats.removed} "
              f"(skipped {stats.skipped}) in {stats.seconds:.2f}s")
    if args.save:
        kb.save(args.save)
        print(f"published container → {args.save}")

    runtime = ServingRuntime(
        kb,
        max_batch=max(1, args.max_batch),
        flush_deadline=args.flush_deadline_ms / 1e3,
        scoring_path="kernel" if args.use_kernel else args.scoring_path,
        index=args.index,
        nprobe=args.nprobe,
        guarantee=args.guarantee,
        slo=_slo_from_args(args),
        device=args.device,
        **_shard_kwargs(args),
    )
    arch = get_arch(args.arch)
    device = runtime.engine.device
    # the card serves the full configuration; a CPU host the reduced one
    cfg = arch.config if device.type == "cuda" else arch.smoke_config
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device).manual_seed(0), device)
    active = (f" ({cfg.active_param_count():,} active)"
              if cfg.moe is not None else "")
    print(f"generator: {cfg.name}, {cfg.param_count():,} params{active} "
          f"in {cfg.dtype} on {device} (random weights, seed 0; init "
          f"{time.perf_counter() - t0:.1f} s)")
    rag = RAGPipeline(kb, model, cfg, engine=runtime.engine)

    with runtime:
        runtime.metrics.reset()
        shard_note = ""
        if args.index == "ivf-sharded" and runtime.engine.ivf is not None:
            ivf = runtime.engine.ivf
            shard_note = f", shards: {ivf.n_shards} {ivf.placement}"
        print(f"serving generation {runtime.generation} on "
              f"{runtime.engine.device} "
              f"(index: {runtime.engine.index}, "
              f"scoring path: {runtime.engine.scoring_path}{shard_note}, "
              f"flush ≤ {args.flush_deadline_ms:.1f} ms, "
              f"batch ≤ {args.max_batch})")
        t0 = time.perf_counter()
        futures, gens = [], []
        for q in args.queries:
            try:
                futures.append((q, runtime.submit(
                    q, k=args.top_k, explain=args.explain)))
            except RequestRejected as exc:
                print(f"REJECTED {q!r}: {exc}")
        for q, fut in futures:
            served = fut.result()
            out = rag.generate(q, served.results, args.max_new_tokens,
                               trace=served.trace_id)
            gens.append(out)
            print(f"\nQ: {q}  [generation {served.generation}"
                  f"{', cached' if served.cached else ''}]")
            for r in out.retrieved:
                mark = "*" if r.boosted else " "
                print(f"  {mark} {r.doc_id:30s} score={r.score:.4f}")
            print(f"  generated token ids: {out.token_ids}")
            if args.explain and served.plan is not None:
                print(served.plan.render())
        dt = time.perf_counter() - t0
        if args.health:
            _print_health(runtime)
    print(f"\n{len(futures)} requests in {dt * 1e3:.1f} ms")
    if gens:
        print(_generation_summary(gens, args.max_new_tokens))
        steps = rag.steps
        if steps.device.type == "cuda":
            print(f"generation graphs: {steps.captures} captured "
                  f"({len(steps.steps()) - 1} prompt buckets + decode) in "
                  f"{steps.capture_s:.2f} s")
        else:
            print("generation graphs: none (the CPU runs the steps eagerly)")
    print(f"serving metrics: {runtime.metrics.format()}")
    if args.metrics:
        stats = runtime.index_stats()
        print("index stats: " + ", ".join(
            f"{k}={v}" for k, v in stats.items()))
        print(runtime.render_metrics(), end="")
    if args.trace:
        spans = obs_trace.get().drain()
        n = write_chrome_trace(args.trace, spans)
        print(f"trace: {n} events → {args.trace}")
        print(format_breakdown(spans))
    return 0


def _serve_multitenant(args) -> int:
    """N tenants through one runtime: pool-mounted containers, queries
    round-robined over the tenant ids (retrieval plane only — per-tenant
    LM generation composes the same way the single-tenant path does)."""
    from repro_torch.tenancy import ContainerPool, TenantQuotas

    pool = ContainerPool(
        args.tenant_root,
        kb_kwargs={"dim": args.dim},
        max_resident=max(1, args.resident_budget),
        scoring_path="kernel" if args.use_kernel else args.scoring_path,
        index=args.index,
        nprobe=args.nprobe,
        guarantee=args.guarantee,
        device=args.device,
        **_shard_kwargs(args),
    )
    quotas = None
    if args.quota_rate:
        quotas = TenantQuotas(default_rate=args.quota_rate,
                              default_burst=args.quota_burst)
    runtime = ServingRuntime(
        pool=pool, quotas=quotas,
        max_batch=max(1, args.max_batch),
        flush_deadline=args.flush_deadline_ms / 1e3,
        slo=_slo_from_args(args),
    )
    names = [f"tenant{i:02d}" for i in range(max(1, args.tenants))]
    with runtime:
        if args.corpus:
            for name in names:
                with runtime.tenant_writer(name) as kb:
                    stats = kb.sync(args.corpus)
                runtime.publish(tenant=name, durable=True)
                print(f"[{name}] sync: +{stats.added} ~{stats.updated} "
                      f"-{stats.removed} → durable publish")
        print(f"serving {len(names)} tenants "
              f"(resident budget {pool.max_resident}, "
              f"flush ≤ {args.flush_deadline_ms:.1f} ms, "
              f"batch ≤ {args.max_batch})")
        t0 = time.perf_counter()
        futures = []
        for i, q in enumerate(args.queries):
            name = names[i % len(names)]
            try:
                futures.append(
                    (name, q, runtime.submit(q, k=args.top_k, tenant=name,
                                             explain=args.explain)))
            except RequestRejected as exc:
                print(f"REJECTED [{exc.tenant}] {q!r}: {exc}")
        for name, q, fut in futures:
            served = fut.result()
            print(f"\n[{name}] Q: {q}  [generation {served.generation}"
                  f"{', cached' if served.cached else ''}]")
            for r in served.results:
                mark = "*" if r.boosted else " "
                print(f"  {mark} {r.doc_id:30s} score={r.score:.4f}")
            if args.explain and served.plan is not None:
                print(served.plan.render())
        dt = time.perf_counter() - t0
        print(f"\n{len(futures)} requests in {dt * 1e3:.1f} ms")
        print(f"serving metrics: {runtime.metrics.format()}")
        for name, m in sorted(runtime.tenant_metrics().items()):
            print(f"  [{name}] qps={m['qps']:.0f} "
                  f"p50={m['latency_p50_ms']:.2f}ms "
                  f"p99={m['latency_p99_ms']:.2f}ms "
                  f"rejected={m['rejected']}")
        ps = runtime.pool_stats()
        print(f"pool: {ps['resident']}/{ps['max_resident']} resident, "
              f"{ps['resident_bytes']} bytes, pinned={ps['pinned']}")
        res = runtime.resources()
        print(f"ledger: {res['resident_bytes']} resident bytes "
              f"({res['device_bytes']} device) across "
              f"{len(res['tenants'])} tenants")
        if args.health:
            _print_health(runtime)
        if args.metrics:
            print(runtime.render_metrics(), end="")
    pool.drain()  # durably publish + unmount everything on the way out
    if args.trace:
        spans = obs_trace.get().drain()
        n = write_chrome_trace(args.trace, spans)
        print(f"trace: {n} events → {args.trace}")
        print(format_breakdown(spans))
    return 0


if __name__ == "__main__":
    main()
