"""Retrieval serving driver: knowledge container fronted by the
concurrent serving runtime, on the card.

Loads (or builds) a knowledge container, instantiates the serving
runtime (micro-batching scheduler → generation-pinned snapshot →
QueryEngine — docs/ARCHITECTURE.md §7) and serves requests: every query
is ``submit()``-ed individually and the scheduler coalesces them into
batched scoring dispatches.  Prints each query's ranked documents and
the serving metrics snapshot (p50/p99, QPS, batch occupancy, cache hit
rate) at the end.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --corpus /path/to/docs --max-batch 8 \\
        --queries "what is INV-2024?" ...

Runs on ``cuda`` unless ``--device cpu`` is given.  The JAX driver's
generation leg (``--arch``, ``--max-new-tokens``), multi-tenant mode
(``--tenant-root``) and the IVF index (``--index``) come with later
slices of the port.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.ingest import KnowledgeBase
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--container", default=None, help=".ragdb to load")
    ap.add_argument("--corpus", default=None, help="directory to ingest")
    ap.add_argument("--save", default=None, help="save container here")
    ap.add_argument("--queries", nargs="+", required=True)
    ap.add_argument("--top-k", type=int, default=3)
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
        scoring_path=args.scoring_path,
        slo=_slo_from_args(args),
        device=args.device,
    )

    with runtime:
        runtime.metrics.reset()
        print(f"serving generation {runtime.generation} on "
              f"{runtime.engine.device} "
              f"(scoring path: {runtime.engine.scoring_path}, "
              f"flush ≤ {args.flush_deadline_ms:.1f} ms, "
              f"batch ≤ {args.max_batch})")
        t0 = time.perf_counter()
        futures = []
        for q in args.queries:
            try:
                futures.append((q, runtime.submit(
                    q, k=args.top_k, explain=args.explain)))
            except RequestRejected as exc:
                print(f"REJECTED {q!r}: {exc}")
        for q, fut in futures:
            served = fut.result()
            print(f"\nQ: {q}  [generation {served.generation}"
                  f"{', cached' if served.cached else ''}]")
            for r in served.results:
                mark = "*" if r.boosted else " "
                print(f"  {mark} {r.doc_id:30s} score={r.score:.4f}")
            if args.explain and served.plan is not None:
                print(served.plan.render())
        dt = time.perf_counter() - t0
        if args.health:
            _print_health(runtime)
    print(f"\n{len(futures)} requests in {dt * 1e3:.1f} ms")
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


if __name__ == "__main__":
    main()
