"""CLI: render a per-stage breakdown from a Chrome trace file, or an
EXPLAIN plan file.

    PYTHONPATH=src python -m repro_torch.obs trace.json [--json] [--tenant T]
    PYTHONPATH=src python -m repro_torch.obs explain plans.json

Trace mode loads a trace written by ``obs.export.write_chrome_trace``
(e.g. from ``benchmarks/bench_serving.py --trace`` or ``launch/serve.py
--trace``) and prints per-span-name count / total / p50 / p99 / max,
the request-decomposition coverage line (how much of end-to-end request
time the stage spans account for), and — when requests carry tenant
labels — a per-tenant table.  ``--tenant T`` keeps only the traces
whose request root is labeled with tenant ``T``.

Explain mode loads a plan file written by ``obs.explain.write_plans``
(e.g. from ``bench_serving --explain-out`` or ``serve.py --explain``)
and renders each plan's text tree.

Exit 0 on success, 2 on a missing/unreadable file.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.explain import load_plans
from repro_torch.obs.export import (
    filter_tenant_traces,
    format_breakdown,
    load_chrome_trace,
    request_decomposition,
    stage_breakdown,
    tenant_breakdown,
)


def _explain_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs explain",
        description="Render EXPLAIN plans from a plan JSON file")
    ap.add_argument("plans", help="plan file from obs.explain.write_plans")
    args = ap.parse_args(argv)
    try:
        plans = load_plans(args.plans)
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print(f"error: cannot read plans {args.plans!r}: {exc}",
              file=sys.stderr)
        return 2
    try:
        for i, p in enumerate(plans):
            if i:
                print()
            print(p.render())
    except BrokenPipeError:
        sys.stderr.close()
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "explain":
        return _explain_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Per-stage latency breakdown from a Chrome trace file "
                    "(or `explain plans.json` to render EXPLAIN plans)")
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable breakdown instead of the table")
    ap.add_argument("--tenant", default=None,
                    help="keep only traces whose request root span is "
                         "labeled with this tenant")
    args = ap.parse_args(argv)
    try:
        spans = load_chrome_trace(args.trace)
    except (OSError, ValueError, KeyError) as exc:
        print(f"error: cannot read trace {args.trace!r}: {exc}",
              file=sys.stderr)
        return 2
    if args.tenant is not None:
        spans = filter_tenant_traces(spans, args.tenant)
    try:
        if args.json:
            print(json.dumps({
                "stages": stage_breakdown(spans),
                "requests": request_decomposition(spans),
                "tenants": tenant_breakdown(spans),
            }, indent=2, sort_keys=True))
        else:
            print(f"{len(spans)} spans from {args.trace}"
                  + (f" (tenant={args.tenant})" if args.tenant else ""))
            print(format_breakdown(spans))
    except BrokenPipeError:  # output piped into head/less that closed
        sys.stderr.close()   # suppress the interpreter's epipe warning
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
