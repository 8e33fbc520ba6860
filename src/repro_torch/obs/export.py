"""Exporters: Chrome trace-event JSON and Prometheus text exposition.

Chrome format: one ``"ph": "X"`` (complete) event per span, ``ts`` and
``dur`` in microseconds — the file loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.  Trace/span/parent
ids and all span args ride in ``args`` so the round trip
(``write_chrome_trace`` → ``load_chrome_trace``) is lossless to ~1 ns
timestamp quantization (tier-1 tested).

Prometheus format: ``# HELP``/``# TYPE`` headers plus one sample line
per series; histograms render summary-style (``{quantile="0.5"}``,
``{quantile="0.99"}``, ``_count``, ``_sum``) since the log-bucket
layout is an implementation detail.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanRecord

_ID_KEYS = ("trace_id", "span_id", "parent_id")


# ---- Chrome trace-event JSON --------------------------------------------

def chrome_trace(spans, *, pid: int = 0) -> dict:
    """Spans → the Chrome trace-event JSON object (not yet serialized)."""
    events = []
    for r in spans:
        args = {k: v for k, v in r.args.items()}
        args["trace_id"] = r.trace_id
        args["span_id"] = r.span_id
        args["parent_id"] = r.parent_id
        events.append({
            "name": r.name,
            "cat": "ragdb",
            "ph": "X",
            "ts": r.t0_ns / 1e3,
            "dur": r.dur_ns / 1e3,
            "pid": pid,
            "tid": r.tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans, *, pid: int = 0) -> int:
    """Serialize to ``path``; returns the number of events written."""
    doc = chrome_trace(spans, pid=pid)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
    return len(doc["traceEvents"])


def load_chrome_trace(path: str) -> list[SpanRecord]:
    """Read a Chrome trace file back into SpanRecords (ids and args
    recovered from the event ``args``; foreign events without our id
    keys are skipped)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        if not all(k in args for k in _ID_KEYS):
            continue
        trace_id = args.pop("trace_id")
        span_id = args.pop("span_id")
        parent_id = args.pop("parent_id")
        out.append(SpanRecord(
            ev["name"], trace_id, span_id, parent_id,
            round(ev["ts"] * 1e3), round(ev.get("dur", 0) * 1e3),
            ev.get("tid", 0), args,
        ))
    return out


# ---- stage breakdown (the `python -m repro_torch.obs` summary) ----------------

def stage_breakdown(spans) -> dict:
    """Per-span-name stats with *exact* percentiles (this is offline
    analysis of a bounded trace file, not the O(1) serving histogram).

    Returns ``{name: {count, total_s, p50_s, p99_s, max_s}}``.
    """
    by_name: dict[str, list[float]] = {}
    for r in spans:
        by_name.setdefault(r.name, []).append(r.dur_ns / 1e9)
    out = {}
    for name, durs in by_name.items():
        durs.sort()
        n = len(durs)
        out[name] = {
            "count": n,
            "total_s": sum(durs),
            "p50_s": durs[int(0.50 * (n - 1))],
            "p99_s": durs[int(0.99 * (n - 1))],
            "max_s": durs[-1],
        }
    return out


def request_decomposition(spans, stages=("queue_wait", "flush_wait",
                                         "score", "merge")) -> list[dict]:
    """Group spans by trace id and, for every non-cached ``request``
    root span, report its end-to-end duration plus the summed stage
    durations — the acceptance check that stages tile the request."""
    by_trace: dict[int, dict] = {}
    for r in spans:
        t = by_trace.setdefault(r.trace_id, {"request": None, "stages": {}})
        if r.name == "request":
            t["request"] = r
        elif r.name in stages:
            t["stages"][r.name] = t["stages"].get(r.name, 0.0) + r.dur_ns / 1e9
    out = []
    for tid, t in by_trace.items():
        req = t["request"]
        if req is None or req.args.get("cached"):
            continue
        out.append({
            "trace_id": tid,
            "request_s": req.dur_ns / 1e9,
            "stages_s": dict(t["stages"]),
            "stage_sum_s": sum(t["stages"].values()),
        })
    return out


def filter_tenant_traces(spans, tenant: str) -> list[SpanRecord]:
    """Keep only the traces whose ``request`` root span is labeled with
    ``tenant`` (the ``--tenant`` CLI filter).  Whole traces are kept or
    dropped — a request's child stages inherit the verdict via their
    trace id, so the filtered view still decomposes cleanly."""
    keep = {r.trace_id for r in spans
            if r.name == "request" and r.args.get("tenant") == tenant}
    return [r for r in spans if r.trace_id in keep]


def tenant_breakdown(spans) -> dict:
    """Per-tenant request stats from the ``request`` root spans:
    ``{tenant: {count, p50_s, p99_s, total_s}}``.  Requests without a
    tenant label (single-tenant serving) group under ``"-"``."""
    by_tenant: dict[str, list[float]] = {}
    for r in spans:
        if r.name != "request":
            continue
        by_tenant.setdefault(
            str(r.args.get("tenant", "-")), []).append(r.dur_ns / 1e9)
    out = {}
    for tenant, durs in by_tenant.items():
        durs.sort()
        n = len(durs)
        out[tenant] = {
            "count": n,
            "total_s": sum(durs),
            "p50_s": durs[int(0.50 * (n - 1))],
            "p99_s": durs[int(0.99 * (n - 1))],
        }
    return out


def format_breakdown(spans) -> str:
    """The ``python -m repro_torch.obs`` table: per-stage count/p50/p99."""
    br = stage_breakdown(spans)
    if not br:
        return "no spans"
    lines = [f"{'span':<24}{'count':>8}{'total_ms':>12}"
             f"{'p50_ms':>10}{'p99_ms':>10}{'max_ms':>10}"]
    for name, s in sorted(br.items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(
            f"{name:<24}{s['count']:>8}{s['total_s'] * 1e3:>12.2f}"
            f"{s['p50_s'] * 1e3:>10.3f}{s['p99_s'] * 1e3:>10.3f}"
            f"{s['max_s'] * 1e3:>10.3f}")
    reqs = request_decomposition(spans)
    if reqs:
        mean_req = sum(r["request_s"] for r in reqs) / len(reqs)
        mean_sum = sum(r["stage_sum_s"] for r in reqs) / len(reqs)
        cov = mean_sum / mean_req if mean_req else 0.0
        lines.append(
            f"-- {len(reqs)} traced requests: mean {mean_req * 1e3:.2f} ms, "
            f"stage spans cover {cov * 100:.1f}% of end-to-end")
    tb = tenant_breakdown(spans)
    if tb and set(tb) != {"-"}:  # only when tenant-labeled requests exist
        lines.append("")
        lines.append(f"{'tenant':<24}{'requests':>8}{'total_ms':>12}"
                     f"{'p50_ms':>10}{'p99_ms':>10}")
        for tenant, s in sorted(tb.items(),
                                key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{tenant:<24}{s['count']:>8}{s['total_s'] * 1e3:>12.2f}"
                f"{s['p50_s'] * 1e3:>10.3f}{s['p99_s'] * 1e3:>10.3f}")
    return "\n".join(lines)


# ---- Prometheus text exposition -----------------------------------------

def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Render one or more registries as Prometheus text exposition."""
    lines = []
    for reg in registries:
        for name, kind, help_, series in reg.collect():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(
                f"# TYPE {name} "
                f"{'summary' if kind == 'histogram' else kind}")
            for labels, m in series:
                if kind == "histogram":
                    s = m.snapshot()
                    for q, key in (("0.5", "p50"), ("0.99", "p99")):
                        ql = dict(labels, quantile=q)
                        lines.append(
                            f"{name}{_fmt_labels(ql)} {_fmt_value(s[key])}")
                    lab = _fmt_labels(labels)
                    lines.append(f"{name}_count{lab} {s['count']}")
                    lines.append(f"{name}_sum{lab} {_fmt_value(s['sum'])}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {_fmt_value(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")
