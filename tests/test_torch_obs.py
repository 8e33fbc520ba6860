"""The port's observability plane (``repro_torch.obs``) held to the
contracts of the JAX package's, on the CPU: every contract of
``tests/test_obs.py`` (the tracer, the Chrome trace round trip, the
breakdown CLI, the metrics registry, ``LogHistogram``) and of
``tests/test_obs_decision.py`` (EXPLAIN, the resource ledger, the SLO
health monitor, tenant traces) run through the port.  Where an output is
data, the two packages' outputs on the same inputs are compared field
for field: the Chrome trace file and its breakdowns, ``python -m
repro_torch.obs`` against ``python -m repro.obs`` for a trace and a plan
file, the Prometheus text, the health verdicts, ``QueryPlan``s on one
IVF state adopted across the packages (so ``probe_order`` compares
too), and the ledger's planes byte for byte.  The one divergence is the
port's repaired count of the kernel operands (ROADMAP Queue 3 item 11):
a kernel operand that is the doc matrix itself adds nothing."""
import json
import threading

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro.obs import explain as ref_explain
from repro.obs import export as ref_export
from repro.obs import health as ref_health
from repro.obs import ledger as ref_ledger
from repro.obs.__main__ import main as ref_obs_main
from repro_torch.core.engine import QueryEngine as _Engine
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.obs import (
    MetricsRegistry,
    SpanRecord,
    Tracer,
    chrome_trace,
    global_registry,
    load_chrome_trace,
    render_prometheus,
    request_decomposition,
    stage_breakdown,
    write_chrome_trace,
)
from repro_torch.obs import export as port_export
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.explain import QueryPlan, load_plans, write_plans
from repro_torch.obs.health import HealthMonitor, SLOTargets
from repro_torch.obs.ledger import (
    DEVICE_PLANES,
    RESIDENT_PLANES,
    ResourceLedger,
    measure_engine_planes,
)
from repro_torch.obs.metrics import LogHistogram
from repro_torch.serving import ServingMetrics, ServingRuntime

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)


def _engine(kb, **kw):
    """The port's engine on the CPU (with no device it runs on the card)."""
    return _Engine(kb, device="cpu", **kw)


def _runtime(kb, **kw):
    return ServingRuntime(kb, device="cpu", **kw)


# ---- tracer ---------------------------------------------------------------


class TestTracer:
    def test_disabled_is_noop(self):
        tr = Tracer()
        assert not tr.enabled
        with tr.span("outer", k=1) as s:
            assert s.trace_id == 0
            with tr.span("inner"):
                pass
        assert tr.alloc_id() == 0
        assert tr.begin_trace() == 0
        assert tr.record("x", 0.0, 1.0) == 0
        tr.record_batch(7, [("x", 0.0, 1.0, 0, 0, None)])
        assert len(tr) == 0

    def test_span_nesting_and_parenting(self):
        tr = Tracer().enable()
        with tr.span("outer") as outer:
            with tr.span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                assert inner.parent_id == outer.span_id
        spans = tr.drain()
        assert [s.name for s in spans] == ["inner", "outer"]  # exit order
        assert spans[0].parent_id == spans[1].span_id
        assert all(s.dur_ns >= 0 for s in spans)
        assert all(s.t0_ns > 0 for s in spans)

    def test_explicit_cross_thread_trace(self):
        tr = Tracer().enable()
        tid = tr.begin_trace()
        assert tid > 0
        out = []

        def worker():
            with tr.span("stage", trace=tid, parent=0):
                pass
            out.append(tr.record("manual", 1.0, 0.5, trace=tid))

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        spans = tr.drain()
        assert {s.trace_id for s in spans} == {tid}
        assert out[0] > 0
        manual = next(s for s in spans if s.name == "manual")
        assert manual.t0_ns == 1_000_000_000
        assert manual.dur_ns == 500_000_000

    def test_suppressed_trace_suppresses_descendants(self):
        # trace=0 means "unsampled request": nested spans must not
        # start fresh orphan traces
        tr = Tracer().enable()
        with tr.span("request", trace=0):
            with tr.span("child"):
                with tr.span("grandchild"):
                    pass
        assert tr.drain() == []

    def test_sampling_period(self):
        tr = Tracer(sample=0.25).enable()
        ids = [tr.begin_trace() for _ in range(100)]
        assert sum(1 for i in ids if i) == 25
        # 1-in-4: every 4th decision samples, starting with the first
        assert ids[0] > 0 and ids[1] == 0

        with pytest.raises(ValueError):
            tr.configure(sample=0.0)
        with pytest.raises(ValueError):
            tr.configure(sample=1.5)

    def test_ring_buffer_bounded(self):
        tr = Tracer(capacity=16).enable()
        for i in range(100):
            with tr.span("s", i=i):
                pass
        assert len(tr) == 16
        spans = tr.spans()   # non-destructive
        assert len(tr) == 16
        assert [s.args["i"] for s in spans] == list(range(84, 100))
        assert len(tr.drain()) == 16
        assert len(tr) == 0

    def test_record_batch(self):
        tr = Tracer().enable()
        tid = tr.begin_trace()
        rid = tr.alloc_id()
        tr.record_batch(tid, [
            ("queue_wait", 0.0, 0.1, 0, rid, None),
            ("score", 0.1, 0.2, 0, rid, {"batch": 4}),
            ("request", 0.0, 0.3, rid, 0, {"cached": False}),
        ])
        spans = tr.drain()
        assert [s.name for s in spans] == ["queue_wait", "score", "request"]
        assert all(s.trace_id == tid for s in spans)
        # zero span_id allocates; explicit span_id is preserved
        assert spans[2].span_id == rid
        assert spans[0].span_id not in (0, rid)
        assert spans[0].parent_id == rid
        assert spans[1].args == {"batch": 4}
        assert spans[0].args == {}
        # unsampled trace: nothing emitted
        tr.record_batch(0, [("x", 0.0, 1.0, 0, 0, None)])
        assert tr.drain() == []

    def test_negative_duration_clamped(self):
        tr = Tracer().enable()
        tid = tr.begin_trace()
        tr.record("clock_skew", 5.0, -0.001, trace=tid)
        (s,) = tr.drain()
        assert s.dur_ns == 0


# ---- exporters ------------------------------------------------------------


def _sample_spans():
    tr = Tracer().enable()
    tid = tr.begin_trace()
    rid = tr.alloc_id()
    tr.record_batch(tid, [
        ("queue_wait", 1.0, 0.010, 0, rid, None),
        ("flush_wait", 1.010, 0.002, 0, rid, None),
        ("score", 1.012, 0.030, 0, rid, {"batch": 8}),
        ("merge", 1.042, 0.001, 0, rid, None),
        ("request", 1.0, 0.043, rid, 0,
         {"k": 5, "generation": 3, "cached": False}),
    ])
    return tr.drain()


class TestChromeTrace:
    def test_round_trip_lossless(self, tmp_path):
        spans = _sample_spans()
        path = str(tmp_path / "trace.json")
        assert write_chrome_trace(path, spans) == len(spans)
        loaded = load_chrome_trace(path)
        assert len(loaded) == len(spans)
        for a, b in zip(spans, loaded):
            assert isinstance(b, SpanRecord)
            assert b.name == a.name
            assert b.trace_id == a.trace_id
            assert b.span_id == a.span_id
            assert b.parent_id == a.parent_id
            assert b.args == a.args
            # ts/dur ride as microsecond floats: ~1 ns quantization
            assert abs(b.t0_ns - a.t0_ns) <= 1
            assert abs(b.dur_ns - a.dur_ns) <= 1

    def test_perfetto_schema(self):
        doc = chrome_trace(_sample_spans())
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        for ev in doc["traceEvents"]:
            assert ev["ph"] == "X"
            assert ev["cat"] == "ragdb"
            assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(ev)
        json.dumps(doc)  # must be serializable as-is

    def test_foreign_events_skipped(self, tmp_path):
        path = str(tmp_path / "mixed.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": [
                {"name": "other", "ph": "M", "ts": 0},
                {"name": "noids", "ph": "X", "ts": 0, "dur": 1, "args": {}},
            ]}, f)
        assert load_chrome_trace(path) == []


class TestBreakdown:
    def test_stage_breakdown_stats(self):
        br = stage_breakdown(_sample_spans())
        assert set(br) == {"queue_wait", "flush_wait", "score",
                           "merge", "request"}
        s = br["score"]
        assert s["count"] == 1
        assert s["p50_s"] == s["p99_s"] == s["max_s"] == pytest.approx(0.030)

    def test_request_decomposition_tiles(self):
        reqs = request_decomposition(_sample_spans())
        assert len(reqs) == 1
        r = reqs[0]
        assert r["stage_sum_s"] == pytest.approx(r["request_s"], abs=1e-9)
        assert set(r["stages_s"]) == {"queue_wait", "flush_wait",
                                      "score", "merge"}

    def test_cached_requests_excluded(self):
        tr = Tracer().enable()
        tid = tr.begin_trace()
        tr.record("request", 0.0, 0.001, trace=tid, cached=True)
        assert request_decomposition(tr.drain()) == []

    def test_cli(self, tmp_path, capsys):
        path = str(tmp_path / "trace.json")
        write_chrome_trace(path, _sample_spans())
        assert obs_main([path]) == 0
        out = capsys.readouterr().out
        assert "queue_wait" in out and "p50_ms" in out
        assert "100.0% of end-to-end" in out

        assert obs_main([path, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert "stages" in doc and "requests" in doc

        assert obs_main([str(tmp_path / "missing.json")]) == 2


# ---- metrics registry -----------------------------------------------------


class TestMetricsRegistry:
    def test_get_or_create_identity(self):
        reg = MetricsRegistry()
        a = reg.counter("reqs_total", "help text", outcome="ok")
        b = reg.counter("reqs_total", outcome="ok")
        assert a is b
        c = reg.counter("reqs_total", outcome="err")
        assert c is not a
        a.inc()
        a.inc(2)
        c.inc()
        snap = reg.snapshot()
        assert snap["reqs_total{outcome=ok}"] == 3
        assert snap["reqs_total{outcome=err}"] == 1

    def test_kind_mismatch_rejected(self):
        reg = MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError, match="counter"):
            reg.gauge("x_total")

    def test_gauge_and_histogram_snapshot_keys(self):
        reg = MetricsRegistry()
        reg.gauge("lag_seconds").set(1.5)
        reg.histogram("lat_seconds").record(0.01)
        snap = reg.snapshot()
        assert snap["lag_seconds"] == 1.5
        assert snap["lat_seconds_count"] == 1
        assert snap["lat_seconds_sum"] == pytest.approx(0.01)
        assert {"lat_seconds_p50", "lat_seconds_p99",
                "lat_seconds_max", "lat_seconds_mean"} <= set(snap)

    def test_prometheus_rendering(self):
        reg = MetricsRegistry()
        reg.counter("ragdb_x_total", "things", kind="a").inc(4)
        reg.gauge("ragdb_lag_seconds").set(0.25)
        h = reg.histogram("ragdb_lat_seconds")
        h.record(0.02)
        text = render_prometheus(reg)
        assert "# HELP ragdb_x_total things" in text
        assert "# TYPE ragdb_x_total counter" in text
        assert 'ragdb_x_total{kind="a"} 4' in text
        assert "ragdb_lag_seconds 0.25" in text
        # histograms render summary-style
        assert "# TYPE ragdb_lat_seconds summary" in text
        assert 'ragdb_lat_seconds{quantile="0.5"}' in text
        assert 'ragdb_lat_seconds{quantile="0.99"}' in text
        assert "ragdb_lat_seconds_count 1" in text
        assert "ragdb_lat_seconds_sum 0.02" in text
        assert text.endswith("\n")

    def test_multi_registry_rendering(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        a.counter("a_total").inc()
        b.counter("b_total").inc()
        text = render_prometheus(a, b)
        assert "a_total 1" in text and "b_total 1" in text

    def test_global_registry_is_singleton(self):
        assert global_registry() is global_registry()

    # ---- series lifecycle (tenant evict/remount churn) ------------------

    def test_concurrent_get_or_create_many_tenants(self):
        """Get-or-create under concurrent tenants: every thread racing
        on the same (name, labels) must land on the same object, and
        the family must end with exactly one series per tenant."""
        reg = MetricsRegistry()
        tenants = [f"t{i:02d}" for i in range(8)]
        got: dict = {t: [] for t in tenants}
        barrier = threading.Barrier(16)

        def worker(wid: int):
            barrier.wait()
            for _ in range(50):
                t = tenants[(wid + _) % len(tenants)]
                c = reg.counter("ragdb_reqs_total", tenant=t)
                c.inc()
                got[t].append(c)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        series = reg.series("ragdb_reqs_total")
        assert len(series) == len(tenants)
        for t in tenants:
            assert len({id(c) for c in got[t]}) == 1  # one object per tenant
        total = sum(c.value for c in series.values())
        assert total == 16 * 50

    def test_prune_on_evict(self):
        reg = MetricsRegistry()
        reg.counter("ragdb_reqs_total", tenant="a").inc()
        reg.counter("ragdb_reqs_total", tenant="b").inc()
        reg.gauge("ragdb_publish_lag_seconds", tenant="a").set(1.0)
        reg.gauge("ragdb_other").set(2.0)
        removed = reg.prune(tenant="a")
        assert removed == 2
        assert "tenant=a" not in "".join(reg.snapshot())
        # the other tenant and unlabeled series are untouched
        snap = reg.snapshot()
        assert snap["ragdb_reqs_total{tenant=b}"] == 1
        assert snap["ragdb_other"] == 2.0
        # name-restricted prune only touches that family
        reg.counter("ragdb_reqs_total", tenant="c").inc()
        reg.gauge("ragdb_publish_lag_seconds", tenant="c").set(3.0)
        assert reg.prune("ragdb_reqs_total", tenant="c") == 1
        assert "ragdb_publish_lag_seconds{tenant=c}" in reg.snapshot()

    def test_prune_forgets_kind(self):
        """A fully-pruned family's kind is forgotten with it: the same
        name can be recreated as a different kind without the
        kind-mismatch rejection (and the rejection still applies while
        any series survives)."""
        reg = MetricsRegistry()
        reg.counter("ragdb_x", tenant="a")
        reg.counter("ragdb_x", tenant="b")
        reg.prune(tenant="a")
        with pytest.raises(ValueError, match="counter"):
            reg.gauge("ragdb_x", tenant="c")  # b's series keeps the kind
        reg.prune(tenant="b")  # family now empty -> removed
        g = reg.gauge("ragdb_x", tenant="c")  # recreate as a gauge
        g.set(7)
        assert reg.snapshot()["ragdb_x{tenant=c}"] == 7


# ---- LogHistogram edge cases ---------------------------------------------


class TestLogHistogram:
    def test_overflow_bucket(self):
        # beyond the last bound (~79 s) lands in the overflow bucket;
        # percentiles there report the observed max, not a midpoint
        h = LogHistogram()
        assert 100.0 > h.bounds[-1]
        h.record(100.0)
        h.record(250.0)
        assert h.n == 2
        assert h.counts[h.N_BUCKETS] == 2
        assert h.percentile(50) == 250.0
        assert h.percentile(99) == 250.0

    def test_percentile_monotonic_in_q(self):
        h = LogHistogram()
        for i in range(1, 1001):
            h.record(i * 1e-4)  # 0.1 ms .. 100 ms
        prev = 0.0
        for q in range(0, 101, 5):
            p = h.percentile(q)
            assert p >= prev
            prev = p
        assert h.percentile(0) >= h.min
        assert h.percentile(100) <= h.max

    def test_single_sample_clamp(self):
        h = LogHistogram()
        h.record(0.0123)
        assert h.percentile(50) == 0.0123
        assert h.percentile(99) == 0.0123
        assert h.percentile(99) == h.max
        assert h.mean == 0.0123

    def test_empty(self):
        h = LogHistogram()
        assert h.percentile(50) == 0.0
        assert h.mean == 0.0
        assert h.snapshot()["count"] == 0

    def test_concurrent_record_vs_snapshot(self):
        # record() and snapshot() share one lock: a snapshot taken
        # mid-stream must always be internally coherent (count == sum
        # of bucket counts implied by sum/mean relationship holds)
        h = LogHistogram()
        stop = threading.Event()
        errors = []

        def writer():
            i = 0
            while not stop.is_set():
                h.record(0.001 * (1 + i % 50))
                i += 1

        def reader():
            try:
                for _ in range(200):
                    s = h.snapshot()
                    assert s["count"] >= 0
                    if s["count"]:
                        assert s["mean"] == pytest.approx(
                            s["sum"] / s["count"])
                        assert 0 < s["p50"] <= s["max"]
                        assert s["p50"] <= s["p99"] <= s["max"]
            except Exception as exc:  # surfaced to the main thread
                errors.append(exc)

        threads = [threading.Thread(target=writer) for _ in range(2)]
        threads += [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads[2:]:
            t.join()
        stop.set()
        for t in threads[:2]:
            t.join()
        assert errors == []


# ---- ServingMetrics regression -------------------------------------------


class TestServingMetricsFormat:
    def test_format_includes_failed(self):
        m = ServingMetrics()
        m.on_submit()
        m.on_fail()
        text = m.format()
        assert "1 failed" in text
        assert m.snapshot()["failed"] == 1

    def test_render_prometheus_exposition(self):
        m = ServingMetrics()
        m.on_submit()
        m.on_complete(0.005)
        text = m.render()
        assert "ragdb_serving_requests_total 1" in text
        assert "ragdb_serving_completed_total 1" in text
        assert "ragdb_serving_latency_seconds_count 1" in text
DIM = 256


def _kb(n_docs: int = 40) -> KnowledgeBase:
    kb = KnowledgeBase(dim=DIM)
    for i in range(n_docs):
        kb.add_text(f"doc_{i:03d}.txt",
                    f"alpha beta entity INV-{i:04d} report gamma {i}")
    return kb


# ---- EXPLAIN --------------------------------------------------------------


class TestExplain:
    def test_plain_path_unchanged(self):
        """explain=False returns the bare results (no tuple) and the
        stats carry no per-query explain payload."""
        eng = _engine(_kb(), index="ivf", nprobe=2)
        out = eng.query_batch(["alpha INV-0003"], k=3)
        assert isinstance(out, list) and len(out[0]) == 3
        assert eng._last_index_stats.probe_order == ()

    def test_ivf_exact_plan_matches_index_stats(self):
        """The acceptance criterion: an ivf exact-mode plan's
        probed/widened/bound values are consistent with
        ``index_stats()``, and the kth score dominates the unprobed
        bound (the exactness certificate)."""
        eng = _engine(_kb(60), index="ivf", nprobe=2,
                          guarantee="exact")
        out, plans = eng.query_batch(
            ["lookup INV-0007 status", "alpha gamma report"],
            k=3, explain=True)
        stats = eng.index_stats()
        assert len(plans) == 2
        for p, rows in zip(plans, out):
            assert p.index == "ivf" and p.guarantee == "exact"
            assert p.clusters_probed == stats["clusters_probed"]
            assert p.n_clusters == stats["n_clusters"]
            assert p.rounds == stats["rounds"]
            assert p.rows_gathered == stats["candidate_rows"]
            assert len(p.probe_order) >= 1
            assert len(rows) == 3
            if p.unprobed_bound is not None:
                assert p.kth_score >= p.unprobed_bound
            assert p.stages  # engine stage durations captured
            assert "EXPLAIN" in p.render()

    def test_probe_mode_plan(self):
        eng = _engine(_kb(60), index="ivf", nprobe=1)
        _, plans = eng.query_batch(["alpha INV-0001"], k=2, explain=True)
        p = plans[0]
        assert p.guarantee == "probe"
        assert p.clusters_probed <= p.n_clusters
        assert p.kth_score is not None

    def test_flat_plan_and_vector_cache(self):
        eng = _engine(_kb())
        eng.query_batch(["alpha INV-0001"], k=2)  # warm the vector LRU
        _, plans = eng.query_batch(
            ["alpha INV-0001", "never seen before"], k=2, explain=True)
        assert plans[0].vector_cache == "hit"
        assert plans[1].vector_cache == "miss"
        assert plans[0].index == "flat"
        assert plans[0].n_docs == 40

    def test_plan_roundtrip_and_cli(self, tmp_path, capsys):
        eng = _engine(_kb(), index="ivf", nprobe=2, guarantee="exact")
        _, plans = eng.query_batch(["alpha INV-0002"], k=2, explain=True)
        path = tmp_path / "plans.json"
        write_plans(str(path), plans, extra={"rendered": plans[0].render()})
        loaded = load_plans(str(path))
        assert loaded[0].to_dict() == plans[0].to_dict()
        from repro_torch.obs.__main__ import main as obs_main
        assert obs_main(["explain", str(path)]) == 0
        out = capsys.readouterr().out
        assert "EXPLAIN" in out and "probe:" in out
        assert obs_main(["explain", str(path / "missing")]) == 2

    def test_no_tracer_spans_leak_from_collector(self):
        """EXPLAIN stage collection with the tracer disabled must not
        buffer spans (plan capture is collector-only)."""
        tracer = obs_trace.get()
        tracer.disable()
        tracer.drain()
        eng = _engine(_kb())
        eng.query_batch(["alpha"], k=2, explain=True)
        assert tracer.drain() == []


class TestServingExplain:
    def test_request_stages_tile_and_caches(self):
        kb = _kb()
        rt = _runtime(kb, max_batch=4, flush_deadline=0.002)
        with rt:
            served = rt.submit("lookup INV-0007 status", k=3,
                               explain=True).result(timeout=60)
            p = served.plan
            assert p is not None and p.result_cache == "miss"
            assert p.generation == served.generation
            names = [n for n, _ in p.request_stages]
            assert names == ["queue_wait", "flush_wait", "score", "merge"]
            residual = abs(sum(d for _, d in p.request_stages) - p.total_s)
            # the stages share the exact timestamps the span plane
            # records, so they tile end-to-end latency by construction
            assert residual < 1e-9
            # second submit: result-cache hit plan, no scoring dispatch
            served2 = rt.submit("lookup INV-0007 status", k=3,
                                explain=True).result(timeout=60)
            assert served2.cached
            assert served2.plan.result_cache == "hit"
            assert served2.plan.stages == ()
            assert "HIT" in served2.plan.render()

    def test_coalesced_fanout(self):
        """Two identical in-flight requests coalesce into one scoring
        dispatch; both plans report the fanout."""
        rt = _runtime(_kb(), max_batch=2, flush_deadline=0.5,
                            result_cache_size=0)
        with rt:
            f1 = rt.submit("alpha INV-0001", k=2, explain=True)
            f2 = rt.submit("alpha INV-0001", k=2, explain=True)
            p1, p2 = f1.result(timeout=60).plan, f2.result(timeout=60).plan
        assert p1.coalesced == 2 and p2.coalesced == 2
        assert p1.result_cache == "bypass"  # cache disabled for this run

    def test_submit_without_explain_has_no_plan(self):
        rt = _runtime(_kb(), max_batch=4, flush_deadline=0.002)
        with rt:
            served = rt.submit("alpha", k=2).result(timeout=60)
        assert served.plan is None


# ---- resource ledger ------------------------------------------------------


class TestLedger:
    def test_update_and_drop(self):
        reg = MetricsRegistry()
        led = ResourceLedger(registry=reg)
        led.update("a", {"doc_matrix": 1000, "result_cache": 50},
                   generation=3)
        led.update("a", {"ivf_state": 200}, generation=4)  # merge
        assert led.tenant_bytes("a") == 1250
        assert led.tenant_bytes("a", planes=DEVICE_PLANES) == 1200
        snap = led.snapshot()
        assert snap["tenants"]["a"]["generation"] == 4
        assert snap["resident_bytes"] == 1250
        assert reg.snapshot()["ragdb_resident_bytes{plane=doc_matrix,tenant=a}"] == 1000
        led.drop_tenant("a")
        assert led.tenant_bytes("a") == 0
        assert "ragdb_resident_bytes" not in "".join(reg.snapshot())

    def test_measure_engine_planes(self):
        kb = _kb()
        eng = _engine(kb, index="ivf", nprobe=2)
        eng.query_batch(["alpha"], k=2)  # materialize device state
        planes = measure_engine_planes(eng)
        assert planes["doc_matrix"] > 0
        assert planes["ivf_state"] > 0
        assert planes["container"] > 0
        assert set(planes) <= set(RESIDENT_PLANES)

    def test_runtime_resources_snapshot(self):
        rt = _runtime(_kb(), max_batch=4, flush_deadline=0.002)
        with rt:
            rt.submit("alpha INV-0001", k=2).result(timeout=60)
            rt.submit("alpha INV-0001", k=2).result(timeout=60)  # cache it
            res = rt.resources()
        t = res["tenants"]["default"]
        assert t["planes"]["doc_matrix"] > 0
        assert t["planes"]["result_cache"] > 0  # one cached entry
        assert res["resident_bytes"] >= res["device_bytes"] > 0


# ---- SLO health monitor ---------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeMetrics:
    def __init__(self):
        self.hist = LogHistogram()
        self.s = dict(requests=0, completed=0, rejected=0, failed=0,
                      cache_hits=0, cache_misses=0)

    def health_sample(self):
        return dict(self.s, latency_buckets=self.hist.bucket_snapshot())


def _monitor(**targets):
    clock = _FakeClock()
    fm = _FakeMetrics()
    t = SLOTargets(**{**dict(error_rate=0.2, p99_ms=None, reject_rate=None,
                             fast_window_s=1.0, slow_window_s=10.0,
                             min_samples=5), **targets})
    return HealthMonitor(fm, targets=t, registries=(), clock=clock), fm, clock


class TestHealthMonitor:
    def test_ok_degraded_critical_transitions(self):
        """The acceptance criterion: injected failures walk the monitor
        ok → degraded (fast-window burn ≥ 1x) → critical (fast ≥ 2x
        with slow-window confirmation)."""
        mon, fm, clock = _monitor()

        def tick(n_req, n_fail):
            clock.t += 1.0
            fm.s["requests"] += n_req
            fm.s["completed"] += n_req - n_fail
            fm.s["failed"] += n_fail
            fm.hist.record(0.01)
            return mon.check()

        for _ in range(10):
            out = tick(10, 0)
        assert out["status"] == "ok"
        for _ in range(2):
            out = tick(10, 3)  # 30% failures: burn 1.5x in fast window
        assert out["status"] == "degraded"
        assert any("error_rate" in r for r in out["reasons"])
        for _ in range(3):
            out = tick(10, 10)  # sustained 100% failures
        assert out["status"] == "critical"

    def test_latency_burn(self):
        mon, fm, clock = _monitor(error_rate=None, p99_ms=50.0)

        def tick(lat_s):
            clock.t += 1.0
            fm.s["requests"] += 10
            fm.s["completed"] += 10
            for _ in range(10):
                fm.hist.record(lat_s)
            return mon.check()

        for _ in range(5):
            out = tick(0.01)
        assert out["status"] == "ok"
        for _ in range(3):
            out = tick(0.5)  # p99 10x the 50 ms target, sustained
        assert out["status"] == "critical"
        assert any("p99" in r for r in out["reasons"])

    def test_min_samples_guard(self):
        """Thin traffic never judges the rate SLOs (no flapping on
        2-request windows)."""
        mon, fm, clock = _monitor(min_samples=50)
        for _ in range(5):
            clock.t += 1.0
            fm.s["requests"] += 2
            fm.s["failed"] += 2  # 100% failures, but thin
            out = mon.check()
        assert out["status"] == "ok"
        assert "min_samples" in out["signals"].get("note", "")

    def test_sanitizer_trip_is_critical(self):
        reg = MetricsRegistry()
        clock = _FakeClock()
        fm = _FakeMetrics()
        mon = HealthMonitor(
            fm, targets=SLOTargets(fast_window_s=1.0, slow_window_s=10.0),
            registries=(reg,), clock=clock)
        clock.t = 1.0
        mon.check()
        reg.counter("ragdb_sanitizer_trips_total", kind="nonfinite").inc()
        clock.t = 2.0
        out = mon.check()
        assert out["status"] == "critical"
        assert any("sanitizer" in r for r in out["reasons"])

    def test_widen_spike_degrades(self):
        reg = MetricsRegistry()
        clock = _FakeClock()
        fm = _FakeMetrics()
        mon = HealthMonitor(
            fm, targets=SLOTargets(widen_rounds_mean=3.0,
                                   fast_window_s=1.0, slow_window_s=10.0),
            registries=(reg,), clock=clock)
        clock.t = 1.0
        mon.check()
        for _ in range(4):
            reg.histogram("ragdb_ivf_widen_rounds").record(6.0)
        clock.t = 2.0
        out = mon.check()
        assert out["status"] == "degraded"
        assert any("widen" in r for r in out["reasons"])

    def test_publish_lag_detector(self):
        reg = MetricsRegistry()
        clock = _FakeClock()
        fm = _FakeMetrics()
        mon = HealthMonitor(
            fm, targets=SLOTargets(publish_lag_s=5.0, fast_window_s=1.0,
                                   slow_window_s=10.0),
            registries=(reg,), clock=clock)
        clock.t = 1.0
        mon.check()
        reg.gauge("ragdb_publish_lag_seconds", tenant="a").set(30.0)
        clock.t = 2.0
        out = mon.check()
        assert out["status"] == "degraded"
        assert any("publish lag" in r and "a" in r for r in out["reasons"])

    def test_runtime_health_exports(self):
        """ServingRuntime.health() returns a verdict and exports the
        status gauge into the runtime registry (Prometheus-visible)."""
        rt = _runtime(_kb(), max_batch=4, flush_deadline=0.002,
                            slo=SLOTargets(p99_ms=10_000.0))
        with rt:
            rt.submit("alpha", k=2).result(timeout=60)
            h1 = rt.health()
            h2 = rt.health()
            text = rt.render_metrics()
        assert h1["status"] == "ok" and h2["status"] == "ok"
        assert "ragdb_health_status 0" in text
        assert json.dumps(h2)  # verdict is JSON-serializable


# ---- tenant trace filter (the --tenant CLI plane) -------------------------


class TestTenantTraces:
    def _spans(self):
        from repro_torch.obs import SpanRecord
        mk = SpanRecord
        return [
            mk("request", 1, 10, 0, 0, 5_000_000, 0, {"tenant": "a"}),
            mk("score", 1, 11, 10, 0, 4_000_000, 0, {}),
            mk("request", 2, 20, 0, 0, 7_000_000, 0, {"tenant": "b"}),
            mk("request", 3, 30, 0, 0, 1_000_000, 0, {}),
        ]

    def test_filter_keeps_whole_traces(self):
        from repro_torch.obs.export import filter_tenant_traces
        kept = filter_tenant_traces(self._spans(), "a")
        assert {r.trace_id for r in kept} == {1}
        assert {r.name for r in kept} == {"request", "score"}

    def test_tenant_breakdown(self):
        from repro_torch.obs.export import tenant_breakdown
        tb = tenant_breakdown(self._spans())
        assert set(tb) == {"a", "b", "-"}
        assert tb["a"]["count"] == 1
        assert tb["b"]["p99_s"] == pytest.approx(0.007)

    def test_format_breakdown_has_tenant_table(self):
        from repro_torch.obs.export import format_breakdown
        out = format_breakdown(self._spans())
        assert "tenant" in out  # the per-tenant table header
        tenant_rows = [ln for ln in out.splitlines()
                       if ln.startswith(("a ", "b ", "- "))]
        assert len(tenant_rows) == 3

    def test_no_tenant_table_for_unlabeled_traces(self):
        from repro_torch.obs import SpanRecord
        from repro_torch.obs.export import format_breakdown
        spans = [SpanRecord("request", 1, 10, 0, 0, 5_000_000, 0, {})]
        assert "tenant" not in format_breakdown(spans)


# ==========================================================================
# parity: the two packages on the same inputs
# ==========================================================================

def _ref_sample_spans():
    """``_sample_spans`` through the JAX package's tracer."""
    tr = ref_obs.Tracer().enable()
    tid = tr.begin_trace()
    rid = tr.alloc_id()
    tr.record_batch(tid, [
        ("queue_wait", 1.0, 0.010, 0, rid, None),
        ("flush_wait", 1.010, 0.002, 0, rid, None),
        ("score", 1.012, 0.030, 0, rid, {"batch": 8}),
        ("merge", 1.042, 0.001, 0, rid, None),
        ("request", 1.0, 0.043, rid, 0,
         {"k": 5, "generation": 3, "cached": False}),
    ])
    return tr.drain()


def _fields(span) -> tuple:
    return (span.name, span.trace_id, span.span_id, span.parent_id,
            span.t0_ns, span.dur_ns, span.tid, span.args)


class TestParityTraces:
    def test_tracers_record_the_same_spans(self):
        assert [_fields(s) for s in _sample_spans()] == \
            [_fields(s) for s in _ref_sample_spans()]

    def test_chrome_trace_files_equal_byte_for_byte(self, tmp_path):
        port, ref = tmp_path / "port.json", tmp_path / "ref.json"
        write_chrome_trace(str(port), _sample_spans())
        ref_obs.write_chrome_trace(str(ref), _ref_sample_spans())
        assert port.read_bytes() == ref.read_bytes()
        # and each package loads the other's file to the same records
        assert [_fields(s) for s in load_chrome_trace(str(ref))] == \
            [_fields(s) for s in ref_obs.load_chrome_trace(str(port))]

    def test_breakdowns_equal(self):
        spans, ref_spans = _sample_spans(), _ref_sample_spans()
        assert stage_breakdown(spans) == ref_obs.stage_breakdown(ref_spans)
        assert request_decomposition(spans) == \
            ref_obs.request_decomposition(ref_spans)
        assert chrome_trace(spans) == ref_obs.chrome_trace(ref_spans)

    @pytest.mark.parametrize("flags", [[], ["--json"], ["--tenant", "a"]])
    def test_cli_prints_the_same_for_a_trace(self, tmp_path, capsys, flags):
        path = str(tmp_path / "trace.json")
        spans = _sample_spans() + [
            SpanRecord("request", 9, 90, 0, 2_000_000_000, 5_000_000, 0,
                       {"tenant": "a"}),
            SpanRecord("score", 9, 91, 90, 2_000_000_000, 4_000_000, 0, {}),
        ]
        write_chrome_trace(path, spans)
        assert obs_main([path, *flags]) == 0
        port_out = capsys.readouterr().out
        assert ref_obs_main([path, *flags]) == 0
        assert port_out == capsys.readouterr().out
        assert port_out

    def test_tenant_trace_helpers_equal(self):
        spans = TestTenantTraces()._spans()
        ref_spans = [ref_obs.SpanRecord(s.name, s.trace_id, s.span_id,
                                        s.parent_id, s.t0_ns, s.dur_ns,
                                        s.tid, s.args) for s in spans]
        assert [_fields(s) for s in port_export.filter_tenant_traces(
            spans, "a")] == [_fields(s) for s in
                             ref_export.filter_tenant_traces(ref_spans, "a")]
        assert port_export.tenant_breakdown(spans) == \
            ref_export.tenant_breakdown(ref_spans)
        assert port_export.format_breakdown(spans) == \
            ref_export.format_breakdown(ref_spans)


class TestParityMetrics:
    @staticmethod
    def _drive(reg):
        reg.counter("ragdb_x_total", "things", kind="a").inc(4)
        reg.counter("ragdb_x_total", "things", kind="b").inc()
        reg.gauge("ragdb_lag_seconds", tenant="t").set(0.25)
        h = reg.histogram("ragdb_lat_seconds", "latency")
        for i in range(1, 200):
            h.record(i * 3.7e-4)
        return reg

    def test_prometheus_text_and_snapshot_equal(self):
        port = self._drive(MetricsRegistry())
        ref = self._drive(ref_obs.MetricsRegistry())
        assert render_prometheus(port) == ref_obs.render_prometheus(ref)
        assert port.snapshot() == ref.snapshot()
        assert port.prune(tenant="t") == ref.prune(tenant="t") == 1
        assert port.snapshot() == ref.snapshot()

    def test_log_histograms_equal(self):
        from repro.obs.metrics import LogHistogram as RefHistogram

        port, ref = LogHistogram(), RefHistogram()
        assert list(port.bounds) == list(ref.bounds)
        samples = np.random.default_rng(4).lognormal(-5, 2, 500)
        for x in samples.tolist() + [100.0, 0.0]:
            port.record(x)
            ref.record(x)
        assert port.snapshot() == ref.snapshot()
        assert port.bucket_snapshot() == ref.bucket_snapshot()
        assert [port.percentile(q) for q in range(0, 101, 5)] == \
            [ref.percentile(q) for q in range(0, 101, 5)]

    def test_serving_metrics_render_equal(self):
        from repro.serving import ServingMetrics as RefServingMetrics

        port, ref = ServingMetrics(), RefServingMetrics()
        for m in (port, ref):
            m.on_submit()
            m.on_submit()
            m.on_batch(2, 1)
            m.on_complete(0.005)
            m.on_fail()
            m.on_cache_miss()
        assert port.render() == ref.render()
        keep = ("requests", "completed", "failed", "batches",
                "batch_occupancy_mean", "scored_queries", "cache_misses")
        assert {k: port.snapshot()[k] for k in keep} == \
            {k: ref.snapshot()[k] for k in keep}


def _verdicts(monitor_cls, targets_cls, registry_cls):
    """The health verdicts of one scripted run: failures, a latency burn,
    a sanitizer trip and a publish lag."""
    clock = _FakeClock()
    fm = _FakeMetrics()
    reg = registry_cls()
    mon = monitor_cls(fm, targets=targets_cls(
        error_rate=0.2, p99_ms=50.0, publish_lag_s=5.0, fast_window_s=1.0,
        slow_window_s=10.0, min_samples=5), registries=(reg,), clock=clock)
    out = []
    for step in range(16):
        clock.t += 1.0
        fail = 0 if step < 6 else (3 if step < 9 else 10)
        fm.s["requests"] += 10
        fm.s["completed"] += 10 - fail
        fm.s["failed"] += fail
        for _ in range(10):
            fm.hist.record(0.01 if step < 11 else 0.5)
        if step == 13:
            reg.counter("ragdb_sanitizer_trips_total", rule="retrace").inc()
        if step == 14:
            reg.gauge("ragdb_publish_lag_seconds", tenant="a").set(30.0)
        out.append(mon.check())
    return out


def test_health_verdicts_equal():
    port = _verdicts(HealthMonitor, SLOTargets, MetricsRegistry)
    ref = _verdicts(ref_health.HealthMonitor, ref_health.SLOTargets,
                    ref_obs.MetricsRegistry)
    assert [v["status"] for v in port] == [v["status"] for v in ref]
    assert {"ok", "degraded", "critical"} <= {v["status"] for v in port}
    assert port == ref


# ---- plans and ledger on one state ---------------------------------------

def _texts(n_docs):
    return [(f"doc_{i:03d}.txt",
             f"alpha beta entity INV-{i:04d} report gamma {i} "
             + ("delta " * (i % 7)) + ("epsilon" if i % 3 else "zeta"))
            for i in range(n_docs)]


def _both(n_docs=90):
    port, ref = KnowledgeBase(dim=DIM), RefKB(dim=DIM)
    for name, text in _texts(n_docs):
        port.add_text(name, text)
        ref.add_text(name, text)
    return port, ref


_QUERIES = ["lookup INV-0007 status", "alpha gamma report",
            "delta delta zeta", "never seen words"]
# timings differ between any two runs; every other field is data
_TIMED = ("stages", "request_stages", "total_s")


def _plan_data(plan) -> dict:
    d = plan.to_dict()
    d["stage_names"] = [(n, a) for n, _, a in d["stages"]]
    return {k: v for k, v in d.items() if k not in _TIMED}


@pytest.mark.parametrize("trained_by", ["jax", "port"])
@pytest.mark.parametrize("kw", [
    {}, {"index": "ivf", "nprobe": 2},
    {"index": "ivf", "nprobe": 2, "guarantee": "exact"},
    {"index": "ivf", "nprobe": 1, "guarantee": "exact"},
], ids=["flat", "ivf-probe", "ivf-exact", "ivf-exact-nprobe1"])
def test_query_plans_equal_on_an_adopted_ivf_state(tmp_path, kw, trained_by):
    """One IVF state, trained by one package and adopted by the other
    from its container (no retrain): the EXPLAIN plans of the same
    queries agree field for field, ``probe_order`` included."""
    port_kb, ref_kb = _both()
    path = str(tmp_path / "kb.ragdb")
    if trained_by == "jax":
        first = RefEngine(ref_kb, **kw)
        first.query_batch(["alpha"], k=2)
        ref_kb.save(path)
        port_kb = KnowledgeBase.load(path)
        ref_eng = first
        port_eng = _engine(port_kb, **kw)
        adopted = port_eng
    else:
        first = _engine(port_kb, **kw)
        first.query_batch(["alpha"], k=2)
        port_kb.save(path)
        ref_kb = RefKB.load(path)
        port_eng = first
        ref_eng = RefEngine(ref_kb, **kw)
        adopted = ref_eng
    if kw:
        assert adopted.retrains == 0
    ref_eng.query_batch(_QUERIES[:1], k=3)  # the same vector-cache state
    port_eng.query_batch(_QUERIES[:1], k=3)
    ref_out, ref_plans = ref_eng.query_batch(_QUERIES, k=3, explain=True)
    out, plans = port_eng.query_batch(_QUERIES, k=3, explain=True)
    assert [[r.doc_id for r in row] for row in out] == \
        [[r.doc_id for r in row] for row in ref_out]
    assert len(plans) == len(ref_plans) == len(_QUERIES)
    for p, rp in zip(plans, ref_plans):
        assert _plan_data(p) == _plan_data(rp)
    if kw:
        assert any(len(p.probe_order) for p in plans)
    # the stats the plans are consistent with agree too, but for the
    # retrain count: one side trained the state, the other adopted it
    stats, ref_stats = port_eng.index_stats(), ref_eng.index_stats()
    assert stats.pop("retrains") + ref_stats.pop("retrains") == (
        1 if kw else 0)
    assert stats == ref_stats


def test_plans_cli_prints_the_same(tmp_path, capsys):
    eng = _engine(_kb(), index="ivf", nprobe=2, guarantee="exact")
    _, plans = eng.query_batch(["alpha INV-0002", "gamma"], k=2,
                               explain=True)
    path = str(tmp_path / "plans.json")
    write_plans(path, plans, extra={"rendered": plans[0].render()})
    ref_path = str(tmp_path / "ref_plans.json")
    ref_explain.write_plans(ref_path, [ref_explain.QueryPlan.from_dict(
        p.to_dict()) for p in plans], extra={"rendered": plans[0].render()})
    assert open(path).read() == open(ref_path).read()
    assert obs_main(["explain", path]) == 0
    port_out = capsys.readouterr().out
    assert ref_obs_main(["explain", path]) == 0
    assert port_out == capsys.readouterr().out
    assert "EXPLAIN" in port_out and "probe:" in port_out
    assert [p.to_dict() for p in load_plans(path)] == \
        [p.to_dict() for p in ref_explain.load_plans(path)]


@pytest.mark.parametrize("kw", [
    {}, {"index": "ivf", "nprobe": 2}, {"scoring_path": "gemm"},
    {"scoring_path": "kernel"},
], ids=["flat-map", "ivf", "gemm", "kernel"])
def test_ledger_planes_equal_byte_for_byte(tmp_path, kw):
    """``measure_engine_planes`` of the two packages' engines over the
    same state: every plane the same bytes, but the kernel operands,
    which the port counts once with the doc matrix they are (the
    repaired double count; the JAX package counts its padded copy)."""
    port_kb, ref_kb = _both()
    path = str(tmp_path / "kb.ragdb")
    port_kb.save(path)
    port_kb = KnowledgeBase.load(path)
    ref_kb = RefKB.load(path)
    port = _engine(port_kb, **kw)
    ref = RefEngine(ref_kb, **kw)
    port.query_batch(["alpha"], k=2)
    ref.query_batch(["alpha"], k=2)
    planes = measure_engine_planes(port)
    ref_planes = ref_ledger.measure_engine_planes(ref)
    assert set(planes) == set(ref_planes)
    if kw.get("scoring_path") == "kernel":
        assert ref_planes.pop("kernel_operands") > 0
        assert planes.pop("kernel_operands") == 0
    assert planes == ref_planes
    assert planes["doc_matrix"] > 0 and planes["container"] > 0
    # the ledgers built from them account and export alike
    port_reg, ref_reg = MetricsRegistry(), ref_obs.MetricsRegistry()
    port_led = ResourceLedger(registry=port_reg)
    ref_led = ref_ledger.ResourceLedger(registry=ref_reg)
    port_led.update("t", planes, generation=3)
    ref_led.update("t", ref_planes, generation=3)
    assert port_led.snapshot() == ref_led.snapshot()
    assert port_led.tenant_bytes("t", planes=DEVICE_PLANES) == \
        ref_led.tenant_bytes("t", planes=ref_ledger.DEVICE_PLANES)
    assert render_prometheus(port_reg) == ref_obs.render_prometheus(ref_reg)
