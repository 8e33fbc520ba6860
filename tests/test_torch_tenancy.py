"""The port's tenancy plane against the JAX package's, on the CPU.

Every contract of the JAX package's tenancy tests and its eviction crash
matrix, run through both packages: the same traffic goes, one request
at a time, to the JAX package's ``ContainerPool`` and to the port's
(``device="cpu"``) on copies of one root.  Served ids and scores are
bit-identical on the map path (α = 1, β ∈ {0, 1}), and after the same
evictions the containers and journals on disk are equal byte for byte.
The port's resource ledger counts each storage once, so a byte budget
of n tenants keeps n resident on the kernel path too.
"""
import os
import shutil
import threading
import weakref
from types import SimpleNamespace

import pytest
import torch

from repro.core import container as ref_container_mod
from repro.core import ingest as ref_ingest_mod
from repro.core.engine import QueryEngine as RefEngine
from repro.core.ingest import KnowledgeBase as RefKB
from repro.obs import ledger as ref_ledger
from repro.obs.export import render_prometheus as ref_render
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.serving import RequestRejected as RefRejected
from repro.serving import ServingRuntime as RefRuntime
from repro.serving.snapshot import EngineSnapshot as RefSnapshot
from repro import tenancy as ref_tenancy
from repro_torch.core import container as port_container_mod
from repro_torch.core import ingest as port_ingest_mod
from repro_torch.core.engine import QueryEngine as PortEngine
from repro_torch.core.ingest import KnowledgeBase as PortKB
from repro_torch.data.corpus import make_corpus
from repro_torch.obs import ledger as port_ledger
from repro_torch.obs.export import render_prometheus as port_render
from repro_torch.obs.metrics import MetricsRegistry as PortRegistry
from repro_torch.serving import RequestRejected as PortRejected
from repro_torch.serving import ServingRuntime as PortRuntime
from repro_torch.serving import cache as port_cache
from repro_torch.serving import scheduler as port_scheduler
from repro_torch.serving.snapshot import EngineSnapshot as PortSnapshot
from repro_torch import tenancy as port_tenancy

# the suite runs test files in parallel workers: keep this file's torch
# ops on one thread so they do not starve the other workers
torch.set_num_threads(1)

DIM = 128

PKGS = {
    "ref": SimpleNamespace(
        KB=RefKB, Engine=RefEngine, Runtime=RefRuntime,
        Rejected=RefRejected, Snapshot=RefSnapshot, Registry=RefRegistry,
        ledger=ref_ledger, render=ref_render, t=ref_tenancy,
        ingest=ref_ingest_mod, container=ref_container_mod, engine_kw={}),
    "port": SimpleNamespace(
        KB=PortKB, Engine=PortEngine, Runtime=PortRuntime,
        Rejected=PortRejected, Snapshot=PortSnapshot, Registry=PortRegistry,
        ledger=port_ledger, render=port_render, t=port_tenancy,
        ingest=port_ingest_mod, container=port_container_mod,
        engine_kw={"device": "cpu"}),
}


def _docs(n=12, seed=0):
    docs, entities = make_corpus(n_docs=n, n_entities=4, seed=seed)
    return docs, list(entities)


def _fill(kb, docs, tag: str):
    for i, d in enumerate(docs):
        kb.add_text(f"{tag}_{i:03d}.txt", f"{d} tenant {tag}")


def _pool(p, root, **kw):
    kw.setdefault("kb_kwargs", {"dim": DIM})
    kw.setdefault("registry", p.Registry())
    return p.t.ContainerPool(str(root), **p.engine_kw, **kw)


def _runtime(p, pool, **kw):
    return p.Runtime(pool=pool, **kw)


def _seed_tenant(pool, tenant, docs):
    """Mount, ingest, durably publish, leave resident."""
    with pool.pinned(tenant) as mt:
        _fill(mt.kb, docs, tenant)
        mt.snapshots.publish(durable=True)


def _rows(results):
    """Result lists as plain tuples: ids, scores, cosines, boost flags."""
    return [[(r.doc_id, r.score, r.cosine, r.boosted) for r in row]
            for row in results]


def _files(root) -> dict:
    """Every file under the pool root, by name: the containers, journals
    and journal manifests."""
    root = str(root)
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def _both(scenario, tmp_path, *args, seed_root=None):
    """Run ``scenario(p, root, *args)`` for both packages, each on its
    own copy of ``seed_root`` (or of an empty root); returns
    {package name: the scenario's observations}."""
    out = {}
    for name, p in PKGS.items():
        root = tmp_path / name / "tenants"
        if seed_root is not None:
            shutil.copytree(seed_root, root)
        out[name] = scenario(p, root, *args)
    return out


def _same(obs):
    assert obs["port"] == obs["ref"]
    return obs["port"]


@pytest.fixture
def seeded_root(tmp_path):
    """Tenants "a" and "b" (different corpora), each durably published,
    written by both packages: the two roots are byte-identical, and the
    tests run both packages on copies of one of them."""
    roots = {}
    for name, p in PKGS.items():
        pool = _pool(p, tmp_path / f"seed_{name}")
        for t, seed in (("a", 0), ("b", 1)):
            _seed_tenant(pool, t, _docs(seed=seed)[0])
        pool.drain()
        roots[name] = tmp_path / f"seed_{name}"
    assert _files(roots["ref"]) == _files(roots["port"])
    return roots["port"]


# --------------------------------------------------------------------------
# pool: mount / pin / LRU evict
# --------------------------------------------------------------------------

def _lazy_mount_lru(p, root):
    docs, _ = _docs()
    pool = _pool(p, root, max_resident=2)
    for t in ("a", "b", "c"):
        _seed_tenant(pool, t, docs)
    after_three = pool.resident_tenants()
    with pool.pinned("b"):
        pass
    _seed_tenant(pool, "d", docs)
    after_d = pool.resident_tenants()
    with pool.pinned("a") as mt:
        remount = (mt.kb.n_docs, _rows(
            mt.snapshots.current.query_batch(["tenant a"], k=3)))
    return after_three, after_d, remount, _files(root)


def test_pool_lazy_mount_and_lru_eviction(tmp_path):
    after_three, after_d, (n_docs, _), files = _same(
        _both(_lazy_mount_lru, tmp_path))
    # budget 2: "a" (LRU-coldest) was evicted when "c" mounted; touching
    # "b" bumps recency, so mounting "d" evicts "c"
    assert after_three == ["b", "c"]
    assert after_d == ["b", "d"]
    # remount of an evicted tenant replays its durable container
    assert n_docs == 12
    assert len(files) >= 4


def _pinned_never_evicted(p, root):
    docs, _ = _docs()
    pool = _pool(p, root, max_resident=1)
    mt_a = pool.pin("a")
    _fill(mt_a.kb, docs, "a")
    # mounting "b" while "a" is pinned exceeds the budget: "a" survives
    _seed_tenant(pool, "b", docs)
    survived = "a" in pool.resident_tenants()
    with pytest.raises(RuntimeError, match="pins"):
        pool.evict("a")
    pool.unpin("a")
    pool.evict("a")  # unpinned now: durably publishes and unmounts
    gone = "a" not in pool.resident_tenants()
    with pool.pinned("a") as mt:
        n_docs = mt.kb.n_docs
    return survived, gone, n_docs, _files(root)


def test_pool_pinned_tenant_is_never_evicted(tmp_path):
    survived, gone, n_docs, _ = _same(_both(_pinned_never_evicted, tmp_path))
    assert survived and gone
    assert n_docs == 12  # nothing lost


def _evict_publishes_pending(p, root):
    docs, entities = _docs()
    pool = _pool(p, root, max_resident=8)
    with pool.pinned("a") as mt:
        _fill(mt.kb, docs, "a")
        mt.snapshots.publish(durable=False)  # in memory only
        want = _rows(mt.snapshots.current.query_batch([entities[0]], k=3))
    pool.evict("a")  # must flush the pending state durably first
    with pool.pinned("a") as mt:
        got = _rows(mt.snapshots.current.query_batch([entities[0]], k=3))
        n_docs = mt.kb.n_docs
    return want, got, n_docs, _files(root)


def test_pool_eviction_durably_publishes_pending_generations(tmp_path):
    want, got, n_docs, _ = _same(_both(_evict_publishes_pending, tmp_path))
    assert n_docs == 12
    assert got == want  # the post-evict remount serves the same bits


def _untouched(p, root):
    pool = _pool(p, root, max_resident=8)
    with pool.pinned("ghost"):
        pass  # mounted, never mutated
    pool.evict("ghost")
    return os.path.exists(pool.container_path("ghost")), _files(root)


def test_pool_eviction_skips_untouched_tenants(tmp_path):
    written, files = _same(_both(_untouched, tmp_path))
    # no container written for a tenant that never held state
    assert not written and files == {}


def _byte_budget(p, root):
    docs, _ = _docs()
    pool = _pool(p, root, max_resident=100, max_resident_bytes=1)
    _seed_tenant(pool, "a", docs)
    # "a" alone exceeds one byte, but it was pinned during seeding; the
    # next pin transition collects it
    _seed_tenant(pool, "b", docs)
    return pool.resident_tenants(), _files(root)


def test_pool_byte_budget_evicts(tmp_path):
    resident, _ = _same(_both(_byte_budget, tmp_path))
    assert "a" not in resident


def test_pool_unpin_without_pin_raises(tmp_path):
    for name, p in PKGS.items():
        pool = _pool(p, tmp_path / name)
        with pytest.raises(RuntimeError, match="unpin"):
            pool.unpin("nope")


@pytest.mark.parametrize("bad", ["", "../escape", "a/b", ".hidden",
                                 "x" * 65, None, 7])
def test_tenant_id_validation(tmp_path, bad):
    for name, p in PKGS.items():
        pool = _pool(p, tmp_path / name)
        with pytest.raises((ValueError, TypeError)):
            p.t.validate_tenant(bad)
        with pytest.raises((ValueError, TypeError)):
            pool.pin(bad)
        assert p.t.validate_tenant("team-7.alpha_X") == "team-7.alpha_X"


def _metrics(p, root):
    docs, _ = _docs()
    reg = p.Registry()
    pool = _pool(p, root, max_resident=1, registry=reg)
    _seed_tenant(pool, "a", docs)
    _seed_tenant(pool, "b", docs)  # evicts "a"
    text = p.render(reg)
    return (
        'ragdb_tenant_mounts_total{tenant="b"} 1' in text,
        'tenant="a"' in text,
        "ragdb_tenant_evictions_total 1" in text,
        "ragdb_tenant_resident_bytes" in text,
        "ragdb_resident_bytes" in text,
        pool.stats()["resident"],
    )


def test_pool_metrics_accounting(tmp_path):
    # the resident tenant's series exist; the evicted tenant's were
    # pruned wholesale and the eviction shows in the unlabeled counter
    assert _same(_both(_metrics, tmp_path)) == (True, False, True, True,
                                                True, 1)


def _ledger_series(p, root):
    docs, _ = _docs()
    pool = _pool(p, root, max_resident=1)
    device = p.ledger.DEVICE_PLANES
    _seed_tenant(pool, "a", docs)
    seeded = pool.ledger.tenant_bytes("a", planes=device)
    _seed_tenant(pool, "b", docs)  # evicts "a"
    after = (pool.ledger.tenant_bytes("a"),
             "a" in pool.ledger.snapshot()["tenants"])
    with pool.pinned("a"):
        remounted = pool.ledger.tenant_bytes("a", planes=device)
    return seeded, after, remounted


def test_pool_evict_clears_ledger_and_series(tmp_path):
    seeded, after, remounted = _same(_both(_ledger_series, tmp_path))
    assert seeded > 0 and after == (0, False)
    assert remounted == seeded  # recreated fresh, no stale carryover


def _resident_bytes(p, root):
    docs, _ = _docs()
    pool = _pool(p, root, max_resident=4)
    for t in ("a", "b", "c"):
        _seed_tenant(pool, t, docs)
    ledger_sum = sum(
        pool.ledger.tenant_bytes(t, planes=p.ledger.DEVICE_PLANES)
        for t in ("a", "b", "c"))
    return pool.stats()["resident_bytes"], ledger_sum


def test_pool_resident_bytes_matches_ledger(tmp_path):
    """Eviction decisions consume ledger bytes: the pool's reported
    resident total equals the ledger's device-plane sum."""
    stats_bytes, ledger_sum = _same(_both(_resident_bytes, tmp_path))
    assert stats_bytes == ledger_sum > 0


# --------------------------------------------------------------------------
# quotas (one fake clock for both packages)
# --------------------------------------------------------------------------

def _bucket(p):
    b = p.t.TokenBucket(rate=10.0, burst=2)
    t0 = 100.0
    return [b.try_acquire(t0), b.try_acquire(t0), b.try_acquire(t0),
            b.try_acquire(t0 + 0.05), b.try_acquire(t0 + 0.15),
            b.try_acquire(t0 + 100.0), b.try_acquire(t0 + 100.0),
            b.try_acquire(t0 + 100.0), b.tokens]


def test_token_bucket_deterministic_refill():
    got = _same({name: _bucket(p) for name, p in PKGS.items()})
    # burst of 2, then empty; 0.5 tokens back is not enough, 1.5 is;
    # refill never exceeds the burst
    assert got[:8] == [True, True, False, False, True, True, True, False]
    for name, p in PKGS.items():
        with pytest.raises(ValueError):
            p.t.TokenBucket(rate=0)
        with pytest.raises(ValueError):
            p.t.TokenBucket(rate=1.0, burst=0.5)


def _quotas(p):
    q = p.t.TenantQuotas(default_rate=1.0, default_burst=1)
    q.set("vip", rate=1000.0, burst=100)
    t0 = 50.0
    return (q.try_acquire("joe", t0), q.try_acquire("joe", t0),
            all(q.try_acquire("vip", t0) for _ in range(100)),
            q.try_acquire("vip", t0),
            all(p.t.TenantQuotas().try_acquire("any") for _ in range(10)))


def test_tenant_quotas_default_and_override():
    # default burst spent after one; vip's own bucket; no default at
    # all means unlimited
    assert _same({name: _quotas(p) for name, p in PKGS.items()}) == \
        (True, False, True, False, True)


def _quota_rejection(p, root):
    docs, entities = _docs()
    pool = _pool(p, root)
    quotas = p.t.TenantQuotas()
    quotas.set("greedy", rate=0.001, burst=1)
    rt = _runtime(p, pool, quotas=quotas, max_batch=4, flush_deadline=0.0)
    with rt:
        with rt.tenant_writer("greedy") as kb:
            _fill(kb, docs, "greedy")
        rt.publish(tenant="greedy")
        first = _rows([rt.submit(entities[0], k=2, tenant="greedy")
                       .result(timeout=30).results])
        with pytest.raises(p.Rejected) as exc:
            rt.submit(entities[0], k=2, tenant="greedy")
            rt.submit(entities[1], k=2, tenant="greedy")
        calm = rt.submit("hello", k=2, tenant="calm").result(timeout=30)
        rejected = rt.metrics.tenant_snapshot()["greedy"]["rejected"]
    pool.drain()
    return first, exc.value.tenant, calm.results, rejected, _files(root)


def test_runtime_quota_rejection_carries_tenant(tmp_path):
    first, tenant, calm, rejected, _ = _same(
        _both(_quota_rejection, tmp_path))
    assert first[0] and tenant == "greedy"
    assert calm == []  # an unthrottled tenant is unaffected
    assert rejected >= 1


# --------------------------------------------------------------------------
# router
# --------------------------------------------------------------------------

def _router(p, root):
    docs, _ = _docs()
    pool = _pool(p, root)
    router = p.t.TenantRouter(pool)
    cold = (router.peek_generation("a"), pool.resident_tenants())
    with router.writer("a") as mt:
        _fill(mt.kb, docs, "a")
    gen = router.publish("a", durable=True)
    return cold, gen, router.peek_generation("a"), router.tenants(), \
        _files(root)


def test_router_publish_and_peek(tmp_path):
    cold, gen, peek, tenants, _ = _same(_both(_router, tmp_path))
    assert cold == (None, [])  # peek never mounts
    assert gen == 12 == peek and tenants == ["a"]


def test_default_tenant_is_the_cache_and_scheduler_keyspace():
    assert port_tenancy.DEFAULT_TENANT == port_cache.DEFAULT_KEYSPACE \
        == port_scheduler.DEFAULT_TENANT == ref_tenancy.DEFAULT_TENANT
    assert port_tenancy.__all__ == ref_tenancy.__all__


# --------------------------------------------------------------------------
# multi-tenant runtime: parity, isolation, eviction hygiene
# --------------------------------------------------------------------------

def _served_vs_direct(p, root, beta):
    """Each seeded tenant served through the runtime (one request at a
    time) and queried directly on an engine over its loaded container."""
    _, entities = _docs()
    pool = _pool(p, root, beta=beta)
    rt = _runtime(p, pool, max_batch=8, flush_deadline=0.0,
                  result_cache_size=0)
    queries = [*entities, "quarterly forecast", ""]
    served, direct = {}, {}
    with rt:
        for t in ("a", "b"):
            for q in queries:
                served[t, q] = _rows(
                    [rt.submit(q, k=3, tenant=t).result(timeout=60).results])
    for t in ("a", "b"):
        engine = p.Engine(p.KB.load(pool.container_path(t)), beta=beta,
                          **p.engine_kw)
        direct.update({(t, q): _rows(engine.query_batch([q], k=3))
                       for q in queries})
    pool.drain()
    return served, direct, _files(root)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_multi_tenant_results_match_direct_engines(tmp_path, seeded_root,
                                                   beta):
    served, direct, _ = _same(_both(_served_vs_direct, tmp_path, beta,
                                    seed_root=seeded_root))
    assert served == direct
    assert any(row for rows in served.values() for row in rows)


def _keyspaces(p, root):
    _, entities = _docs()
    pool = _pool(p, root)
    rt = _runtime(p, pool, max_batch=4, flush_deadline=0.0,
                  result_cache_size=64)
    q = entities[0]
    with rt:
        first = [rt.submit(q, k=3, tenant=t).result(timeout=30)
                 for t in ("a", "b")]
        hits = [rt.submit(q, k=3, tenant=t).result(timeout=30)
                for t in ("a", "b")]
    return ([s.generation for s in first], [s.cached for s in hits],
            [_rows([s.results]) for s in first],
            [_rows([s.results]) for s in hits])


def test_result_cache_keyspaces_isolate_tenants(tmp_path, seeded_root):
    """Two tenants at the SAME generation with the SAME query text do
    not share cache entries — the keyspace is the isolation boundary."""
    gens, cached, first, hits = _same(_both(_keyspaces, tmp_path,
                                            seed_root=seeded_root))
    assert gens[0] == gens[1]  # same generation number
    assert cached == [True, True]
    assert hits == first and first[0] != first[1]


def _evict_drops_keyspace(p, root):
    docs, entities = _docs()
    pool = _pool(p, root, max_resident=8)
    rt = _runtime(p, pool, max_batch=4, flush_deadline=0.0,
                  result_cache_size=64)
    q = entities[0]
    with rt:
        with rt.tenant_writer("a") as kb:
            _fill(kb, docs, "a")
        rt.publish(tenant="a", durable=True)
        rt.submit(q, k=3, tenant="a").result(timeout=30)
        cached = rt.submit(q, k=3, tenant="a").result(timeout=30).cached
        before = len(rt.cache)
        pool.evict("a")
        after = len(rt.cache)
        res = rt.submit(q, k=3, tenant="a").result(timeout=30)
    return cached, before > 0, after, res.cached, _rows([res.results])


def test_eviction_drops_cache_keyspace(tmp_path):
    cached, had_entries, after, recached, rows = _same(
        _both(_evict_drops_keyspace, tmp_path))
    assert cached and had_entries
    assert after == 0  # keyspace dropped with the mount
    assert not recached and rows[0]  # remount serves fresh, no stale hit


def _empty_tenant(p, root):
    pool = _pool(p, root)
    rt = _runtime(p, pool, max_batch=4, flush_deadline=0.0)
    with rt:
        res = rt.submit("anything at all", k=5, tenant="fresh")\
            .result(timeout=30)
    return res.results, res.generation


def test_empty_tenant_serves_empty_results(tmp_path):
    assert _same(_both(_empty_tenant, tmp_path)) == ([], 0)


class _Poisoned:
    """Snapshot stand-in whose query_batch raises (failure-isolation
    fixture)."""

    def __init__(self, real):
        self.generation = real.generation

    def query_batch(self, texts, k):
        raise RuntimeError("poisoned tenant")


def _failure_isolated(p, root):
    _, entities = _docs()
    pool = _pool(p, root)
    rt = _runtime(p, pool, max_batch=8, flush_deadline=0.05,
                  result_cache_size=0)
    with rt:
        mt_a = pool.pin("a")
        mt_a.snapshots._current = _Poisoned(mt_a.snapshots.current)
        pool.unpin("a")
        fa = rt.submit(entities[0], k=2, tenant="a")
        fb = rt.submit(entities[0], k=2, tenant="b")
        with pytest.raises(RuntimeError, match="poisoned"):
            fa.result(timeout=30)
        rows = _rows([fb.result(timeout=30).results])
        failed = rt.metrics.snapshot()["failed"]
    return rows, failed


def test_flush_failure_isolated_to_one_tenant_group(tmp_path, seeded_root):
    """A scoring failure in tenant A's group fails A's futures only;
    tenant B's request in the same flush still resolves."""
    rows, failed = _same(_both(_failure_isolated, tmp_path,
                               seed_root=seeded_root))
    assert rows[0] and failed == 1


# --------------------------------------------------------------------------
# single-tenant parity: the pool path is bit-identical to the classic one
# --------------------------------------------------------------------------

def _single_tenant(p, root):
    docs, entities = _docs(n=20)
    queries = [*entities, "quarterly forecast", "unrelated text"]
    kb_classic = p.KB(dim=DIM)
    _fill(kb_classic, docs, "t")
    classic = p.Runtime(kb_classic, max_batch=8, flush_deadline=0.0,
                        result_cache_size=0, **p.engine_kw)
    pool = _pool(p, root)
    pooled = _runtime(p, pool, max_batch=8, flush_deadline=0.0,
                      result_cache_size=0)
    engine = p.Engine(kb_classic, **p.engine_kw)
    out = []
    with classic, pooled:
        with pooled.tenant_writer(p.t.DEFAULT_TENANT) as kb:
            _fill(kb, docs, "t")
        pooled.publish()  # the default tenant wraps today's behavior
        for q in queries:
            want = _rows(engine.query_batch([q], k=3))
            got_classic = classic.submit(q, k=3).result(timeout=60)
            got_pooled = pooled.submit(q, k=3).result(timeout=60)
            out.append((want, _rows([got_classic.results]),
                        _rows([got_pooled.results]),
                        got_classic.generation == got_pooled.generation))
    return out


def test_single_tenant_path_bit_identical_through_pool(tmp_path):
    for want, classic, pooled, same_gen in _same(
            _both(_single_tenant, tmp_path)):
        assert classic == want == pooled and same_gen


def test_single_engine_and_pool_modes_are_exclusive(tmp_path):
    for name, p in PKGS.items():
        pool = _pool(p, tmp_path / name)
        kb = p.KB(dim=DIM)
        with pytest.raises(ValueError, match="exclusive"):
            p.Runtime(kb, pool=pool)
        with pytest.raises(ValueError, match="exclusive"):
            p.Runtime(pool=pool, container_path=str(tmp_path / "x.ragdb"))
        rt = _runtime(p, pool)
        for attr in ("engine", "generation"):
            with pytest.raises(RuntimeError, match="multi-tenant"):
                getattr(rt, attr)
        single = p.Runtime(kb, **p.engine_kw)
        with pytest.raises(ValueError, match="multi-tenant"):
            single.publish(tenant="a")
        with pytest.raises(RuntimeError, match="multi-tenant"):
            single.pool_stats()
        with pytest.raises(RuntimeError, match="multi-tenant"):
            with single.tenant_writer("a"):
                pass
        assert single.tenant_metrics() == {}


# --------------------------------------------------------------------------
# sanitizers: arm_sanitizers warms each named tenant's buckets
# --------------------------------------------------------------------------

def _warm(p, root, monkeypatch):
    """The batch sizes each tenant's snapshot scored while the runtime
    armed its sanitizers, then the serving that followed."""
    _, entities = _docs()
    seen = []
    real = p.Snapshot.query_batch

    def spy(snap, texts, k=5, **kw):
        seen.append((snap.doc_ids[0].split("_")[0], len(texts)))
        return real(snap, texts, k, **kw)

    monkeypatch.setattr(p.Snapshot, "query_batch", spy)
    pool = _pool(p, root, max_resident=8)
    rt = _runtime(p, pool, max_batch=4, flush_deadline=0.0,
                  result_cache_size=0)
    with rt:
        rt.arm_sanitizers(k=3, tenants=["a", "b"])
        armed = rt.retrace_guard.armed
        warmed = list(seen)
        for t in ("a", "b"):
            rt.submit(entities[0], k=3, tenant=t).result(timeout=30)
        pool.evict("a")
        rt.submit(entities[0], k=3, tenant="a").result(timeout=30)
    monkeypatch.undo()
    return armed, warmed, seen[len(warmed):]


def test_multi_tenant_arm_sanitizers_warms_each_tenant(tmp_path, seeded_root,
                                                       monkeypatch):
    """Each named tenant is mounted (cold ones included) and scored at
    every power-of-two bucket up to max_batch; serving, and an evict +
    remount, follow.  The port's retrace guard is a no-op under eager
    PyTorch, so arming is the observable half of the contract."""
    armed, warmed, served = _same(_both(_warm, tmp_path, monkeypatch,
                                        seed_root=seeded_root))
    assert armed
    assert warmed == [(t, b) for t in ("a", "b") for b in (1, 2, 4)]
    assert served == [("a", 1), ("b", 1), ("a", 1)]


# --------------------------------------------------------------------------
# concurrency: hot serving against one tenant while others mount/evict
# --------------------------------------------------------------------------

def test_concurrent_serving_while_tenants_churn(tmp_path):
    docs, entities = _docs(n=16)
    pool = _pool(PKGS["port"], tmp_path, max_resident=2)
    rt = _runtime(PKGS["port"], pool, max_batch=8, flush_deadline=0.001,
                  result_cache_size=0)
    errors = []
    with rt:
        with rt.tenant_writer("hot") as kb:
            _fill(kb, docs, "hot")
        rt.publish(tenant="hot", durable=True)

        def serve_hot():
            try:
                for i in range(40):
                    res = rt.submit(entities[i % len(entities)], k=2,
                                    tenant="hot").result(timeout=60)
                    assert res.results, "hot tenant lost its corpus"
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors.append(exc)

        def churn():
            try:
                for i in range(6):
                    t = f"cold{i}"
                    with rt.tenant_writer(t) as kb:
                        _fill(kb, docs[:4], t)
                    rt.publish(tenant=t, durable=True)
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=serve_hot),
                   threading.Thread(target=churn)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        # even if churn evicted "hot" between its requests, durable
        # publish + lazy remount means the next request still serves it
        res = rt.submit(entities[0], k=2, tenant="hot").result(timeout=60)
        assert res.results
        assert pool.stats()["resident"] <= 2


# --------------------------------------------------------------------------
# crash matrix: durable publish triggered by tenant eviction
# --------------------------------------------------------------------------

def _pool_with_pending(p, root):
    """A mounted tenant with one durable generation on disk plus a
    pending (unpersisted) doc; returns (pool, container path)."""
    pool = _pool(p, root, scoring_path="map")
    with pool.pinned("t") as mt:
        for i in range(8):
            mt.kb.add_text(f"base{i}.txt", f"durable doc {i} CODE-{i}")
        mt.snapshots.publish(durable=True)
    with pool.pinned("t") as mt:
        mt.kb.add_text("pending.txt", "unpersisted tail INV-9999")
        mt.snapshots.publish(durable=False)  # in memory only
    return pool, pool.container_path("t")


def _crash_before_append(p, root, monkeypatch):
    """Window (a): die before any journal byte is written."""
    pool, path = _pool_with_pending(p, root)
    durable = _files(root)

    def die(*a, **kw):
        raise OSError("simulated crash before append")
    monkeypatch.setattr(p.ingest, "append_journal_record", die)
    with pytest.raises(OSError, match="before append"):
        pool.evict("t")
    monkeypatch.undo()
    out = p.KB.load(path)
    return _files(root) == durable, out.n_docs, "pending.txt" in out.records


def _crash_before_manifest(p, root, monkeypatch):
    """Window (b): die after the journal frames hit disk but before the
    manifest rename commits them; the next durable save reclaims them."""
    pool, path = _pool_with_pending(p, root)
    size_before = p.container.journal_size(path)

    def die(base_path, man):
        raise OSError("simulated crash before manifest rename")
    monkeypatch.setattr(p.container, "_publish_journal_manifest", die)
    with pytest.raises(OSError, match="manifest rename"):
        pool.evict("t")
    monkeypatch.undo()
    grew = os.path.getsize(p.container.journal_path(path)) > size_before
    man = p.container.read_journal_manifest(path)
    uncommitted = man is None or man["committed_bytes"] <= size_before
    out = p.KB.load(path)
    lost = "pending.txt" not in out.records
    out.add_text("pending.txt", "unpersisted tail INV-9999")
    out.save_delta(path, compact_ratio=None)
    man = p.container.read_journal_manifest(path)
    committed = man["committed_bytes"] == os.path.getsize(
        p.container.journal_path(path))
    return (grew, uncommitted, out.n_docs, lost, committed,
            "pending.txt" in p.KB.load(path).records, _files(root))


def _crash_after_commit(p, root):
    """Window (c): die after the manifest commit, before the pool drops
    its resident entry; disk already owns the generation."""
    pool, path = _pool_with_pending(p, root)

    def die(tenant):
        raise OSError("simulated crash after commit")
    pool.on_evict = die
    with pytest.raises(OSError, match="after commit"):
        pool.evict("t")
    out = p.KB.load(path)
    again = p.KB.load(path)
    stable = (sorted(out.records) == sorted(again.records)
              and out.loaded_generation == again.loaded_generation)
    return "pending.txt" in out.records, out.n_docs, stable, _files(root)


def test_evict_crash_before_journal_append_loses_only_pending(
        tmp_path, monkeypatch):
    unchanged, n_docs, pending = _same(
        _both(_crash_before_append, tmp_path, monkeypatch))
    # "reboot": the container replays to exactly the last durable state
    assert unchanged and n_docs == 8 and not pending


def test_evict_crash_between_append_and_manifest_rename(
        tmp_path, monkeypatch):
    grew, uncommitted, n_docs, lost, committed, recovered, _ = _same(
        _both(_crash_before_manifest, tmp_path, monkeypatch))
    # frames were appended but never committed, so the tail is invisible
    assert grew and uncommitted and lost
    # recovery: the next durable save truncates the orphan bytes and
    # commits the pending generation cleanly
    assert n_docs == 9 and committed and recovered


def test_evict_crash_after_commit_is_equivalent_to_clean_evict(tmp_path):
    pending, n_docs, stable, _ = _same(
        _both(_crash_after_commit, tmp_path))
    assert pending and n_docs == 9 and stable


# --------------------------------------------------------------------------
# the port's ledger counts each storage once
# --------------------------------------------------------------------------

def _storages_bytes(engine) -> int:
    """Bytes of the distinct storages an engine holds for scoring."""
    tensors = [engine.doc_vecs, engine.doc_sigs]
    if engine._kernel_cache:
        tensors += list(engine._kernel_cache[2:])
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    return sum(storages.values())


def test_ledger_counts_kernel_operands_once_on_the_kernel_path():
    docs, _ = _docs(n=100)
    kb = PortKB(dim=256)
    _fill(kb, docs, "k")
    rt = PortRuntime(kb, device="cpu", scoring_path="kernel")
    engine = rt.engine
    assert engine._kernel_cache is not None
    planes = rt.resources()["tenants"]["default"]["planes"]
    assert planes["kernel_operands"] == 0
    assert planes["doc_matrix"] == 100 * 256 * 4 + 100 * kb.sig_words * 4
    assert rt.resources()["device_bytes"] == _storages_bytes(engine)
    # an operand with storage of its own is still counted
    engine._kernel_cache = engine._kernel_cache[:2] + (
        engine.doc_vecs.clone(), engine.doc_sigs)
    planes = port_ledger.measure_engine_planes(engine)
    assert planes["kernel_operands"] == engine.doc_vecs.nbytes


def test_byte_budget_of_two_tenants_keeps_two_resident(tmp_path):
    docs, entities = _docs()
    pool = _pool(PKGS["port"], tmp_path, scoring_path="kernel",
                 max_resident=64)
    for t in ("a", "b", "c", "d"):
        _seed_tenant(pool, t, docs)
    one = pool.ledger.tenant_bytes("d", planes=port_ledger.DEVICE_PLANES)
    with pool.pinned("d") as mt:
        assert one == _storages_bytes(mt.snapshots.engine) > 0
    pool.max_resident_bytes = 2 * one + one // 2
    pool.evict_over_budget()
    rt = _runtime(PKGS["port"], pool, max_batch=4, flush_deadline=0.0,
                  result_cache_size=0)
    with rt:
        for i in range(8):
            t = "abcd"[i % 4]
            assert rt.submit(entities[0], k=2, tenant=t)\
                .result(timeout=30).results
            assert len(pool.resident_tenants()) == 2
            assert pool.resident_bytes() == \
                rt.resources()["device_bytes"] == 2 * one


def test_eviction_frees_the_tenants_tensors(tmp_path):
    """Nothing outlives an eviction: once the pool drops a mount (and
    the runtime its cache keyspace), the tenant's doc tensors are
    freed without a garbage collection."""
    import gc

    docs, entities = _docs()
    pool = _pool(PKGS["port"], tmp_path, scoring_path="kernel")
    rt = _runtime(PKGS["port"], pool, max_batch=4, flush_deadline=0.0)
    gc.disable()
    try:
        with rt:
            with rt.tenant_writer("a") as kb:
                _fill(kb, docs, "a")
            rt.publish(tenant="a")
            fut = rt.submit(entities[0], k=2, tenant="a", explain=True)
            assert fut.result(timeout=30).plan is not None
            with pool.pinned("a") as mt:
                refs = [weakref.ref(t) for t in (
                    mt.snapshots.engine.doc_vecs,
                    mt.snapshots.current.doc_sigs)]
                del mt
            pool.evict("a")  # publishes durably first: pending state
            assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
