"""Multi-tenant serving quickstart, in PyTorch: N isolated knowledge
containers behind one runtime (docs/ARCHITECTURE.md §13).

One ``ContainerPool`` owns every tenant's container under a single
root directory; the runtime routes each request to its tenant's
mounted engine+snapshot stack.  Mounts are lazy (first request pays a
delta-journal load), residency is LRU-bounded — here 3 tenants over a
budget of 2, so serving the third tenant evicts the coldest, durably
publishing its pending generations first — and a per-tenant token
bucket turns overload into ``RequestRejected(tenant)`` backpressure
instead of cross-tenant latency.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant [--device cpu]

Every mount's doc tensors live on the card unless ``--device cpu`` is
given.
"""
import tempfile

from repro_torch.data.corpus import make_corpus
from repro_torch.examples import device_arg
from repro_torch.serving import RequestRejected, ServingRuntime
from repro_torch.tenancy import ContainerPool, TenantQuotas

TENANTS = ("acme", "globex", "initech")


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    with tempfile.TemporaryDirectory() as root:
        pool = ContainerPool(root, kb_kwargs={"dim": 1024},
                             max_resident=2,          # LRU beyond 2
                             device=device)
        quotas = TenantQuotas()
        quotas.set("initech", rate=0.5, burst=2)      # throttled tenant

        runtime = ServingRuntime(pool=pool, quotas=quotas,
                                 max_batch=8, flush_deadline=0.002)
        with runtime:
            # each tenant gets its own corpus — and its own container
            # file, journal lineage, snapshot generations, result-cache
            # keyspace, and metric series
            codes = {}
            for seed, tenant in enumerate(TENANTS):
                docs, entities = make_corpus(n_docs=80, n_entities=4,
                                             seed=seed)
                with runtime.tenant_writer(tenant) as kb:
                    for i, d in enumerate(docs):
                        kb.add_text(f"{tenant}_{i:03d}.txt", d)
                gen = runtime.publish(tenant=tenant, durable=True)
                codes[tenant] = next(iter(entities))
                print(f"[{tenant}] published generation {gen} "
                      f"→ {pool.container_path(tenant)}")
            print(f"resident after ingest: {pool.resident_tenants()} "
                  f"(budget 2 — the coldest tenant was evicted, its "
                  f"state durably on disk)\n")

            # serve every tenant — the evicted one lazily remounts
            for tenant in TENANTS:
                res = runtime.submit(codes[tenant], k=2,
                                     tenant=tenant).result(timeout=60)
                top = res.results[0]
                print(f"[{tenant}] {codes[tenant]} → {top.doc_id} "
                      f"(score {top.score:.3f})")

            # overload the throttled tenant: the bucket admits the
            # burst, then rejects with the tenant attached
            rejected = 0
            for _ in range(6):
                try:
                    runtime.submit("flood query", k=2,
                                   tenant="initech").result(timeout=60)
                except RequestRejected as exc:
                    assert exc.tenant == "initech"
                    rejected += 1
            print(f"\n[initech] quota rejected {rejected}/6 flood "
                  f"requests (burst 2, rate 0.5/s)")

            for tenant, m in sorted(runtime.tenant_metrics().items()):
                print(f"  [{tenant}] completed={m['completed']} "
                      f"rejected={m['rejected']} "
                      f"p99={m['latency_p99_ms']:.2f}ms")
        pool.drain()  # durable publish + unmount everything


if __name__ == "__main__":
    main()
