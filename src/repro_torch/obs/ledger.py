"""Resource ledger: resident bytes per (tenant, generation, plane).

One accounting surface for everything a serving process holds
resident, broken down by *plane*:

- ``doc_matrix``     device doc vectors + signature matrix
- ``ivf_state``      clustered-index arrays (centroids, bounds,
                     assignments, members: host numpy, the same bytes
                     the JAX package counts for the same state)
- ``kernel_operands`` kernel-ready doc operands for the fused kernel
                     path, counted only where they hold storage of
                     their own (the port's kernel takes the doc
                     tensors as they are, so this plane is 0 unless
                     an operand is a real copy)
- ``result_cache``   per-generation result-cache entries (host)
- ``container``      the host-side KnowledgeBase (records, texts,
                     signatures) — an estimate, documented below
- ``journal_tail``   on-disk delta journal bytes (reported, but
                     excluded from *resident* sums — it is disk, not
                     memory)

The ledger is the **single source of truth for eviction**:
``ContainerPool`` budgets against ``tenant_bytes(..., DEVICE_PLANES)``
and ``ServingRuntime.resources()`` reports the same numbers, so budget
decisions and reported occupancy can never diverge.  Each ``update``
also sets ``ragdb_resident_bytes{tenant=,plane=}`` gauges in the bound
registry, and ``drop_tenant`` prunes them — bounded label cardinality
under tenant churn.

Byte numbers for device arrays are exact (``nbytes`` of the concrete
arrays); the host ``container`` plane is an estimate (text + record
overhead), clearly a lower bound, since Python object graphs have no
exact cheap size.  Pure stdlib + numpy-duck-typing: measurement
helpers import the heavier planes lazily so this module stays
importable from anywhere.
"""
from __future__ import annotations

import dataclasses
import threading

# planes that occupy accelerator/host *memory* for scoring — what the
# pool's resident budget constrains
DEVICE_PLANES = ("doc_matrix", "ivf_state", "kernel_operands")
# memory-resident planes (everything but the on-disk journal tail)
RESIDENT_PLANES = DEVICE_PLANES + ("result_cache", "container")
ALL_PLANES = RESIDENT_PLANES + ("journal_tail",)


class ResourceLedger:
    """Thread-safe (tenant → plane → bytes) accounting + gauges."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._tenants: dict[str, dict] = {}
        self._registry = registry

    # ---- writes ---------------------------------------------------------

    def update(self, tenant: str, planes: dict, *,
               generation=None) -> None:
        """Replace ``tenant``'s accounting for the given planes (other
        planes it already has are kept — the result-cache plane is
        refreshed on a different cadence than the publish planes)."""
        with self._lock:
            ent = self._tenants.setdefault(
                tenant, {"generation": None, "planes": {}})
            if generation is not None:
                ent["generation"] = generation
            for plane, nbytes in planes.items():
                ent["planes"][plane] = int(nbytes)
        if self._registry is not None:
            for plane, nbytes in planes.items():
                self._registry.gauge(
                    "ragdb_resident_bytes",
                    "ledger-accounted resident bytes per plane",
                    tenant=tenant, plane=plane,
                ).set(int(nbytes))

    def set_plane(self, tenant: str, plane: str, nbytes: int) -> None:
        self.update(tenant, {plane: nbytes})

    def drop_tenant(self, tenant: str) -> None:
        """Forget a tenant (evict/unmount) and prune its gauge series."""
        with self._lock:
            self._tenants.pop(tenant, None)
        if self._registry is not None:
            self._registry.prune("ragdb_resident_bytes", tenant=tenant)

    # ---- reads ----------------------------------------------------------

    def tenant_bytes(self, tenant: str,
                     planes=RESIDENT_PLANES) -> int:
        with self._lock:
            ent = self._tenants.get(tenant)
            if ent is None:
                return 0
            return sum(ent["planes"].get(p, 0) for p in planes)

    def total_bytes(self, planes=RESIDENT_PLANES) -> int:
        with self._lock:
            return sum(
                sum(ent["planes"].get(p, 0) for p in planes)
                for ent in self._tenants.values()
            )

    def snapshot(self) -> dict:
        """Full accounting: {tenant: {generation, planes, resident_bytes,
        device_bytes}} plus totals — what ``ServingRuntime.resources()``
        returns."""
        with self._lock:
            tenants = {
                t: {
                    "generation": ent["generation"],
                    "planes": dict(ent["planes"]),
                    "resident_bytes": sum(
                        ent["planes"].get(p, 0) for p in RESIDENT_PLANES),
                    "device_bytes": sum(
                        ent["planes"].get(p, 0) for p in DEVICE_PLANES),
                }
                for t, ent in self._tenants.items()
            }
        return {
            "tenants": tenants,
            "resident_bytes": sum(
                e["resident_bytes"] for e in tenants.values()),
            "device_bytes": sum(
                e["device_bytes"] for e in tenants.values()),
        }


# --------------------------------------------------------------------------
# plane measurement (called at mount/publish — never on the query path)
# --------------------------------------------------------------------------

def _nbytes(obj) -> int:
    """Total ``nbytes`` of the array leaves hanging off ``obj``:
    arrays count directly; tuples/lists and (nested, one generation of)
    dataclasses are walked.  Non-array leaves count 0."""
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(
            _nbytes(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        )
    return 0


def _storage(t) -> int:
    """Address of the storage behind a tensor: two tensors with the same
    address share their bytes."""
    return t.untyped_storage().data_ptr()


def measure_engine_planes(engine) -> dict:
    """Byte accounting of one engine's resident planes (exact for the
    device arrays, estimated for the host container).  Each storage is
    counted once: a kernel operand that is the doc matrix itself (or a
    view of it) adds nothing to ``kernel_operands``."""
    doc = (engine.doc_vecs, engine.doc_sigs)
    planes = {
        "doc_matrix": sum(_nbytes(t) for t in doc),
        "ivf_state": _nbytes(engine.ivf) if engine.ivf is not None else 0,
    }
    cache = getattr(engine, "_kernel_cache", None)
    counted = {_storage(t) for t in doc}
    planes["kernel_operands"] = sum(
        _nbytes(t) for t in (cache[2:] if cache else ())
        if _storage(t) not in counted)
    kb = engine.kb
    # host container estimate: per-doc signatures are exact; text +
    # per-record metadata (id, sha, term counts) approximated at
    # 256 B/record
    est = sum(_nbytes(s) for s in getattr(kb, "signatures", {}).values())
    est += sum(len(t) for t in getattr(kb, "texts", {}).values())
    est += 256 * len(getattr(kb, "records", {}))
    planes["container"] = est
    return planes


def measure_journal(base_path: str) -> int:
    """On-disk delta-journal tail bytes for a container path."""
    # lazy: core.container imports obs.trace — importing it at module
    # top would cycle obs.ledger back into core
    from repro_torch.core.container import journal_size
    try:
        return journal_size(base_path)
    except OSError:
        return 0
