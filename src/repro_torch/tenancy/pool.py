"""ContainerPool: lazily mounted, LRU-evicted per-tenant engine stacks.

The paper's single-file knowledge container implies *many* containers
in production — one per user/workspace — on hosts that cannot keep
them all resident (EdgeRAG, arXiv 2412.21023: lazy-load what the
request needs, evict what it doesn't).  The pool is that discipline
for this stack:

- **Lazy mount.**  The first request for tenant *t* opens
  ``<root>/<t>.ragdb`` (the delta-journal load replays base + journal,
  O(container)) — or creates a fresh empty KB when the container does
  not exist yet — and wraps it in the standard ``SnapshotManager``
  stack, whose engine uploads the tenant's doc tensors to the engine
  kwargs' ``device`` (the card unless the caller passes
  ``device="cpu"``).  Subsequent requests reuse the mount.

- **Refcount pins.**  Every consumer (a scheduler flush serving the
  tenant, a writer session mutating it) holds a *pin* on the mount for
  the duration.  Pins are the teardown barrier: eviction of a mount
  with ``pins > 0`` is structurally refused, so an in-flight flush can
  never have its snapshot stack torn down underneath it.  ``_resident``
  is mutated only inside the pool under its guard, and every evict
  path carries the ``pins == 0`` check.

- **LRU eviction under budget.**  ``max_resident`` (mount count) and
  ``max_resident_bytes`` (the ledger's device bytes) bound the pool;
  crossing either evicts cold tenants in LRU order, skipping pinned
  mounts.  **Eviction durably publishes first**: any state the
  persistence chain does not yet hold (``kb.unpersisted_changes``) is
  flushed through ``SnapshotManager.publish(durable=True)`` — the
  journal append + fsync + manifest rename protocol — *before* the
  mount is dropped, so eviction can never lose a generation a reader
  has seen.  The durable publish itself runs under the KB's
  single-writer lock (save_delta takes it).  Dropping the mount drops
  the pool's last reference to the engine and its snapshot, which frees
  the tenant's device tensors (the runtime's eviction hook drops the
  tenant's result-cache keyspace with it).

Locking: one pool-wide guard (``_pool_guard``) covers the resident map
and all pin/evict transitions; it is held across a mount (cold-start
latency — host load and the upload to the device — is charged to the
requesting tenant, by design) but never across query scoring — flushes
hold only the *pin*, not the lock.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch.core.ingest import KnowledgeBase
from repro_torch.obs import ledger as ledger_mod, trace as obs_trace
from repro_torch.obs.ledger import ResourceLedger
from repro_torch.obs.metrics import MetricsRegistry, global_registry
from repro_torch.serving.snapshot import SnapshotManager

_TENANT_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


def validate_tenant(tenant: str) -> str:
    """Tenant ids name container files — keep them filesystem-safe."""
    if not isinstance(tenant, str) or not _TENANT_RE.fullmatch(tenant):
        raise ValueError(
            f"invalid tenant id {tenant!r}: want [A-Za-z0-9][A-Za-z0-9._-]*"
            " (max 64 chars)"
        )
    return tenant


@dataclass
class MountedTenant:
    """One resident tenant stack: KB + snapshot manager + pin count."""

    tenant: str
    path: str
    kb: KnowledgeBase
    snapshots: SnapshotManager
    pins: int = 0
    mounted_at: float = field(default_factory=time.perf_counter)
    last_used: float = field(default_factory=time.perf_counter)
    ledger: ResourceLedger | None = None

    @property
    def generation(self) -> int:
        return self.snapshots.generation

    @property
    def resident_bytes(self) -> int:
        """Device footprint per the resource ledger (doc matrix + IVF
        state + kernel operands with storage of their own, re-measured
        at mount and every publish) — the *same* accounting
        ``ServingRuntime.resources()`` reports, so budget decisions and
        reported occupancy can never diverge.  Falls back to the doc
        tensors' bytes when no ledger is attached (standalone
        SnapshotManager in tests)."""
        if self.ledger is not None:
            return self.ledger.tenant_bytes(
                self.tenant, planes=ledger_mod.DEVICE_PLANES)
        eng = self.snapshots.engine
        total = 0
        for arr in (getattr(eng, "doc_vecs", None),
                    getattr(eng, "doc_sigs", None)):
            total += int(getattr(arr, "nbytes", 0) or 0)
        return total


class ContainerPool:
    """See module docstring.  Thread-safe; all mutation of the resident
    map happens under ``_pool_guard`` inside this class."""

    def __init__(
        self,
        root: str,
        *,
        max_resident: int = 8,
        max_resident_bytes: int | None = None,
        kb_kwargs: dict | None = None,
        compact_ratio: float | None = KnowledgeBase.DEFAULT_COMPACT_RATIO,
        registry: MetricsRegistry | None = None,
        **engine_kwargs,
    ):
        if max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_resident = max_resident
        self.max_resident_bytes = max_resident_bytes
        self.kb_kwargs = dict(kb_kwargs or {})
        self.compact_ratio = compact_ratio
        # QueryEngine kwargs of every mount (device=, scoring_path=, ...)
        self.engine_kwargs = engine_kwargs
        # unmount hook (set by ServingRuntime): drops the tenant's
        # result-cache keyspace when its stack leaves memory
        self.on_evict = None
        self._registry = registry if registry is not None else global_registry()
        # the resource ledger (obs/ledger.py): every mount's
        # SnapshotManager measures its planes into it at mount/publish,
        # and budget eviction consumes its device-plane bytes
        self.ledger = ResourceLedger(registry=self._registry)
        self._lock = threading.RLock()
        # LRU order: oldest-used first; values are MountedTenant
        self._resident: OrderedDict[str, MountedTenant] = OrderedDict()
        self._mount_hist = self._registry.histogram(
            "ragdb_tenant_mount_seconds",
            "container mount latency (load + snapshot capture)")
        self._evict_hist = self._registry.histogram(
            "ragdb_tenant_evict_seconds",
            "eviction latency (durable publish + unmount)")
        self._resident_gauge = self._registry.gauge(
            "ragdb_tenant_resident", "mounted tenant stacks")
        self._resident_bytes_gauge = self._registry.gauge(
            "ragdb_tenant_resident_bytes",
            "estimated device bytes across resident tenants")

    # ---- the pool guard --------------------------------------------------

    @contextlib.contextmanager
    def _pool_guard(self, op: str):
        """All ``_resident`` transitions (mount/pin/unpin/evict) run
        under this one lock; scoring never does (flushes hold pins)."""
        with self._lock:
            yield

    # ---- paths -----------------------------------------------------------

    def container_path(self, tenant: str) -> str:
        return os.path.join(self.root, f"{validate_tenant(tenant)}.ragdb")

    # ---- pin / unpin (the only public mount entry points) ----------------

    def pin(self, tenant: str) -> MountedTenant:
        """Mount (if cold) and pin tenant's stack; the caller must
        ``unpin`` when done.  Pinning bumps LRU recency and may evict
        *other* cold tenants to stay under budget."""
        tenant = validate_tenant(tenant)
        with self._pool_guard("pin"):
            mt = self._resident.get(tenant)
            if mt is None:
                mt = self._mount_locked(tenant)
            mt.pins += 1
            mt.last_used = time.perf_counter()
            self._resident.move_to_end(tenant)  # MRU
            self._evict_over_budget_locked()
            return mt

    def unpin(self, tenant: str) -> None:
        with self._pool_guard("unpin"):
            mt = self._resident.get(tenant)
            if mt is None or mt.pins <= 0:
                raise RuntimeError(
                    f"unpin({tenant!r}) without a matching pin")
            mt.pins -= 1

    @contextlib.contextmanager
    def pinned(self, tenant: str):
        """``with pool.pinned(t) as mt:`` — pin for the block."""
        mt = self.pin(tenant)
        try:
            yield mt
        finally:
            self.unpin(tenant)

    # ---- mounting --------------------------------------------------------

    def _mount_locked(self, tenant: str) -> MountedTenant:
        path = self.container_path(tenant)
        t0 = time.perf_counter()
        with obs_trace.span("tenant_mount", tenant=tenant):
            if os.path.exists(path):
                kb = KnowledgeBase.load(path)
            else:
                kb = KnowledgeBase(**self.kb_kwargs)
            snaps = SnapshotManager(
                kb, container_path=path, compact_ratio=self.compact_ratio,
                tenant=tenant, ledger=self.ledger, **self.engine_kwargs,
            )
        mt = MountedTenant(tenant=tenant, path=path, kb=kb,
                           snapshots=snaps, ledger=self.ledger)
        self._resident[tenant] = mt
        dt = time.perf_counter() - t0
        self._mount_hist.record(dt)
        self._registry.counter(
            "ragdb_tenant_mounts_total", "container mounts",
            tenant=tenant).inc()
        self._update_gauges_locked()
        return mt

    # ---- eviction --------------------------------------------------------

    def evict(self, tenant: str) -> None:
        """Explicitly unmount one tenant (tests/operators).  Refuses
        while pinned — eviction may never tear a pinned stack."""
        with self._pool_guard("evict"):
            mt = self._resident.get(tenant)
            if mt is None:
                return
            if mt.pins > 0:
                raise RuntimeError(
                    f"evict({tenant!r}) refused: {mt.pins} pins held "
                    "(in-flight flush or writer session)")
            self._evict_locked(mt)

    def evict_over_budget(self) -> None:
        with self._pool_guard("evict_over_budget"):
            self._evict_over_budget_locked()

    def _evict_over_budget_locked(self) -> None:
        while self._over_budget_locked():
            victim = None
            for mt in self._resident.values():  # LRU order, oldest first
                if mt.pins == 0:
                    victim = mt
                    break
            if victim is None:
                return  # everything pinned: budget temporarily exceeded
            self._evict_locked(victim)

    def _over_budget_locked(self) -> bool:
        if len(self._resident) > self.max_resident:
            return True
        return (self.max_resident_bytes is not None
                and self.resident_bytes() > self.max_resident_bytes)

    def _evict_locked(self, mt: MountedTenant) -> None:
        # the teardown barrier: a pinned mount is serving an in-flight
        # flush (or writer session) right now — structurally unevictable
        assert mt.pins == 0, f"evicting pinned tenant {mt.tenant!r}"
        t0 = time.perf_counter()
        with obs_trace.span("tenant_evict", tenant=mt.tenant,
                            generation=mt.generation):
            if mt.kb.unpersisted_changes:
                # durability-before-teardown: publish every pending
                # generation through the journal protocol (fsync +
                # manifest rename) so the unmount can never lose state
                # a reader has seen.  save_delta takes the KB's
                # single-writer lock — pins==0 means no writer session
                # can be mid-mutation, so this never contends.
                mt.snapshots.publish(durable=True)
            self._resident.pop(mt.tenant)
        dt = time.perf_counter() - t0
        self._evict_hist.record(dt)
        # aggregate (unlabeled) eviction counter: a per-tenant labeled
        # series would be pruned right below, and under zipf churn it
        # would grow label cardinality without bound anyway
        self._registry.counter(
            "ragdb_tenant_evictions_total", "container evictions").inc()
        # series hygiene: the evicted tenant's accounting leaves memory
        # with its stack — the ledger drops its resident-bytes series,
        # and every other tenant-labeled series (mounts, publish lag)
        # is pruned from both the pool registry and the global one so
        # gauges can never go stale across an evict/remount cycle
        self.ledger.drop_tenant(mt.tenant)
        self._registry.prune(tenant=mt.tenant)
        if self._registry is not global_registry():
            global_registry().prune(tenant=mt.tenant)
        self._update_gauges_locked()
        if self.on_evict is not None:
            self.on_evict(mt.tenant)

    # ---- introspection ---------------------------------------------------

    def resident_tenants(self) -> list[str]:
        with self._pool_guard("resident_tenants"):
            return list(self._resident)

    def is_resident(self, tenant: str) -> bool:
        with self._pool_guard("is_resident"):
            return tenant in self._resident

    def peek_generation(self, tenant: str) -> int | None:
        """Resident tenant's published generation without mounting or
        pinning (None when cold) — the scheduler's cache-probe hook."""
        with self._pool_guard("peek_generation"):
            mt = self._resident.get(tenant)
            return None if mt is None else mt.generation

    def resident_bytes(self) -> int:
        return sum(mt.resident_bytes for mt in self._resident.values())

    def _update_gauges_locked(self) -> None:
        self._resident_gauge.set(len(self._resident))
        self._resident_bytes_gauge.set(self.resident_bytes())

    def stats(self) -> dict:
        with self._pool_guard("stats"):
            return {
                "resident": len(self._resident),
                "max_resident": self.max_resident,
                "resident_bytes": self.resident_bytes(),
                "max_resident_bytes": self.max_resident_bytes,
                "pinned": sum(1 for m in self._resident.values()
                              if m.pins > 0),
                "tenants": list(self._resident),
            }

    def drain(self) -> None:
        """Evict every unpinned tenant (shutdown hook): durably publish
        pending state and empty the pool."""
        with self._pool_guard("drain"):
            for mt in [m for m in self._resident.values() if m.pins == 0]:
                self._evict_locked(mt)
