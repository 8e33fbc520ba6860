"""TenantRouter: per-request tenant id → mounted engine stack.

The router is the thin policy layer between the scheduler and the
``ContainerPool``: it admits (or rejects) the request against the
tenant's token-bucket quota, resolves the tenant to a *pinned* mount
for the duration of a flush or writer session, and exposes the writer
entry points (``writer()`` / ``publish()``) so drivers never touch the
pool's pin protocol by hand.

Admission happens *before* pinning: a quota-rejected request never
mounts a cold container, so an abusive tenant cannot use rejected
traffic to thrash the pool's LRU.
"""
from __future__ import annotations

import contextlib

from repro_torch.serving.cache import DEFAULT_KEYSPACE
from repro_torch.tenancy.pool import ContainerPool, MountedTenant, validate_tenant
from repro_torch.tenancy.quota import TenantQuotas

# the tenant the single-tenant serving path maps onto: the result
# cache's DEFAULT_KEYSPACE (== the scheduler's DEFAULT_TENANT), so cache
# semantics line up across modes
DEFAULT_TENANT = DEFAULT_KEYSPACE


class TenantRouter:
    """Quota gate + pin-scoped tenant resolution over a ContainerPool."""

    def __init__(self, pool: ContainerPool,
                 quotas: TenantQuotas | None = None):
        self.pool = pool
        self.quotas = quotas

    # ---- admission (scheduler submit path) -------------------------------

    def admit(self, tenant: str) -> bool:
        """Spend one quota token; True = admitted.  Unlimited when no
        quota table (or no bucket for this tenant) is configured."""
        if self.quotas is None:
            return True
        return self.quotas.try_acquire(tenant)

    def peek_generation(self, tenant: str) -> int | None:
        """Resident tenant's generation without mounting (cache probe);
        None when the tenant is cold."""
        return self.pool.peek_generation(tenant)

    # ---- pin protocol (scheduler flush path) -----------------------------

    def pin(self, tenant: str) -> MountedTenant:
        return self.pool.pin(tenant)

    def unpin(self, tenant: str) -> None:
        self.pool.unpin(tenant)

    # ---- writer plane ----------------------------------------------------

    @contextlib.contextmanager
    def writer(self, tenant: str):
        """Pin tenant for a writer session and yield the mount; the
        caller mutates ``mt.kb`` (single-writer contract) and then
        publishes.  The pin keeps eviction structurally impossible
        while the session holds references into the live stack."""
        mt = self.pool.pin(tenant)
        try:
            yield mt
        finally:
            self.pool.unpin(tenant)

    def publish(self, tenant: str, durable: bool = False) -> int:
        """Refresh + publish tenant's next generation (writer thread
        only); returns the published generation."""
        with self.writer(tenant) as mt:
            return mt.snapshots.publish(durable=durable).generation

    # ---- convenience -----------------------------------------------------

    def tenants(self) -> list[str]:
        return self.pool.resident_tenants()

    @staticmethod
    def validate(tenant: str) -> str:
        return validate_tenant(tenant)
