"""The tenancy plane (docs/ARCHITECTURE.md §13), in PyTorch: many
single-file knowledge containers multiplexed through one serving
runtime, each mounted tenant's doc tensors on the card (or on the CPU
when the pool's engine kwargs say ``device="cpu"``).

- ``ContainerPool`` (pool.py): lazy mounts, refcount pins, LRU
  eviction under a resident-tenant/byte budget with
  durability-before-teardown.
- ``TenantRouter`` (router.py): tenant id → pinned mount, plus the
  writer/publish entry points and quota admission.
- ``TokenBucket`` / ``TenantQuotas`` (quota.py): per-tenant admission
  control → ``RequestRejected(tenant)`` backpressure.

Single-tenant code never touches this package: ``ServingRuntime(kb)``
keeps the classic one-container path bit-identical, and
``DEFAULT_TENANT`` is the keyspace that path's cache entries live in.
"""
from repro_torch.tenancy.pool import ContainerPool, MountedTenant, validate_tenant
from repro_torch.tenancy.quota import TenantQuotas, TokenBucket
from repro_torch.tenancy.router import DEFAULT_TENANT, TenantRouter

__all__ = [
    "ContainerPool",
    "DEFAULT_TENANT",
    "MountedTenant",
    "TenantQuotas",
    "TenantRouter",
    "TokenBucket",
    "validate_tenant",
]
