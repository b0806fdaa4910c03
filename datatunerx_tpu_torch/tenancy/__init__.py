"""Multi-tenant QoS plane (the port of ``datatunerx_tpu/tenancy/``):
``TenantDirectory`` maps a tenant to a tier (pinned / standard / bulk), its
adapter set, a pool-share weight and a KV-block quota; ``HostAdapterTier``
is the bounded host-RAM LRU that turns evict→reload from a checkpoint read
into a host→device copy.

With no tenant config nothing here is constructed, and the engine schedules
exactly as without the plane.
"""

from datatunerx_tpu_torch.tenancy.directory import (
    TIERS,
    TenantDirectory,
    TenantSpec,
    load_tenants,
    tenant_entry_from_crd,
    validate_tenant_entry,
)
from datatunerx_tpu_torch.tenancy.host_tier import HostAdapterTier

__all__ = [
    "TIERS",
    "TenantDirectory",
    "TenantSpec",
    "HostAdapterTier",
    "load_tenants",
    "tenant_entry_from_crd",
    "validate_tenant_entry",
]
