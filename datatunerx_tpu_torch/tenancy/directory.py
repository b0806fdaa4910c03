"""TenantDirectory: tenant → tier / adapter set / pool share / KV quota
(the port's own copy of ``datatunerx_tpu/tenancy/directory.py``).

One config object feeds every plane: the gateway resolves a tenant per
request (``X-DTX-Tenant`` header first, adapter/model name second) and
prices admission against the tenant's share and block quota; the engine
tags requests so overcommit preemption is tier-aware; the adapter registry
pins the adapters of pinned-tier tenants against LRU eviction.

Config is a JSON object — a file path, an inline JSON string, or an
already-parsed dict — shaped::

    {"acme":  {"tier": "pinned",  "adapters": ["acme-chat"],
               "share": 4, "kv_block_quota": 0, "ttft_p95_ms": 250},
     "batch": {"tier": "bulk", "adapters": ["batch-sum"], "share": 1,
               "kv_block_quota": 16}}

Tier semantics:

  pinned   — adapters immune to pool LRU eviction; decode sessions are
             never preempted on behalf of a bulk tenant.
  standard — the default; rides the pool LRU and youngest-first
             preemption exactly like an un-tenanted request.
  bulk     — first in line for preemption and eviction; throughput
             traffic that paid for capacity, not latency.

``share`` is a smooth-WRR-style weight: when the admission token budget
is contended, tenant *i* may hold ``share_i / Σ shares`` of it.
``kv_block_quota`` caps the tenant's in-flight admission-priced KV blocks
(0 = uncapped). ``ttft_p95_ms`` is an optional per-tenant objective the
gateway's /autoscale burn branch reads.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

TIERS = ("pinned", "standard", "bulk")

# preemption priority per tier: LOWER ranks are preempted first. Bulk
# gives way to everyone, pinned to no one (on behalf of a bulk requester).
TIER_RANK = {"bulk": 0, "standard": 1, "pinned": 2}


def validate_tenant_entry(name: str, entry: dict) -> None:
    """Raise ValueError naming the field on any malformed tenant entry —
    the ONE validator shared by the directory loader and the operator
    admission webhook, so `kubectl apply` and `--tenants_config` reject
    identically."""
    if not name or not isinstance(name, str):
        raise ValueError("tenant name must be a non-empty string")
    if not isinstance(entry, dict):
        raise ValueError(f"tenant {name!r}: entry must be an object")
    tier = entry.get("tier", "standard")
    if tier not in TIERS:
        raise ValueError(
            f"tenant {name!r}: tier must be one of {'/'.join(TIERS)}, "
            f"got {tier!r}")
    adapters = entry.get("adapters", [])
    if not isinstance(adapters, list) or \
            not all(isinstance(a, str) and a for a in adapters):
        raise ValueError(
            f"tenant {name!r}: adapters must be a list of adapter names")
    share = entry.get("share", 1)
    try:
        share_f = float(share)
    except (TypeError, ValueError):
        raise ValueError(f"tenant {name!r}: share must be a number")
    if share_f <= 0:
        raise ValueError(f"tenant {name!r}: share must be > 0")
    for key in ("kv_block_quota", "ttft_p95_ms"):
        v = entry.get(key, 0)
        try:
            v_f = float(v)
        except (TypeError, ValueError):
            raise ValueError(f"tenant {name!r}: {key} must be a number")
        if v_f < 0:
            raise ValueError(f"tenant {name!r}: {key} must be >= 0")


_CRD_KEYS = {"kvBlockQuota": "kv_block_quota", "ttftP95Ms": "ttft_p95_ms"}


def tenant_entry_from_crd(entry: dict) -> dict:
    """Map a serveConfig.tenants entry's camelCase keys onto the
    directory's snake_case schema — the webhook and generate_serving_spec
    share this so `kubectl apply` and `--tenants_config` see one shape."""
    return {_CRD_KEYS.get(k, k): v for k, v in (entry or {}).items()}


class TenantSpec:
    """One tenant's policy row (immutable value object)."""

    __slots__ = ("name", "tier", "adapters", "share", "kv_block_quota",
                 "ttft_p95_ms")

    def __init__(self, name: str, tier: str = "standard",
                 adapters: Optional[List[str]] = None,
                 share: float = 1.0, kv_block_quota: int = 0,
                 ttft_p95_ms: float = 0.0):
        validate_tenant_entry(name, {
            "tier": tier, "adapters": list(adapters or []),
            "share": share, "kv_block_quota": kv_block_quota,
            "ttft_p95_ms": ttft_p95_ms})
        self.name = name
        self.tier = tier
        self.adapters = tuple(adapters or [])
        self.share = float(share)
        self.kv_block_quota = int(kv_block_quota)
        self.ttft_p95_ms = float(ttft_p95_ms)

    @classmethod
    def from_dict(cls, name: str, entry: dict) -> "TenantSpec":
        validate_tenant_entry(name, entry)
        return cls(name,
                   tier=entry.get("tier", "standard"),
                   adapters=list(entry.get("adapters") or []),
                   share=float(entry.get("share", 1)),
                   kv_block_quota=int(entry.get("kv_block_quota", 0) or 0),
                   ttft_p95_ms=float(entry.get("ttft_p95_ms", 0) or 0))

    def to_dict(self) -> dict:
        return {"tier": self.tier, "adapters": list(self.adapters),
                "share": self.share, "kv_block_quota": self.kv_block_quota,
                "ttft_p95_ms": self.ttft_p95_ms}


class TenantDirectory:
    """Thread-safe tenant registry with per-request resolution.

    Mutable at runtime (``POST /admin/tenants`` upserts a row), so every
    read snapshots under the lock; consumers that cache derived views
    (the registry's pinned-adapter set) re-pull after an upsert via the
    directory's generation counter.
    """

    def __init__(self, tenants: Optional[Dict[str, dict]] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantSpec] = {}
        self._generation = 0
        for name, entry in (tenants or {}).items():
            spec = (entry if isinstance(entry, TenantSpec)
                    else TenantSpec.from_dict(name, entry))
            self._tenants[name] = spec
        self._reindex_locked()

    # ------------------------------------------------------------- views
    def _reindex_locked(self):
        self._by_adapter = {}
        for spec in self._tenants.values():
            for a in spec.adapters:
                # first-writer wins on a contested adapter name — config
                # order is dict order, which JSON preserves
                self._by_adapter.setdefault(a, spec)
        self._generation += 1

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def get(self, name: str) -> Optional[TenantSpec]:
        with self._lock:
            return self._tenants.get(name)

    def resolve(self, tenant: str = "",
                adapter: str = "") -> Optional[TenantSpec]:
        """The tenant a request belongs to: an explicit tenant name (the
        ``X-DTX-Tenant`` header) wins; else the adapter/model name maps
        through the tenants' adapter sets; else None (anonymous — every
        plane treats None exactly like the pre-tenancy build)."""
        with self._lock:
            if tenant and tenant in self._tenants:
                return self._tenants[tenant]
            if adapter:
                return self._by_adapter.get(adapter)
            return None

    def tier_of_adapter(self, adapter: str) -> str:
        spec = self.resolve(adapter=adapter)
        return spec.tier if spec is not None else "standard"

    def pinned_adapters(self) -> set:
        """Adapters of pinned-tier tenants — the registry's LRU skips
        them as eviction victims."""
        with self._lock:
            return {a for s in self._tenants.values()
                    if s.tier == "pinned" for a in s.adapters}

    def shares(self) -> Dict[str, float]:
        with self._lock:
            return {n: s.share for n, s in self._tenants.items()}

    def to_dict(self) -> Dict[str, dict]:
        with self._lock:
            return {n: s.to_dict() for n, s in sorted(self._tenants.items())}

    # ----------------------------------------------------------- updates
    def upsert(self, name: str, entry: dict) -> TenantSpec:
        spec = TenantSpec.from_dict(name, entry)
        with self._lock:
            self._tenants[name] = spec
            self._reindex_locked()
        return spec

    def remove(self, name: str) -> bool:
        with self._lock:
            present = self._tenants.pop(name, None) is not None
            if present:
                self._reindex_locked()
            return present


def load_tenants(config: object) -> Optional[TenantDirectory]:
    """Build a directory from a file path, inline JSON text, or dict —
    the one loader behind ``--tenants_config`` on both servers and the
    serveConfig pass-through. Falsy input → None (tenancy plane off)."""
    if not config:
        return None
    if isinstance(config, TenantDirectory):
        return config
    obj = config
    if isinstance(config, str):
        text = config.strip()
        if not text.startswith("{"):
            with open(config, encoding="utf-8") as f:
                text = f.read()
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"tenants config is not valid JSON: {e}")
    if not isinstance(obj, dict):
        raise ValueError("tenants config must be a JSON object "
                         "{tenant: {tier, adapters, share, ...}}")
    # accept both the bare map and a {"tenants": {...}} envelope (the CRD
    # serveConfig uses the bare map; the envelope reads naturally in a
    # standalone file)
    if "tenants" in obj and isinstance(obj["tenants"], dict) \
            and all(isinstance(v, dict) for v in obj["tenants"].values()):
        obj = obj["tenants"]
    if not obj:
        return None
    return TenantDirectory(obj)
