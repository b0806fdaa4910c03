"""Dynamic multi-adapter plane: a pooled device adapter store and its host
registry (the port of ``datatunerx_tpu/adapters/``).

Adapters are data: the store owns a fixed-geometry pool the decode step
indexes per batch row, and the registry loads, evicts and refcounts
adapters at runtime. See ``serving/batched_engine.py`` (``adapter_pool``)
and the server's ``/admin/adapters``.
"""

from datatunerx_tpu_torch.adapters.registry import (
    AdapterPinnedError,
    AdapterRegistry,
)
from datatunerx_tpu_torch.adapters.store import (
    AdapterRankError,
    AdapterStore,
    AdapterTargetError,
    adapter_rank,
    hbm_bytes,
    validate_adapter,
)

__all__ = [
    "AdapterPinnedError",
    "AdapterRankError",
    "AdapterRegistry",
    "AdapterStore",
    "AdapterTargetError",
    "adapter_rank",
    "hbm_bytes",
    "validate_adapter",
]
