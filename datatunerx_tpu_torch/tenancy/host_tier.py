"""HostAdapterTier: bounded host-RAM LRU of adapter weights (the port's own
copy of ``datatunerx_tpu/tenancy/host_tier.py``).

The adapter pool holds N adapters on the device; every other adapter is a
checkpoint read away, paid again each time the LRU churns. This tier keeps
EVICTED adapters' host tensors (the layers and scaling the registry's
loader produced, on the CPU) in a byte-budgeted LRU, so evict→reload is a
host→device insert with no checkpoint read. The registry counts
``host_hits`` apart from ``orbax_loads`` (the reference's name for loads
that read the checkpoint), so the split is observable and testable.

Entries are keyed (adapter name, checkpoint path): re-registering a name
at a different checkpoint can never serve the stale weights.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple


def _entry_bytes(layers) -> int:
    """Host-side footprint of one adapter's layer tree: the registry
    loader's ``{target: {"a": tensor, "b": tensor}}`` shape, walked
    generically so list/tuple-shaped stacks size correctly too."""
    if isinstance(layers, dict):
        return sum(_entry_bytes(v) for v in layers.values())
    if isinstance(layers, (list, tuple)):
        return sum(_entry_bytes(v) for v in layers)
    return int(getattr(layers, "nbytes", 0) or 0)


class HostAdapterTier:
    """Thread-safe LRU of (layers, scaling) keyed (name, checkpoint),
    bounded by ``max_bytes``. Oversized singles are refused rather than
    thrashing the whole tier out."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._d: "OrderedDict[Tuple[str, str], dict]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0

    def get(self, name: str, checkpoint: str) -> Optional[tuple]:
        """→ (layers, scaling) and refresh recency, or None."""
        key = (name, checkpoint)
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return ent["layers"], ent["scaling"]

    def put(self, name: str, checkpoint: str, layers, scaling) -> bool:
        """Insert (refreshing an existing key), evicting coldest-first to
        fit. Returns False when the entry alone exceeds the budget."""
        nbytes = _entry_bytes(layers)
        if nbytes <= 0 or nbytes > self.max_bytes:
            return False
        key = (name, checkpoint)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old["bytes"]
            while self._d and self._bytes + nbytes > self.max_bytes:
                _, cold = self._d.popitem(last=False)
                self._bytes -= cold["bytes"]
                self.evictions += 1
            self._d[key] = {"layers": layers, "scaling": scaling,
                            "bytes": nbytes}
            self._bytes += nbytes
            self.puts += 1
            return True

    def drop(self, name: str) -> int:
        """Forget every checkpoint cached under ``name`` (the registry's
        unregister path) — a deleted adapter must not resurrect."""
        with self._lock:
            doomed = [k for k in self._d if k[0] == name]
            for k in doomed:
                self._bytes -= self._d.pop(k)["bytes"]
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._d), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses, "puts": self.puts,
                    "evictions": self.evictions}
