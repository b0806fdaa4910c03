"""Slice placement: concurrent jobs onto disjoint sets of cards (the port
of ``datatunerx_tpu/operator/placement.py``).

Concurrent FinetuneJobs map to DISJOINT slices and the controller owns
placement. Here a slice is a set of cards on one node (``chips`` counts
its cards; one trainer process drives one card). A ``SlicePool`` is the
operator's inventory of schedulable slices, read from the reference's
``TPU_SLICE_POOL`` env key (JSON), so one deployment's environment drives
either operator; the Finetune controller acquires one per job, stamps its
topology and node selector into the rendered workload, records the
assignment in Finetune.status.placement (so the pool rebuilds across
operator restarts), and releases it on terminal states.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional


class Slice:
    def __init__(self, name: str, topology: str = "2x4", chips: int = 8,
                 node_selector: Optional[dict] = None):
        self.name = name
        self.topology = topology
        self.chips = chips
        self.node_selector = dict(node_selector or {})

    def to_dict(self) -> dict:
        return {"name": self.name, "topology": self.topology,
                "chips": self.chips, "nodeSelector": self.node_selector}


def pool_from_env() -> Optional["SlicePool"]:
    """TPU_SLICE_POOL: JSON list of slices, e.g.
    ``[{"name":"a","topology":"1x1","chips":1,
        "nodeSelector":{"cloud.google.com/gke-nodepool":"h100-a"}}, …]``
    (``chips``: the slice's cards).
    Unset/empty → no pool (single-tenant behavior, no placement gating)."""
    raw = os.environ.get("TPU_SLICE_POOL", "").strip()
    if not raw:
        return None
    slices = [
        Slice(d["name"], d.get("topology", "2x4"), int(d.get("chips", 8)),
              d.get("nodeSelector"))
        for d in json.loads(raw)
    ]
    return SlicePool(slices)


class SlicePool:
    def __init__(self, slices: List[Slice]):
        if len({s.name for s in slices}) != len(slices):
            raise ValueError("slice names must be unique")
        self._slices: Dict[str, Slice] = {s.name: s for s in slices}
        self._held: Dict[str, str] = {}  # slice name -> job name
        self._lock = threading.Lock()

    # ------------------------------------------------------------- queries
    def slices(self) -> List[Slice]:
        return list(self._slices.values())

    def assignment(self, job: str) -> Optional[Slice]:
        with self._lock:
            for sname, holder in self._held.items():
                if holder == job:
                    return self._slices[sname]
        return None

    def free_count(self) -> int:
        with self._lock:
            return len(self._slices) - len(self._held)

    # ------------------------------------------------------------ lifecycle
    def acquire(self, job: str, min_chips: int = 0) -> Optional[Slice]:
        """Smallest free slice with ≥ min_chips; idempotent per job."""
        with self._lock:
            for sname, holder in self._held.items():
                if holder == job:
                    return self._slices[sname]
            candidates = sorted(
                (s for s in self._slices.values()
                 if s.name not in self._held and s.chips >= min_chips),
                key=lambda s: s.chips,
            )
            if not candidates:
                return None
            chosen = candidates[0]
            self._held[chosen.name] = job
            return chosen

    def release(self, job: str) -> None:
        with self._lock:
            for sname, holder in list(self._held.items()):
                if holder == job:
                    del self._held[sname]

    def reset(self) -> None:
        """Drop all assignments (before a full rebuild from CR statuses —
        merging into a stale snapshot can double-book a slice)."""
        with self._lock:
            self._held.clear()

    def restore(self, job: str, slice_name: str) -> None:
        """Rebuild an assignment recorded in Finetune.status.placement (used
        at operator startup so restarts don't double-book slices)."""
        with self._lock:
            if slice_name in self._slices:
                holder = self._held.get(slice_name)
                if holder is not None and holder != job:
                    raise ValueError(
                        f"slice {slice_name} recorded for both {holder} and {job}"
                    )
                self._held[slice_name] = job
