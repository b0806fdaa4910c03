"""Shared slice pool: one inventory of slices feeding N concurrent jobs (the
port's copy of ``datatunerx_tpu/experiment/pool.py``: a slice is a set of
cards, and ``chips`` counts them).

The operator's ``placement.SlicePool`` (PR r4) is a static inventory: a job
acquires a slice and keeps it until it terminates. An experiment wants the
opposite — N jobs *sharing* a pool that can grow and shrink while they run,
with the scheduler preempting and resuming jobs as capacity moves. This pool
is that elastic inventory:

- **gang-fit by mesh shape**: a job fits a slice iff the EXACT mesh the SPMD
  driver would build tiles the slice's cards — decided by
  ``operator/capacity.py::_mesh_shape_from``, the same parser/absorber the
  trainer uses, so admission here equals what the job would do on-slice;
- **elasticity**: ``add_slice``/``remove_slice`` reshape the pool live; a
  removal of a held slice reports the displaced job so the scheduler can
  preempt (checkpoint) and later resume it elsewhere.

Thread-safe like the operator pool: scheduler ticks, an admin shrink and a
metrics scrape may all touch it concurrently.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PoolSlice:
    """One schedulable slice of cards (or its fake/CPU stand-in); ``chips``
    keeps the reference's name and counts cards."""

    def __init__(self, name: str, chips: int = 8, topology: str = "2x4",
                 node_selector: Optional[dict] = None):
        self.name = name
        self.chips = int(chips)
        self.topology = topology
        self.node_selector = dict(node_selector or {})

    def to_dict(self) -> dict:
        return {"name": self.name, "chips": self.chips,
                "topology": self.topology,
                "nodeSelector": self.node_selector}


def mesh_fits(parameters: dict, n_chips: int) -> bool:
    """True iff the job's meshShape tiles ``n_chips`` — the trainer's own
    mesh builder is the oracle (capacity._mesh_shape_from raises the same
    ValueError the SPMD driver would raise on-slice)."""
    from datatunerx_tpu_torch.operator.capacity import _mesh_shape_from

    try:
        _mesh_shape_from(dict(parameters or {}), n_chips)
    except (ValueError, TypeError):
        return False
    return True


class SharedSlicePool:
    """Elastic slice inventory for one experiment."""

    def __init__(self, slices: Optional[List[PoolSlice]] = None):
        self._slices: Dict[str, PoolSlice] = {}
        self._held: Dict[str, str] = {}  # slice name -> job name
        self._lock = threading.Lock()
        for s in slices or []:
            self.add_slice(s)

    # ------------------------------------------------------------- queries
    def slices(self) -> List[PoolSlice]:
        with self._lock:
            return list(self._slices.values())

    def size(self) -> int:
        with self._lock:
            return len(self._slices)

    def free_count(self) -> int:
        with self._lock:
            return len(self._slices) - len(self._held)

    def held_count(self) -> int:
        with self._lock:
            return len(self._held)

    def holder_of(self, slice_name: str) -> Optional[str]:
        with self._lock:
            return self._held.get(slice_name)

    def assignment(self, job: str) -> Optional[PoolSlice]:
        with self._lock:
            for sname, holder in self._held.items():
                if holder == job:
                    return self._slices[sname]
        return None

    # ------------------------------------------------------------ lifecycle
    def add_slice(self, s: PoolSlice) -> None:
        with self._lock:
            if s.name in self._slices:
                raise ValueError(f"slice {s.name!r} already in the pool")
            self._slices[s.name] = s

    def remove_slice(self, name: str) -> Optional[str]:
        """Remove a slice from the pool. Returns the displaced job's name
        when the slice was held (the scheduler preempts it), else None.
        Unknown names are a no-op (idempotent shrink)."""
        with self._lock:
            if name not in self._slices:
                return None
            del self._slices[name]
            return self._held.pop(name, None)

    def acquire(self, job: str, parameters: Optional[dict] = None
                ) -> Optional[PoolSlice]:
        """Smallest free slice the job's mesh shape tiles; idempotent per
        job (re-acquiring returns the held slice)."""
        while True:
            with self._lock:
                for sname, holder in self._held.items():
                    if holder == job:
                        return self._slices[sname]
                free = sorted(
                    (s for s in self._slices.values()
                     if s.name not in self._held),
                    key=lambda s: (s.chips, s.name))
            # fit check outside the lock: _mesh_shape_from imports the mesh
            # helpers and may be slow on first call
            chosen = next(
                (s for s in free if mesh_fits(parameters or {}, s.chips)),
                None)
            if chosen is None:
                return None
            with self._lock:
                # the slice may have been taken/removed while we fit-checked
                if (chosen.name in self._slices
                        and chosen.name not in self._held):
                    self._held[chosen.name] = job
                    return chosen

    def release(self, job: str) -> None:
        with self._lock:
            for sname, holder in list(self._held.items()):
                if holder == job:
                    del self._held[sname]
