"""AdapterRegistry: host-side adapter lifecycle over an AdapterStore (the
port of ``datatunerx_tpu/adapters/registry.py``).

The registry maps adapter *names* to checkpoints (the port's ``state.pt``
steps), materialises them into pool slots **on miss** at admission time,
refcounts the slots pinned by in-flight requests, and LRU-evicts unpinned
residents when the pool is full. The serving admin plane (``POST/DELETE/GET
/admin/adapters``) and the engine's admission path are its only writers.

Loads are ASYNC: ``acquire`` reserves a slot and starts the checkpoint read
and the device insert on a loader thread, returning None; the engine
FIFO-waits the missing request while decode keeps running for everyone
else. The registry lock covers bookkeeping and the device insert only,
never the checkpoint read; the decode path never takes it (it reads the
store's published ``tree`` snapshot), and membership and residency reads
use lock-free published snapshots.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from datatunerx_tpu_torch.adapters.store import AdapterStore, validate_adapter
from datatunerx_tpu_torch.models.lora import lora_scaling


class AdapterPinnedError(RuntimeError):
    """Unload refused: in-flight requests still decode with this adapter."""


def _default_loader(checkpoint_path: str) -> dict:
    # lazy import: batched_engine imports this package
    from datatunerx_tpu_torch.serving.batched_engine import (
        load_checkpoint_state,
    )

    return load_checkpoint_state(checkpoint_path)


class _Entry:
    __slots__ = ("name", "checkpoint", "slot", "refs", "rank", "loads",
                 "loading", "error", "event", "pending_first")

    def __init__(self, name: str, checkpoint: str):
        self.name = name
        self.checkpoint = checkpoint
        self.slot: Optional[int] = None  # device idx 1..P when resident
        self.refs = 0  # active decode slots pinning this adapter
        self.rank: Optional[int] = None  # known after first load
        self.loads = 0
        self.loading = False  # async load in flight (slot reserved)
        self.error: Optional[BaseException] = None  # last load's failure
        self.event: Optional[threading.Event] = None  # set when load ends
        # the first acquire after a load completes is the MISS resolving,
        # not a fresh hit — consume this flag instead of counting a hit
        self.pending_first = False


class AdapterRegistry:
    def __init__(self, store: AdapterStore,
                 loader: Optional[Callable[[str], dict]] = None,
                 load_observer: Optional[Callable[[float], None]] = None,
                 on_load_done: Optional[Callable[[], None]] = None,
                 host_tier=None):
        self.store = store
        self._loader = loader or _default_loader
        # host-RAM tier (tenancy/host_tier.HostAdapterTier): evicted
        # adapters' host tensors stay cached so evict→reload skips the
        # checkpoint read; None (the default) = no tier
        self.host_tier = host_tier
        self.host_hits = 0  # loads served from the host tier
        self.orbax_loads = 0  # loads that paid the checkpoint read (the
        # reference's stats key, read by the gateway and /metrics)
        # adapter names immune to LRU eviction (pinned-tier tenants');
        # empty set = plain LRU order
        self._pinned_names: set = set()
        # called with each checkpoint load's wall ms (the engine wires the
        # shared-registry dtx_serving_adapter_load_ms histogram here)
        self._load_observer = load_observer
        # called (outside the lock) whenever an async load resolves —
        # success or failure — so the engine can wake its scheduler
        # instead of polling out the FIFO-head's wait
        self._on_load_done = on_load_done
        self._lock = threading.RLock()
        # live async loader threads (pruned on spawn, joined by close());
        # without this a teardown mid-load leaves a worker mutating a
        # dead registry
        self._loader_threads: List[threading.Thread] = []
        self._entries: Dict[str, _Entry] = {}
        # resident names in LRU order (front = coldest); pinned entries are
        # skipped by eviction, not reordered out
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._free_slots: List[int] = list(range(1, store.pool_slots + 1))
        self.stats = {"loads": 0, "evictions": 0, "hits": 0, "misses": 0}
        self.load_ms: List[float] = []  # recent load latencies (bounded)
        # lock-free read snapshots, republished on every membership/slot
        # mutation: the lock is deliberately held across checkpoint loads
        # (the designed slow path), and routing stats / submit-time
        # membership checks must not stall behind a multi-second load
        self._resident_snapshot: Dict[str, int] = {}
        self._id_map_snapshot: Dict[str, int] = {"": 0}

    # ----------------------------------------------------------- membership
    def register(self, name: str, checkpoint_path: str) -> dict:
        """Make ``name`` loadable. Idempotent for the same checkpoint;
        re-registering a name under a DIFFERENT checkpoint is refused while
        resident or pinned (unload first) so a tenant's name can never
        silently start serving other weights mid-flight."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        with self._lock:
            ent = self._entries.get(name)
            if ent is not None:
                if ent.checkpoint == checkpoint_path:
                    return self.describe(name)
                if ent.slot is not None or ent.refs or ent.loading:
                    raise AdapterPinnedError(
                        f"adapter {name!r} is resident/pinned/loading under "
                        f"{ent.checkpoint!r}; DELETE it before re-registering"
                        " with a different checkpoint")
                ent.checkpoint = checkpoint_path
                ent.rank = None
                self._publish_locked()
                return self.describe(name)
            self._entries[name] = _Entry(name, checkpoint_path)
            self._publish_locked()
            return self.describe(name)

    def unregister(self, name: str) -> bool:
        """Forget ``name``, evicting its weights if resident. Refuses while
        pinned (AdapterPinnedError → the admin plane answers 409)."""
        with self._lock:
            ent = self._entries.get(name)
            if ent is None:
                return False
            if ent.refs or ent.loading:
                raise AdapterPinnedError(
                    f"adapter {name!r} pinned by {ent.refs} in-flight "
                    "request(s)" + (" (load in progress)" if ent.loading
                                    else ""))
            if ent.slot is not None:
                self._evict_locked(ent)
            del self._entries[name]
            if self.host_tier is not None:
                # a deleted adapter must not resurrect from host RAM
                self.host_tier.drop(name)
            self._publish_locked()
            return True

    def set_pinned(self, names) -> None:
        """Replace the pin-tier adapter set (the tenancy directory's
        pinned tenants' adapters): these names are never chosen as LRU
        eviction victims while resident. Idempotent; an empty set
        restores the plain LRU order."""
        with self._lock:
            self._pinned_names = set(names or ())

    def pinned_names(self) -> set:
        with self._lock:
            return set(self._pinned_names)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def resident(self) -> Dict[str, int]:
        """Lock-free: the last published snapshot (one attribute read), so
        routing/stats never stall behind an in-progress checkpoint load."""
        return self._resident_snapshot

    def id_map(self) -> Dict[str, int]:
        """adapter_ids-compatible view: every KNOWN name maps to its device
        idx when resident, -1 when load-on-miss would have to run first.
        '' is the base model (device idx 0). Lock-free snapshot — submit's
        per-request membership check must not queue behind a load."""
        return self._id_map_snapshot

    def _publish_locked(self):
        """Rebuild the read snapshots; call at every point membership or a
        slot binding changed, while still holding the lock. Readers swap
        whole dicts — never a half-mutated view."""
        self._resident_snapshot = {n: e.slot for n, e in
                                   self._entries.items()
                                   if e.slot is not None}
        id_map = {"": 0}
        for n, e in self._entries.items():
            id_map[n] = e.slot if e.slot is not None else -1
        self._id_map_snapshot = id_map

    def describe(self, name: str) -> dict:
        with self._lock:
            ent = self._entries[name]
            return {"name": ent.name, "checkpoint": ent.checkpoint,
                    "resident": ent.slot is not None, "slot": ent.slot,
                    "pinned_by": ent.refs, "rank": ent.rank,
                    "loads": ent.loads, "loading": ent.loading}

    # ------------------------------------------------------------ occupancy
    def occupancy(self) -> dict:
        with self._lock:
            resident = [e for e in self._entries.values()
                        if e.slot is not None]
            return {
                "slots": self.store.pool_slots,
                "free": len(self._free_slots),
                "resident": len(resident),
                "pinned": sum(1 for e in resident if e.refs),
                "rank_max": self.store.rank_max,
                "targets": list(self.store.targets),
                "registered": len(self._entries),
                "hbm_bytes": self.store.nbytes(),
                **self.stats,
            }

    def host_tier_stats(self) -> Optional[dict]:
        """Host-RAM tier occupancy + the host_hits/orbax_loads load
        split, or None when the tier isn't configured (so consumers can
        gate their exposition on its presence)."""
        if self.host_tier is None:
            return None
        out = self.host_tier.stats()
        with self._lock:
            out["host_hits"] = self.host_hits
            out["orbax_loads"] = self.orbax_loads
        return out

    # ------------------------------------------------------- acquire/release
    def acquire(self, name: str, wait: bool = False,
                count_hit: bool = True) -> Optional[int]:
        """Resolve ``name`` to a device pool idx and pin it.

        NON-BLOCKING by default (the engine scheduler's contract): a miss
        reserves a slot — evicting the coldest UNPINNED resident when the
        pool is full — kicks the checkpoint read onto a loader thread, and
        returns None; the caller FIFO-waits and retries, succeeding once
        the load lands, while decode keeps ticking for everyone else.
        None is also the answer while every slot is pinned by in-flight
        work (KV-block-exhaustion semantics). ``wait=True`` blocks until
        the load resolves (scoring / admin warm-up paths, never the
        scheduler). ``count_hit=False`` suppresses the hit counter — a
        readmission RETRY of the same request (released its pin on
        KV-block exhaustion) is not a new lookup and must not inflate the
        hit rate. Raises KeyError for an unregistered name; a failed
        load's error (bad checkpoint, rank/target geometry) is re-raised
        by the next acquire of that name."""
        while True:
            with self._lock:
                ent = self._entries.get(name)
                if ent is None:
                    raise KeyError(
                        f"unknown adapter {name!r}; registered: "
                        f"{sorted(self._entries)}")
                if ent.error is not None:
                    err, ent.error = ent.error, None
                    raise err
                if ent.slot is not None:
                    ent.refs += 1
                    self._lru[name] = None
                    self._lru.move_to_end(name)
                    if ent.pending_first:
                        ent.pending_first = False  # the miss resolving
                    elif count_hit:
                        self.stats["hits"] += 1
                    return ent.slot
                if not ent.loading:
                    slot = self._take_slot_locked()
                    if slot is None:
                        return None  # pool exhausted: all pinned
                    self.stats["misses"] += 1
                    ent.loading = True
                    ent.event = threading.Event()
                    t = threading.Thread(target=self._load_worker,
                                         args=(ent, slot), daemon=True)
                    self._loader_threads = [
                        x for x in self._loader_threads if x.is_alive()]
                    self._loader_threads.append(t)
                    t.start()
                ev = ent.event
            if not wait:
                return None
            ev.wait()

    def release(self, name: str):
        with self._lock:
            ent = self._entries.get(name)
            if ent is not None and ent.refs > 0:
                ent.refs -= 1

    def close(self, timeout: float = 10.0):
        """Wait out in-flight async loads so no loader thread outlives the
        registry's owner (the engine joins its scheduler first, then calls
        this). Loads signal their waiters either way; ``timeout`` bounds a
        wedged checkpoint read from wedging shutdown."""
        with self._lock:
            threads = [t for t in self._loader_threads if t.is_alive()]
            self._loader_threads = []
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def preload(self, name: str):
        """Warm an adapter without pinning it (admin POST with load=true):
        blocking acquire + immediate release, so the next request is a
        residency hit. Raises the load's own error on a bad checkpoint."""
        idx = self.acquire(name, wait=True)
        if idx is None:
            raise RuntimeError(
                f"adapter pool exhausted ({self.store.pool_slots} slots, "
                "all pinned); cannot preload")
        self.release(name)

    # -------------------------------------------------------------- internal
    def _take_slot_locked(self) -> Optional[int]:
        if self._free_slots:
            return self._free_slots.pop(0)
        for victim_name in self._lru:  # front = coldest
            if victim_name in self._pinned_names:
                continue  # pin-tier tenants' adapters never evict
            victim = self._entries.get(victim_name)
            if victim is not None and victim.slot is not None \
                    and victim.refs == 0:
                slot = victim.slot
                self._evict_locked(victim)
                # _evict_locked returned the slot to the free list
                self._free_slots.remove(slot)
                return slot
        return None

    def _evict_locked(self, ent: _Entry):
        self.store.clear(ent.slot)
        self._free_slots.append(ent.slot)
        self._free_slots.sort()
        ent.slot = None
        self._lru.pop(ent.name, None)
        self.stats["evictions"] += 1
        self._publish_locked()

    def _load_worker(self, ent: _Entry, slot: int):
        """Loader thread: checkpoint read + validation run UNLOCKED (the
        multi-second part); only the device insert + bookkeeping take the
        lock. Failure frees the reserved slot and parks the error on the
        entry for the next acquire to raise."""
        t0 = time.perf_counter()
        try:
            cached = (self.host_tier.get(ent.name, ent.checkpoint)
                      if self.host_tier is not None else None)
            if cached is not None:
                # host-tier hit: evict→reload without the checkpoint read
                layers, scaling = cached
                from_host = True
            else:
                state = self._loader(ent.checkpoint)
                layers = (state.get("lora") or {}).get("layers")
                if not layers:
                    raise ValueError(
                        f"adapter {ent.name!r}: no lora tree in "
                        f"{ent.checkpoint}")
                from_host = False
                scaling = state.get("_scaling")
            rank = validate_adapter(layers, self.store.rank_max,
                                    self.store.targets, name=ent.name)
            if scaling is None:
                scaling = lora_scaling(32.0, rank)
            if self.host_tier is not None and not from_host:
                self.host_tier.put(ent.name, ent.checkpoint, layers,
                                   float(scaling))
        except Exception as e:  # noqa: BLE001 — parked for the acquirer
            self._load_failed(ent, slot, e)
            return
        with self._lock:
            try:
                # insert under the lock: concurrent loads to different
                # slots functionally rebuild the same pool buffers — an
                # unserialised read-modify-write would lose one insert
                self.store.insert(slot, layers, float(scaling),
                                  name=ent.name)
            except Exception as e:  # noqa: BLE001
                pass_e = e
            else:
                pass_e = None
                ent.slot = slot
                ent.rank = rank
                ent.loads += 1
                ent.loading = False
                ent.pending_first = True
                self._lru[ent.name] = None
                self._lru.move_to_end(ent.name)
                self.stats["loads"] += 1
                if from_host:
                    self.host_hits += 1
                else:
                    self.orbax_loads += 1
                ms = (time.perf_counter() - t0) * 1e3
                self.load_ms.append(ms)
                if len(self.load_ms) > 512:
                    del self.load_ms[:256]
                self._publish_locked()
                ev = ent.event
        if pass_e is not None:
            self._load_failed(ent, slot, pass_e)
            return
        ev.set()
        if self._load_observer is not None:
            self._load_observer(ms)
        if self._on_load_done is not None:
            self._on_load_done()

    def _load_failed(self, ent: _Entry, slot: int, err: BaseException):
        with self._lock:
            self._free_slots.append(slot)
            self._free_slots.sort()
            ent.loading = False
            ent.error = err
            ev = ent.event
        if ev is not None:
            ev.set()
        if self._on_load_done is not None:
            self._on_load_done()
