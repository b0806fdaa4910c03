"""Disaggregated fleet plane: the coordination layer that makes N serving
replicas behave as ONE KV pool. The port's own copy of
``datatunerx_tpu/fleet/``: plain Python over the replica migration surfaces,
so it runs over port replicas and JAX replicas alike.

Three composable pieces, each independently flag-gated and each built on
the replica migration surfaces (gateway/replica_pool.py) rather than any
new wire format:

  PrefixTier (prefix_tier.py)
      A gateway-side directory of published prefix-cache payloads
      (dtx-kv-prefix, serving/migration.py). The first replica to prefill
      a shared system prompt publishes it; the tier pushes it to peers so
      their FIRST request against that prompt activates with zero prefill
      chunks. LRU + byte-budget bounded.

  HandoffCoordinator (handoff.py)
      Steady-state prefill→decode disaggregation: sessions whose prompt
      work finished on a role=prefill specialist are exported and
      re-homed onto a decode-preferring peer; the client's SSE stream
      splices the imported continuation (gateway handoff buffer) and
      never notices. Drains additionally ship MID-chunked-prefill tails
      (``export_sessions(include_prefill=True)``).

  SpillCoordinator (spill.py)
      Preemption-parked sessions (KV overcommit) are re-homed
      onto a peer with free blocks instead of waiting for local capacity:
      two-phase hold → import-on-peer → drop, leases time-bounded so a
      dead coordinator never wedges local resumption. The fleet-wide
      oldest-live-session guarantee holds: a held head blocks younger
      local admissions until it is dropped (moved) or released.

``FleetPlane`` owns whichever pieces are enabled, ticks them from one
daemon thread, and exposes their counters for the gateway's /metrics
restatement (``dtx_fleet_*``). With every flag at its default the plane
is never constructed and the gateway is byte-identical to a fleet-less
build.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from datatunerx_tpu_torch.fleet.handoff import HandoffCoordinator
from datatunerx_tpu_torch.fleet.prefix_tier import PrefixTier
from datatunerx_tpu_torch.fleet.spill import SpillCoordinator

__all__ = [
    "FleetPlane",
    "HandoffCoordinator",
    "PrefixTier",
    "SpillCoordinator",
]


class FleetPlane:
    """Facade over the enabled coordinators. ``park`` is the gateway's
    handoff-buffer put (trace_id, entry) — both re-homing coordinators
    park imported continuations there for the dying client streams to
    splice. Tests drive ``tick()`` directly; production starts the
    daemon loop via ``start()``."""

    def __init__(self, pool, park: Callable[[str, dict], None],
                 prefix_budget_bytes: int = 0,
                 handoff: bool = False, spill: bool = False,
                 spill_max_sessions: int = 2, spill_hold_s: float = 10.0):
        self.pool = pool
        self.prefix: Optional[PrefixTier] = (
            PrefixTier(prefix_budget_bytes)
            if prefix_budget_bytes > 0 else None)
        self.handoff: Optional[HandoffCoordinator] = (
            HandoffCoordinator(pool, park) if handoff else None)
        self.spill: Optional[SpillCoordinator] = (
            SpillCoordinator(pool, park,
                             max_sessions=spill_max_sessions,
                             hold_s=spill_hold_s) if spill else None)
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes tick() against itself: the daemon loop and a test /
        # admin-triggered tick must not interleave two-phase spills
        self._tick_lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return (self.prefix is not None or self.handoff is not None
                or self.spill is not None)

    def tick(self) -> dict:
        """One coordination pass over the fleet; returns a per-piece
        summary (the /debug/fleet body)."""
        with self._tick_lock:
            out: dict = {}
            if self.handoff is not None:
                out["handoff"] = self.handoff.tick()
            if self.spill is not None:
                out["spill"] = self.spill.tick()
            if self.prefix is not None:
                out["prefix"] = self.prefix.sync_all(self.pool.available())
            return out

    def start(self, interval_s: float = 1.0):
        if self._thread is not None or interval_s <= 0:
            return

        def _loop():
            while not self._shutdown.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the loop must survive
                    print(f"[fleet] tick failed: {e}", flush=True)

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stats(self) -> dict:
        """Counter snapshot for /metrics restatement and /debug/fleet."""
        out: dict = {}
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        if self.handoff is not None:
            out["handoff"] = dict(self.handoff.counters)
        if self.spill is not None:
            out["spill"] = dict(self.spill.counters)
        return out
