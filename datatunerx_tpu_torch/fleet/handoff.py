"""Prefill→decode handoff: prefill specialists do prompt work, decode
replicas own token production.

Steady state (``tick``): every available role=prefill replica with live
sessions is drained of its DECODE-READY work — sessions whose chunked
prefill finished are exported (dtx-kv-session payloads) and imported
onto the decode-preferring peer with the most free KV blocks. Sessions
still mid-chunked-prefill are left to finish their prompt (the export
skips them); they move on the NEXT tick, one prefill-to-decode pipeline
per session. Imported continuations park in the gateway handoff buffer
keyed by trace id; the client stream that dies with the migrated marker
splices them — one uninterrupted SSE stream.

Drain-time (gateway ``handoff_sessions`` with the fleet plane enabled)
additionally ships MID-prefill tails: ``export_sessions(
include_prefill=True)`` exports the blocks written so far plus the
remaining prompt tokens, and the importer resumes chunking exactly where
the source stopped (BatchedEngine._import_prefill_tail) — a prefill
specialist can be drained mid-prompt with zero re-prefill.

Counters → dtx_fleet_handoff_total{outcome}:
  ok       session re-homed onto a decode peer (continuation parked)
  cold     no peer could admit it; the client falls back to re-prefill
  skipped  source sessions not exportable this tick (mid-prefill)
  none     a prefill source had work but no decode-side peer existed
"""

from __future__ import annotations

from typing import Callable, List, Optional


def decode_targets(pool, source_name: str) -> List:
    """Peers that should RECEIVE decode work: available, not the source,
    decode-preferring first (non-prefill roles), most free KV blocks
    first within a role class — the same greedy placement the spill
    coordinator uses, so both re-homing paths agree on where decode
    capacity lives."""

    def _rank(r):
        prefill = 1 if getattr(r, "role", "mixed") == "prefill" else 0
        try:
            free = int(r.stats_snapshot().get("kv_blocks_free") or 0)
        except Exception:  # noqa: BLE001 — stats are advisory
            free = 0
        return (prefill, -free, r.name)

    return sorted((r for r in pool.available() if r.name != source_name),
                  key=_rank)


class HandoffCoordinator:
    def __init__(self, pool, park: Callable[[str, dict], None],
                 wire: Optional[str] = None):
        self.pool = pool
        self.park = park
        self.wire = wire
        self.counters = {"ok": 0, "cold": 0, "skipped": 0, "none": 0}

    def tick(self) -> dict:
        out = {"moved": 0, "cold": 0, "skipped": 0}
        for source in list(self.pool.available()):
            if getattr(source, "role", "mixed") != "prefill":
                continue
            one = self._drain_source(source)
            for k in out:
                out[k] += one.get(k, 0)
        return out

    def _drain_source(self, source) -> dict:
        out = {"moved": 0, "cold": 0, "skipped": 0}
        try:
            st = source.stats_snapshot()
        except Exception:  # noqa: BLE001 — stats are advisory
            st = {}
        if not int(st.get("slots_busy") or 0):
            return out
        targets = decode_targets(self.pool, source.name)
        if not targets:
            self.counters["none"] += 1
            return out
        try:
            # include_prefill stays False here: steady-state ticks move
            # FINISHED prompt work only; a session mid-chunked-prefill
            # keeps its specialist until the prompt is done (its tail
            # ships only when the replica is actually draining)
            doc = source.export_sessions(wire=self.wire)
        except Exception:  # noqa: BLE001 — source busy/faulted; next tick
            return out
        if doc is None:
            return out
        skipped = len(doc.get("skipped") or [])
        out["skipped"] = skipped
        self.counters["skipped"] += skipped
        for payload in doc.get("sessions") or []:
            if self._rehome(payload, targets):
                out["moved"] += 1
            else:
                out["cold"] += 1
        return out

    def _rehome(self, payload: dict, targets: List) -> bool:
        tid = str(payload.get("trace_id") or "")
        for target in targets:
            try:
                res = target.import_session(payload)
            except Exception:  # noqa: BLE001 — refused or faulted; next peer
                continue
            if res is None:
                continue
            meta, stream = res
            self.park(tid, {
                "target": target.name, "meta": meta, "stream": stream,
                "text_so_far": str(meta.get("text_so_far") or "")})
            self.counters["ok"] += 1
            return True
        # tombstone: the dying stream stops waiting and re-prefills cold
        self.park(tid, {"failed": True})
        self.counters["cold"] += 1
        return False
