"""Peer-replica KV spill: a preempted session waits for the FLEET's
capacity, not one replica's.

KV overcommit preempts the youngest session when a replica's
block pool runs dry and parks its payload for local resumption. When a
PEER has free blocks, waiting locally is the wrong call — the spill
coordinator re-homes the parked payload there instead, token-exactly,
via the existing import path. Two-phase, so the session always has
exactly one owner:

  hold     source.hold_parked(...) leases parked sessions (time-bounded:
           a dead coordinator never wedges local resumption — the lease
           expires and the source resumes as before). A HELD head still
           blocks younger cold admissions on the source, so the
           fleet-wide oldest-live-session guarantee survives the move.
  import   peer with the most free blocks admits the payload
           (decode-preferring peers first); the continuation parks in
           the gateway handoff buffer for the client stream to splice.
  drop     source.drop_parked([trace_id]) — the source counts the
           preemption ``spilled`` and terminates the original request
           with the migrated marker, which is what sends the client
           stream to the handoff buffer.
  release  on any import failure, source.release_parked clears the
           lease immediately instead of waiting out the hold.

Counters → dtx_fleet_spill_total{outcome}: ok / refused (every peer
409'd — no slot or blocks) / error (transport or drop fault) / skipped
(parked work with no eligible peer).
"""

from __future__ import annotations

from typing import Callable, List

from datatunerx_tpu_torch.fleet.handoff import decode_targets


class SpillCoordinator:
    def __init__(self, pool, park: Callable[[str, dict], None],
                 max_sessions: int = 2, hold_s: float = 10.0):
        self.pool = pool
        self.park = park
        self.max_sessions = max_sessions
        self.hold_s = hold_s
        self.counters = {"ok": 0, "refused": 0, "error": 0, "skipped": 0}

    def tick(self) -> dict:
        out = {"moved": 0, "refused": 0, "skipped": 0}
        for source in list(self.pool.available()):
            try:
                st = source.stats_snapshot()
            except Exception:  # noqa: BLE001 — stats are advisory
                continue
            if not int(st.get("sessions_parked") or 0):
                continue
            one = self._spill_source(source)
            for k in out:
                out[k] += one.get(k, 0)
        return out

    def _spill_source(self, source) -> dict:
        out = {"moved": 0, "refused": 0, "skipped": 0}
        targets = decode_targets(self.pool, source.name)
        targets = [t for t in targets if self._has_free_blocks(t)]
        if not targets:
            # nothing can take the work: don't lease — the source's own
            # resume path stays the session's owner
            self.counters["skipped"] += 1
            out["skipped"] += 1
            return out
        try:
            doc = source.hold_parked(max_sessions=self.max_sessions,
                                     hold_s=self.hold_s)
        except Exception:  # noqa: BLE001 — lease refused/faulted; next tick
            return out
        if doc is None:
            return out  # replica kind without the spill surface
        for sess in doc.get("sessions") or []:
            outcome = self._spill_one(source, sess, targets)
            if outcome == "ok":
                out["moved"] += 1
            elif outcome == "refused":
                out["refused"] += 1
        return out

    @staticmethod
    def _has_free_blocks(replica) -> bool:
        """Only paged peers reporting free blocks are spill targets —
        re-homing onto a peer that will itself immediately preempt just
        shuttles the same session around the fleet."""
        try:
            st = replica.stats_snapshot()
        except Exception:  # noqa: BLE001 — stats are advisory
            return False
        return int(st.get("kv_blocks_free") or 0) > 0

    def _spill_one(self, source, sess: dict, targets: List) -> str:
        tid = str(sess.get("trace_id") or "")
        payload = sess.get("payload")
        if not isinstance(payload, dict):
            self._release(source, tid)
            self.counters["error"] += 1
            return "error"
        refused = False
        for target in targets:
            try:
                res = target.import_session(payload)
            except Exception as e:  # noqa: BLE001 — refused or faulted
                if getattr(e, "status", None) == 409:
                    refused = True
                continue
            if res is None:
                continue
            meta, stream = res
            # park BEFORE drop: dropping terminates the source request
            # with the migrated marker, and the dying client stream must
            # find its continuation already waiting
            self.park(tid, {
                "target": target.name, "meta": meta, "stream": stream,
                "text_so_far": str(meta.get("text_so_far") or "")})
            try:
                source.drop_parked([tid])
            except Exception as e:  # noqa: BLE001 — the lease still owns it
                # the peer now runs the session; the source's copy stays
                # leased until the hold expires, after which a local
                # resume would FORK the stream — loud, because this is
                # the one path where single-ownership depends on the
                # drop landing
                print(f"[fleet] spill drop of {tid or '<no-trace>'} on "
                      f"{source.name} failed: {e}", flush=True)
                self.counters["error"] += 1
                return "error"
            self.counters["ok"] += 1
            return "ok"
        self._release(source, tid)
        outcome = "refused" if refused else "error"
        self.counters[outcome] += 1
        return outcome

    @staticmethod
    def _release(source, tid: str):
        try:
            source.release_parked([tid])
        except Exception:  # noqa: BLE001 — the lease expiry is the backstop
            pass
