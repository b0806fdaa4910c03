"""Fleet-shared prefix tier: one replica prefills a shared system prompt,
every replica serves it warm.

The tier is a gateway-side DIRECTORY of prefix payloads (dtx-kv-prefix,
serving/migration.py) keyed by fingerprint — sha1 over (adapter name,
prompt-prefix token ids), computed engine-side so the key is identical
across replicas regardless of tokenizer plumbing. ``sync(replica)`` is a
pull-then-push pass:

  pull  replica.export_prefix_entries(exclude=<known fingerprints>)
        — entries the tier has not seen are PUBLISHED (stored, LRU-fresh).
  push  every directory entry the replica is not known to hold is offered
        via replica.import_prefix_entry; ``{"imported": True}`` activates
        it in the replica's local _PrefixCache (COW block scatter on paged
        engines), so the replica's next request against that prompt
        admits with ZERO prefill chunks.

Byte budget: payloads are resident KV (b64 on the wire); the directory
evicts LRU past ``byte_budget`` so the gateway's footprint is bounded by
flag, not by traffic. Eviction only forgets the DIRECTORY copy — replicas
that already imported keep serving their local entries.

Counters (restated as dtx_fleet_prefix_* by the gateway):
  publishes  entries pulled into the directory
  hits       peer imports that activated an entry
  misses     pushes refused or failed (no free slot/blocks, unknown
             adapter on the target, transport fault)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional


def payload_bytes(payload: dict) -> int:
    """Approximate wire size of one prefix payload: the b64 KV strings
    dominate; scalar fields are noise next to them."""
    n = 0
    for doc in (payload.get("kv"), payload):
        if not isinstance(doc, dict):
            continue
        for v in doc.values():
            if isinstance(v, str):
                n += len(v)
    return max(1, n)


class PrefixTier:
    def __init__(self, byte_budget: int, max_pull: int = 4):
        self.byte_budget = int(byte_budget)
        self.max_pull = max_pull
        # fingerprint -> {"payload", "bytes", "adapter", "cursor",
        #                 "replicas": set(activated), "failed": set}
        self._d: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.counters = {"publishes": 0, "hits": 0, "misses": 0,
                         "evicted": 0}

    # ------------------------------------------------------------- directory
    def publish(self, payload: dict,
                source: Optional[str] = None) -> bool:
        """Store one exported prefix payload. Returns True when the
        fingerprint is new (a publish); re-offers of a known fingerprint
        only refresh its LRU position and mark the source as holding it."""
        fp = str(payload.get("fingerprint") or "")
        if not fp:
            return False
        with self._lock:
            ent = self._d.get(fp)
            if ent is not None:
                self._d.move_to_end(fp)
                if source:
                    ent["replicas"].add(source)
                return False
            ent = {"payload": dict(payload),
                   "bytes": payload_bytes(payload),
                   "adapter": str(payload.get("adapter") or ""),
                   "cursor": int(payload.get("cursor") or 0),
                   "replicas": {source} if source else set(),
                   "failed": set()}
            self._d[fp] = ent
            self._bytes += ent["bytes"]
            self.counters["publishes"] += 1
            self._evict_locked()
        return True

    def _evict_locked(self):
        while self._bytes > self.byte_budget and len(self._d) > 1:
            _, ent = self._d.popitem(last=False)
            self._bytes -= ent["bytes"]
            self.counters["evicted"] += 1

    # ----------------------------------------------------------------- sync
    def sync(self, replica) -> dict:
        """One pull-then-push pass against one replica. Replicas without
        the prefix surface (None returns) are skipped quietly; refusals
        count as misses but stay retryable (a 409 today — no free slot,
        adapter not yet loaded — may succeed next pass). A transport
        fault marks the replica failed for the entry so a permanently
        incompatible peer is not re-offered forever."""
        out = {"pulled": 0, "pushed": 0, "refused": 0}
        name = getattr(replica, "name", "")
        with self._lock:
            known = list(self._d.keys())
        try:
            doc = replica.export_prefix_entries(exclude=known,
                                                max_entries=self.max_pull)
        except Exception:  # noqa: BLE001 — export is advisory; push anyway
            doc = None
        for payload in (doc or {}).get("entries") or []:
            if self.publish(payload, source=name):
                out["pulled"] += 1
        with self._lock:
            todo = [(fp, ent["payload"]) for fp, ent in
                    reversed(list(self._d.items()))
                    if name not in ent["replicas"]
                    and name not in ent["failed"]]
        for fp, payload in todo:
            try:
                res = replica.import_prefix_entry(payload)
            except Exception as e:  # noqa: BLE001 — refusal or fault
                self.counters["misses"] += 1
                out["refused"] += 1
                if getattr(e, "status", None) != 409:
                    with self._lock:
                        ent = self._d.get(fp)
                        if ent is not None:
                            ent["failed"].add(name)
                continue
            if res is None:
                break  # replica kind without the prefix surface
            with self._lock:
                ent = self._d.get(fp)
                if ent is not None:
                    ent["replicas"].add(name)
            if res.get("imported"):
                self.counters["hits"] += 1
                out["pushed"] += 1
        return out

    def sync_all(self, replicas: List) -> dict:
        out = {"pulled": 0, "pushed": 0, "refused": 0}
        for r in replicas:
            one = self.sync(r)
            for k in out:
                out[k] += one[k]
        return out

    # -------------------------------------------------------------- reports
    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def holders(self, fingerprint: str) -> set:
        with self._lock:
            ent = self._d.get(fingerprint)
            return set(ent["replicas"]) if ent else set()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._d), "bytes": self._bytes,
                    **self.counters}
