"""Chaos injection for load replays: scheduled faults over the EXISTING
control surfaces — nothing here reaches into engine internals.

A chaos schedule is a list of ops, each fired at ``t`` seconds into the
replay (scaled by the replay's speed factor):

  {"t": 5.0, "op": "drain",          "replica": "replica-1"}
  {"t": 6.0, "op": "scale",          "replicas": 3}
  {"t": 7.0, "op": "adapter_unload", "url": "http://r0:8001",
                                     "adapter": "tenant-3"}
  {"t": 8.0, "op": "adapter_load",   "url": "http://r0:8001",
                                     "name": "tenant-3",
                                     "checkpoint": "/ckpts/t3"}
  {"t": 9.0, "op": "kill",           "replica": "replica-0"}
  {"t": 10., "op": "slice_shrink",   "slice": "slice-1"}

``drain``/``scale`` map to the gateway's ``POST /admin/drain`` /
``/admin/scale``; ``adapter_*`` to a replica's ``/admin/adapters``. ``kill``
and ``slice_shrink`` have no HTTP surface by design (killing a process is
the supervisor's job, shrinking a slice pool is the scheduler's) — they
require injected actions, which the in-process harness (``--selftest``,
bench replay, tests) provides. An op with no action available is logged as
skipped, never an error: a chaos run against a production gateway simply
can't kill what it can't reach.

Every op's outcome lands in ``injector.log`` so the replay report shows
WHAT was injected WHEN next to the SLO verdict it did (or didn't) dent.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional


def _http(method: str, url: str, payload: Optional[dict] = None,
          timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def http_actions(gateway_url: str) -> Dict[str, Callable[[dict], dict]]:
    """The over-the-wire op set, bound to one gateway base URL."""
    base = gateway_url.rstrip("/")
    return {
        "drain": lambda op: _http(
            "POST", base + "/admin/drain",
            {"replica": op.get("replica", "")}),
        "scale": lambda op: _http(
            "POST", base + "/admin/scale",
            {"replicas": int(op.get("replicas", 0))}),
        "adapter_unload": lambda op: _http(
            "DELETE",
            op["url"].rstrip("/") + "/admin/adapters/" + op["adapter"]),
        "adapter_load": lambda op: _http(
            "POST", op["url"].rstrip("/") + "/admin/adapters",
            {"name": op["name"], "checkpoint": op["checkpoint"],
             "load": op.get("load", True)}),
    }


def load_chaos(path_or_json: str) -> List[dict]:
    """Chaos schedule from a file path or inline JSON ('[' / '{' prefix)."""
    text = path_or_json.strip()
    if not text.startswith(("[", "{")):
        with open(path_or_json, encoding="utf-8") as f:
            text = f.read()
    doc = json.loads(text)
    if isinstance(doc, dict):
        doc = doc.get("ops")
    if not isinstance(doc, list):
        raise ValueError("chaos config must be a list of ops "
                         "(or {\"ops\": [...]})")
    for op in doc:
        if not isinstance(op.get("t"), (int, float)) or not op.get("op"):
            raise ValueError(f"bad chaos op {op!r}: needs t and op")
    return sorted(doc, key=lambda o: o["t"])


class ChaosInjector:
    """Fires a chaos schedule on its own thread while a replay runs.

    ``actions`` maps op name → callable(op_dict) → detail; in-process
    harnesses inject callables for ops with no wire surface (kill,
    slice_shrink) or to override the HTTP defaults."""

    def __init__(self, ops: List[dict],
                 actions: Optional[Dict[str, Callable]] = None):
        self.ops = sorted(ops, key=lambda o: o["t"])
        self.actions = dict(actions or {})
        self.log: List[dict] = []
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _fire(self, op: dict, at_s: float):
        entry = {"t": round(at_s, 3), "op": op.get("op"),
                 "args": {k: v for k, v in op.items()
                          if k not in ("t", "op")}}
        action = self.actions.get(op["op"])
        if action is None:
            entry.update(ok=None, detail="skipped: no action for op")
        else:
            try:
                out = action(op)
                entry.update(ok=True, detail=out if isinstance(out, (str, dict))
                             else repr(out))
            except urllib.error.HTTPError as e:
                entry.update(ok=False, detail=f"HTTP {e.code}")
            except Exception as e:  # noqa: BLE001 — chaos failing is data
                entry.update(ok=False, detail=str(e))
        with self._lock:
            self.log.append(entry)

    def _log_skipped(self, ops: List[dict], at_s: float):
        with self._lock:
            for missed in ops:
                self.log.append({
                    "t": round(at_s, 3), "op": missed.get("op"),
                    "args": {k: v for k, v in missed.items()
                             if k not in ("t", "op")},
                    "ok": None,
                    "detail": "skipped: replay ended before "
                              f"op time t={missed['t']}"})

    def run(self, speed: float = 1.0):
        """Blocking: fire every op at its (speed-scaled) offset. Ops the
        replay ends before — still in the future when stop() lands, OR
        overdue behind a slow earlier action — are LOGGED as skipped,
        never fired post-run and never silently dropped: a report must
        not show a clean verdict next to a schedule that half-ran (or a
        fault that landed AFTER the judgment)."""
        t0 = time.monotonic()
        for i, op in enumerate(self.ops):
            delay = op["t"] / max(speed, 1e-9) - (time.monotonic() - t0)
            if (delay > 0 and self._shutdown.wait(delay)) \
                    or self._shutdown.is_set():
                self._log_skipped(self.ops[i:], time.monotonic() - t0)
                return
            self._fire(op, time.monotonic() - t0)

    def start(self, speed: float = 1.0) -> "ChaosInjector":
        self._thread = threading.Thread(
            target=self.run, args=(speed,), name="dtx-chaos", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def report(self) -> List[dict]:
        with self._lock:
            return list(self.log)
