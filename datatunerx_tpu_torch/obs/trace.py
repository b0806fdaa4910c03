"""Request tracing: Dapper-style spans over the X-DTX-Trace-Id the gateway
already mints.

The port's copy of ``datatunerx_tpu/obs/trace.py``. The gateway mints an
``X-DTX-Trace-Id`` for every request; this module collects what happened
under it:

  Span        — one timed operation: name, trace id, wall-clock start, a
                monotonic duration, attrs, and point-in-time events (offsets
                from span start). Spans serialize to plain dicts so they
                cross process boundaries as JSON (the gateway merges a
                remote replica's spans into its own trace view).
  Tracer      — context-propagated span factory (``contextvars``): nested
                ``with tracer.span(...)`` blocks get their parent linked
                automatically, completed spans land in the TraceStore, and
                orphans (opened but never closed — a handler thread died)
                are reaped with status "orphaned" instead of leaking.
  TraceStore  — bounded ring of completed traces keyed by trace id, behind
                ``GET /debug/trace/<id>`` on both servers; optional JSONL
                event log for offline forensics.

Hot-path discipline: span creation/finish is a couple of perf_counter reads
plus appends; the store insert is a short lock around an OrderedDict move.
Nothing here touches device values — timeline stamps are taken at the
engine's designed sync points and arrive as host floats
(``build_request_span``).
"""

from __future__ import annotations

import collections
import contextvars
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

_CURRENT_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "dtx_current_span", default=None)


class Span:
    """One timed operation inside a trace. Mutated by the thread that owns
    the request (no lock — a span never migrates threads mid-flight)."""

    __slots__ = ("name", "trace_id", "parent", "attrs", "events",
                 "start_ms", "_t0", "duration_ms", "status", "_token")

    def __init__(self, name: str, trace_id: str = "",
                 parent: Optional[str] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.parent = parent
        self.attrs = dict(attrs or {})
        self.events: List[dict] = []
        self.start_ms = time.time() * 1e3  # wall, for cross-process ordering
        self._t0 = time.perf_counter()
        self.duration_ms: Optional[float] = None
        self.status = "open"
        self._token = None

    def event(self, name: str, **attrs):
        """Point-in-time annotation at the current offset from span start."""
        e = {"name": name,
             "t_ms": round((time.perf_counter() - self._t0) * 1e3, 3)}
        if attrs:
            e.update(attrs)
        self.events.append(e)

    def set(self, **attrs):
        self.attrs.update(attrs)

    def finish(self, status: str = "ok"):
        if self.duration_ms is None:
            self.duration_ms = round(
                (time.perf_counter() - self._t0) * 1e3, 3)
            self.status = status

    def age_s(self) -> float:
        return time.perf_counter() - self._t0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "parent": self.parent,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": self.duration_ms,
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _SpanContext:
    """Context manager returned by ``Tracer.span``: installs the span as
    the contextvar parent for the block, finishes + records it on exit."""

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._span._token = _CURRENT_SPAN.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if self._span._token is not None:
            _CURRENT_SPAN.reset(self._span._token)
            self._span._token = None
        if exc is not None and "error" not in self._span.attrs:
            self._span.attrs["error"] = str(exc)
        self._tracer.finish(
            self._span, status="error" if exc_type is not None else "ok")
        return False


class TraceStore:
    """Bounded ring buffer of completed traces keyed by trace id.

    ``add`` appends a completed span to its trace and bumps the trace to
    the ring's MRU end; when the ring exceeds ``capacity`` traces, the
    oldest trace is dropped whole. With ``jsonl_path`` set, every completed
    span is also appended (one JSON object per line) — the write happens
    OUTSIDE the ring lock so a slow disk can't stall recording threads."""

    def __init__(self, capacity: int = 256,
                 jsonl_path: Optional[str] = None,
                 max_spans_per_trace: int = 64):
        self.capacity = max(1, int(capacity))
        self.max_spans_per_trace = max_spans_per_trace
        self.jsonl_path = jsonl_path
        self.evictions = 0
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self._jsonl_lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._traces)

    def add(self, span_dict: dict):
        tid = span_dict.get("trace_id") or ""
        if not tid:
            return
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                spans = self._traces[tid] = []
            if len(spans) < self.max_spans_per_trace:
                spans.append(span_dict)
            self._traces.move_to_end(tid)
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
                self.evictions += 1
        if self.jsonl_path:
            line = json.dumps(span_dict, default=str)
            with self._jsonl_lock:
                with open(self.jsonl_path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                return None
            return {"trace_id": trace_id, "spans": list(spans)}

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._traces.keys())


class Tracer:
    """Span factory + open-span registry (for orphan reaping).

    ``with tracer.span("gateway.request", trace_id=tid) as sp:`` opens a
    span whose parent is whatever span the calling context already holds;
    on block exit the span is finished and recorded into the store. A span
    opened but never closed (its owning thread died mid-request) is closed
    with status "orphaned" by ``reap_orphans`` — invoked opportunistically
    on span creation, so the open-set cannot grow without bound."""

    _REAP_EVERY_S = 30.0

    def __init__(self, store: Optional[TraceStore] = None,
                 orphan_age_s: float = 600.0):
        # NOT `store or ...`: an EMPTY TraceStore is falsy through __len__,
        # and silently swapping the caller's store for a private one breaks
        # the /debug/trace endpoint reading the shared ring
        self.store = store if store is not None else TraceStore()
        self.orphan_age_s = orphan_age_s
        self._open: Dict[int, Span] = {}
        self._lock = threading.Lock()
        self._last_reap = time.perf_counter()

    def span(self, name: str, trace_id: str = "",
             **attrs) -> _SpanContext:
        parent = _CURRENT_SPAN.get()
        if parent is not None and not trace_id:
            trace_id = parent.trace_id
        sp = Span(name, trace_id=trace_id,
                  parent=parent.name if parent is not None else None,
                  attrs=attrs)
        with self._lock:
            self._open[id(sp)] = sp
        self._maybe_reap()
        return _SpanContext(self, sp)

    def start(self, name: str, trace_id: str = "",
              parent: Optional[str] = None, **attrs) -> Span:
        """Open a span WITHOUT contextvar propagation — for generators,
        where a ``with tracer.span(...)`` block suspending across yields
        would leak the contextvar into the consumer's context. The caller
        owns the lifecycle: pair with ``tracer.finish(span)``."""
        sp = Span(name, trace_id=trace_id, parent=parent, attrs=attrs)
        with self._lock:
            self._open[id(sp)] = sp
        self._maybe_reap()
        return sp

    def current(self) -> Optional[Span]:
        return _CURRENT_SPAN.get()

    def finish(self, sp: Span, status: str = "ok"):
        with self._lock:
            was_open = self._open.pop(id(sp), None) is not None
        sp.finish(status)
        # record only if WE closed it: a span the reaper already recorded as
        # "orphaned" (request outlived orphan_age_s, then completed anyway)
        # must not land in the trace a second time
        if was_open:
            self.store.add(sp.to_dict())

    # ------------------------------------------------------------- orphans
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def _maybe_reap(self):
        now = time.perf_counter()
        if now - self._last_reap < self._REAP_EVERY_S:
            return
        self._last_reap = now
        self.reap_orphans()

    def reap_orphans(self, max_age_s: Optional[float] = None) -> int:
        """Close-and-record every open span older than ``max_age_s`` with
        status "orphaned". Returns how many were reaped."""
        limit = self.orphan_age_s if max_age_s is None else max_age_s
        with self._lock:
            stale = [sp for sp in self._open.values() if sp.age_s() > limit]
            for sp in stale:
                self._open.pop(id(sp), None)
        for sp in stale:
            sp.finish("orphaned")
            self.store.add(sp.to_dict())
        return len(stale)


# ------------------------------------------------------------ engine bridge

def build_request_span(
    trace_id: str,
    t_submit: float,
    timeline: List[Tuple[float, str, dict]],
    first_token_ts: Optional[float],
    last_token_ts: Optional[float],
    n_tokens: int,
    wall_submit_ms: float,
    name: str = "engine.request",
    error: Optional[str] = None,
    attrs: Optional[dict] = None,
) -> dict:
    """Fold an engine request's scheduler timeline into one span dict.

    ``timeline`` entries are ``(perf_counter stamp, event name, detail)``
    recorded by the scheduler (admit / prefill / activate / finish);
    ``first/last_token_ts`` are the host arrival stamps of the first and
    last streamed tokens — taken at the decode loop's designed sync point,
    so the derived per-request TTFT/TPOT are true wall numbers:

      ttft_ms = first_token - submit        (queue + prefill + first decode)
      tpot_ms = (last - first) / (n - 1)    (steady-state inter-token time)
    """
    events = [{"name": ev, "t_ms": round((ts - t_submit) * 1e3, 3), **det}
              for ts, ev, det in timeline]
    out_attrs = dict(attrs or {})
    out_attrs["n_tokens"] = n_tokens
    end_ts = t_submit
    if first_token_ts is not None:
        events.append({"name": "first_token",
                       "t_ms": round((first_token_ts - t_submit) * 1e3, 3)})
        out_attrs["ttft_ms"] = round((first_token_ts - t_submit) * 1e3, 3)
        end_ts = first_token_ts
    if last_token_ts is not None:
        end_ts = last_token_ts
        if first_token_ts is not None and n_tokens > 1:
            out_attrs["tpot_ms"] = round(
                (last_token_ts - first_token_ts) / (n_tokens - 1) * 1e3, 3)
    if timeline:
        end_ts = max(end_ts, timeline[-1][0])
    if error:
        out_attrs["error"] = error
    events.sort(key=lambda e: e["t_ms"])
    return {
        "name": name,
        "trace_id": trace_id,
        "parent": None,
        "start_ms": round(wall_submit_ms, 3),
        "duration_ms": round((end_ts - t_submit) * 1e3, 3),
        "status": "error" if error else "ok",
        "attrs": out_attrs,
        "events": events,
    }
