"""SAN001 — the runtime lock-order sanitizer.

``install()`` replaces ``threading.Lock`` / ``threading.RLock`` with
factories returning tracked wrappers (``threading.Condition``/``Event``/
``queue.Queue`` build on those factories, so their internal locks are
tracked for free). Every **unbounded blocking** acquisition made while
the thread already holds other tracked locks records a directed edge

    (allocation site of a held lock) → (allocation site of the acquired)

in one process-global graph. Nodes are allocation sites — not instances
— so the ordering generalizes across objects and test runs; a
try-acquire or a finite-timeout acquire cannot deadlock and records
nothing. The first observation of an edge captures the acquiring
thread's stack (which shows BOTH sides: the ``with`` holding the first
lock upstream and the acquisition being made), so a cycle report can
print both acquisition stacks.

``scan_into`` (called by ``runtime.finalize``) turns the graph into
findings:

  * a cycle ⇒ potential ABBA deadlock, reported once per distinct node
    set with every edge's stack in the detail;
  * ``# dtxsan: order(N)`` / ``order(group:N)`` on an allocation line
    declares a rank — consistent low→high edges are JUSTIFIED (removed
    from the cycle graph), a high→low edge is an immediate
    declared-order violation;
  * a same-thread blocking re-acquisition of a non-reentrant Lock is a
    guaranteed self-deadlock, reported immediately and raised as
    ``LockOrderViolation`` so the suite fails instead of hanging.

Inline ``# dtxsan: disable=SAN001`` on the acquisition line suppresses,
as everywhere in dtxsan.
"""

from __future__ import annotations

import _thread
import linecache
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from datatunerx_tpu_torch.analysis.sanitizers import runtime
from datatunerx_tpu_torch.analysis.sanitizers.runtime import (
    SAN_LOCK_ORDER,
    Collector,
    capture_stack,
    site_str,
    user_site,
)

Site = Tuple[str, int]

_ORDER_RE = re.compile(
    r"#\s*dtxsan:\s*order\(\s*(?:([A-Za-z0-9_.-]+)\s*:)?\s*(-?\d+)\s*\)")


def _repo_alloc(site: Site) -> bool:
    return site[0].startswith(runtime.REPO_ROOT + os.sep)


class LockOrderViolation(RuntimeError):
    """Raised on a guaranteed self-deadlock (blocking re-acquisition of a
    non-reentrant Lock by the thread that already holds it)."""


class _EdgeSample:
    __slots__ = ("holder_site", "acq_site", "stack", "thread", "count")

    def __init__(self, holder_site: Site, acq_site: Site,
                 stack: List[str], thread: str):
        self.holder_site = holder_site
        self.acq_site = acq_site
        self.stack = stack
        self.thread = thread
        self.count = 1


class _TrackedLock:
    """Duck-typed stand-in for Lock/RLock: tracked acquire/release/with;
    everything else (``_is_owned``, ``_release_save`` for Condition,
    ``_at_fork_reinit``) delegates to the real lock underneath."""

    __slots__ = ("_dtxsan_inner", "_dtxsan_alloc", "_dtxsan_reentrant",
                 "_dtxsan_san", "__weakref__")

    def __init__(self, inner, alloc: Site, reentrant: bool,
                 san: "LockOrderSanitizer"):
        self._dtxsan_inner = inner
        self._dtxsan_alloc = alloc
        self._dtxsan_reentrant = reentrant
        self._dtxsan_san = san

    def acquire(self, blocking=True, timeout=-1):
        san = self._dtxsan_san
        if san.enabled:
            unbounded = blocking and (timeout is None or timeout < 0)
            if unbounded:
                san._before_blocking_acquire(self)
        ok = self._dtxsan_inner.acquire(blocking, -1 if timeout is None
                                        else timeout)
        if ok and san.enabled:
            san._push_held(self)
        return ok

    def release(self):
        self._dtxsan_inner.release()
        self._dtxsan_san._pop_held(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._dtxsan_inner.locked()

    def __getattr__(self, name):
        return getattr(self._dtxsan_inner, name)

    def __repr__(self):
        return (f"<dtxsan tracked {'RLock' if self._dtxsan_reentrant else 'Lock'}"
                f" from {site_str(self._dtxsan_alloc)} {self._dtxsan_inner!r}>")


class LockOrderSanitizer:
    def __init__(self):
        self.enabled = False
        self._orig_lock = None
        self._orig_rlock = None
        # the registry mutex must be a RAW lock — a tracked one would
        # recurse into edge recording forever
        self._mu = _thread.allocate_lock()
        self._edges: Dict[Tuple[Site, Site], _EdgeSample] = {}
        self._tls = threading.local()

    # ------------------------------------------------------------ install
    def install(self):
        if self.enabled:
            return
        if self._orig_lock is None:
            self._orig_lock = threading.Lock
            self._orig_rlock = threading.RLock
            san = self

            # only locks ALLOCATED by repo code are tracked; a library's
            # internal locks (torch's caches, grpc pools) get the
            # raw primitive back — their ordering is not ours to police
            # and tracking them would drown the graph in foreign edges
            def tracked_lock():
                site = user_site()
                if not _repo_alloc(site):
                    return san._orig_lock()
                return _TrackedLock(san._orig_lock(), site, False, san)

            def tracked_rlock():
                site = user_site()
                if not _repo_alloc(site):
                    return san._orig_rlock()
                return _TrackedLock(san._orig_rlock(), site, True, san)

            threading.Lock = tracked_lock
            threading.RLock = tracked_rlock
        self.enabled = True

    def uninstall(self):
        """Stop tracking and restore the factories. Wrappers already handed
        out keep delegating (their fast path checks ``enabled``)."""
        self.enabled = False
        if self._orig_lock is not None:
            threading.Lock = self._orig_lock
            threading.RLock = self._orig_rlock
            self._orig_lock = self._orig_rlock = None

    def reset(self):
        with self._mu:
            self._edges.clear()

    # ----------------------------------------------------------- tracking
    def _held(self) -> List[Tuple[_TrackedLock, Site]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def _push_held(self, lock: _TrackedLock):
        self._held().append((lock, user_site()))

    def _pop_held(self, lock: _TrackedLock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def _before_blocking_acquire(self, lock: _TrackedLock):
        held = self._held()
        if not held:
            return
        for h, _site in held:
            if h is lock:
                if lock._dtxsan_reentrant:
                    return  # RLock re-entry: no ordering information
                acq = user_site()
                f = runtime.COLLECTOR.add(
                    SAN_LOCK_ORDER, acq,
                    "guaranteed self-deadlock: this thread blocks "
                    "re-acquiring the non-reentrant Lock allocated at "
                    f"{site_str(lock._dtxsan_alloc)} which it already "
                    "holds — use an RLock or release first",
                    detail="\n".join(capture_stack()))
                if f is not None:
                    raise LockOrderViolation(f.message)
                return
        acq = user_site()
        stack: Optional[List[str]] = None
        for h, h_site in held:
            a, b = h._dtxsan_alloc, lock._dtxsan_alloc
            if a == b:
                continue  # same allocation site: parent/child of one class
            key = (a, b)
            with self._mu:
                sample = self._edges.get(key)
                if sample is not None:
                    sample.count += 1
                    continue
            if stack is None:  # one capture serves every new edge here
                stack = capture_stack()
            with self._mu:
                self._edges.setdefault(key, _EdgeSample(
                    h_site, acq, stack, threading.current_thread().name))

    # ------------------------------------------------------------- report
    @staticmethod
    def _declared_order(site: Site) -> Optional[Tuple[str, int]]:
        text = linecache.getline(site[0], site[1])
        m = _ORDER_RE.search(text)
        if not m:
            return None
        return (m.group(1) or "default", int(m.group(2)))

    def scan_into(self, collector: Collector) -> List:
        """Cycle + declared-order scan over the recorded graph."""
        with self._mu:
            edges = dict(self._edges)
        ranks: Dict[Site, Optional[Tuple[str, int]]] = {}
        for a, b in edges:
            for s in (a, b):
                if s not in ranks:
                    ranks[s] = self._declared_order(s)
        graph: Dict[Site, Set[Site]] = {}
        out = []
        for (a, b), e in sorted(edges.items(),
                                key=lambda kv: (site_str(kv[0][0]),
                                                site_str(kv[0][1]))):
            ra, rb = ranks.get(a), ranks.get(b)
            if ra and rb and ra[0] == rb[0]:
                if ra[1] < rb[1]:
                    continue  # consistent with the declared order: justified
                f = collector.add(
                    SAN_LOCK_ORDER, e.acq_site,
                    f"declared lock order violated: lock {site_str(b)} "
                    f"(order {rb[1]}) acquired while holding "
                    f"{site_str(a)} (order {ra[1]}, group {ra[0]}) — "
                    "declared ranks must only be taken low-to-high",
                    detail=self._edge_detail(e))
                if f is not None:
                    out.append(f)
                continue
            graph.setdefault(a, set()).add(b)
        out.extend(self._cycle_findings(graph, edges, collector))
        return out

    @staticmethod
    def _edge_detail(e: _EdgeSample, header: str = "") -> str:
        lines = []
        if header:
            lines.append(header)
        lines.append(f"held since {site_str(e.holder_site)}, acquired at "
                     f"{site_str(e.acq_site)} on thread {e.thread!r} "
                     f"(seen {e.count}x); acquisition stack:")
        lines.extend("  " + ln for ln in e.stack)
        return "\n".join(lines)

    def _cycle_findings(self, graph, edges, collector: Collector) -> List:
        out = []
        seen_cycles: Set[frozenset] = set()
        for (a, b) in sorted(edges, key=lambda k: (site_str(k[0]),
                                                   site_str(k[1]))):
            if b not in graph.get(a, ()):  # justified / violation edge
                continue
            path = self._shortest_path(graph, b, a)
            if path is None:
                continue
            cycle = [a] + path  # a -> b -> ... -> a
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            chain = " -> ".join(site_str(s) for s in cycle)
            e = edges[(a, b)]
            # the return edge closing the cycle (last hop back to a) is
            # the "opposite order" the message names
            back = edges.get((path[-2] if len(path) >= 2 else b, a))
            back_at = site_str(back.acq_site) if back else "?"
            msg = (f"potential deadlock: lock-order cycle {chain} — lock "
                   f"{site_str(b)} acquired here while holding "
                   f"{site_str(a)}, and the opposite order was observed "
                   f"at {back_at}; acquire these locks in one global "
                   "order, or declare ranks with `# dtxsan: order(N)`")
            detail_parts = []
            for i in range(len(cycle) - 1):
                ce = edges.get((cycle[i], cycle[i + 1]))
                if ce is not None:
                    detail_parts.append(self._edge_detail(
                        ce, header=f"edge {site_str(cycle[i])} -> "
                                   f"{site_str(cycle[i + 1])}:"))
            f = collector.add(SAN_LOCK_ORDER, e.acq_site, msg,
                              detail="\n".join(detail_parts))
            if f is not None:
                out.append(f)
        return out

    @staticmethod
    def _shortest_path(graph, src: Site, dst: Site) -> Optional[List[Site]]:
        """BFS path src..dst (inclusive); None when unreachable."""
        if src == dst:
            return [src]
        prev: Dict[Site, Site] = {}
        queue = [src]
        seen = {src}
        while queue:
            cur = queue.pop(0)
            for nxt in sorted(graph.get(cur, ()),
                              key=lambda s: site_str(s)):
                if nxt in seen:
                    continue
                prev[nxt] = cur
                if nxt == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                seen.add(nxt)
                queue.append(nxt)
        return None

    # test / forensics helpers
    def edge_count(self) -> int:
        with self._mu:
            return len(self._edges)


LOCK_SANITIZER = LockOrderSanitizer()

__all__: Sequence[str] = ("LOCK_SANITIZER", "LockOrderSanitizer",
                          "LockOrderViolation")
