"""SAN002 — the thread-leak sanitizer.

``install()`` wraps ``threading.Thread.start`` to record each thread's
spawn site (the nearest non-stdlib caller frame — so for an executor it
names the ``submit()`` call site, not ``concurrent/futures``) plus a
trimmed spawn stack. The pytest plugin snapshots live threads before
each test and calls :meth:`ThreadLeakSanitizer.audit` at teardown: any
thread that appeared during the test and is still alive after a short
grace window is a leak, reported with the spawn site and the recorded
stack so the fix (a ``join`` on close, a stop ``Event``) is obvious.

Threads spawned from outside the repository (a library's internal pool
whose creation never passes through repo code) are counted but only
reported when ``DTX_SAN_FOREIGN=1`` — triage targets our own spawn
sites first. ``DTX_SAN_THREAD_GRACE`` (seconds, default 1.0) tunes the
grace window; ``# dtxsan: disable=SAN002`` on the spawn line suppresses.
"""

from __future__ import annotations

import os
import re
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

from datatunerx_tpu_torch.analysis.core import Finding
from datatunerx_tpu_torch.analysis.sanitizers.runtime import (
    REPO_ROOT,
    SAN_THREAD_LEAK,
    Collector,
    capture_stack,
    site_str,
    user_site,
)

Site = Tuple[str, int]

# "worker-3" and "worker-7" are the same leak; strip trailing thread
# counters so the finding message (and hence its baseline key) is stable
_COUNTER_RE = re.compile(r"[-_]?\d+$")


class _SpawnInfo:
    __slots__ = ("site", "stack", "spawner")

    def __init__(self, site: Site, stack: List[str], spawner: str):
        self.site = site
        self.stack = stack
        self.spawner = spawner


class ThreadLeakSanitizer:
    def __init__(self):
        self.installed = False
        self._orig_start = None
        self._spawns: "weakref.WeakKeyDictionary[threading.Thread, _SpawnInfo]" = (
            weakref.WeakKeyDictionary())

    def install(self):
        if self.installed:
            return
        self._orig_start = threading.Thread.start
        san = self
        orig = self._orig_start

        def tracked_start(thread, *a, **kw):
            san._spawns[thread] = _SpawnInfo(
                user_site(), capture_stack(),
                threading.current_thread().name)
            return orig(thread, *a, **kw)

        threading.Thread.start = tracked_start
        self.installed = True

    def uninstall(self):
        if self.installed and self._orig_start is not None:
            threading.Thread.start = self._orig_start
            self._orig_start = None
        self.installed = False

    def spawn_info(self, thread: threading.Thread) -> Optional[_SpawnInfo]:
        return self._spawns.get(thread)

    # ------------------------------------------------------------- audit
    @staticmethod
    def _grace(default: float = 1.0) -> float:
        try:
            return float(os.environ.get("DTX_SAN_THREAD_GRACE", default))
        except ValueError:
            return default

    @staticmethod
    def _in_repo(site: Site) -> bool:
        return site[0].startswith(REPO_ROOT + os.sep)

    def leaked_since(self, before: Set[threading.Thread],
                     grace: Optional[float] = None
                     ) -> List[threading.Thread]:
        """Threads alive now that were not alive at the snapshot, after
        waiting up to ``grace`` seconds for stragglers to finish."""
        grace = self._grace() if grace is None else grace
        me = threading.current_thread()
        deadline = time.monotonic() + max(0.0, grace)
        while True:
            leaked = [t for t in threading.enumerate()
                      if t not in before and t is not me and t.is_alive()
                      and not getattr(t, "_dtxsan_allowed", False)]
            if not leaked or time.monotonic() >= deadline:
                return leaked
            time.sleep(0.02)

    def audit(self, before: Set[threading.Thread], collector: Collector,
              testid: str = "", grace: Optional[float] = None
              ) -> List[Finding]:
        """Report every thread leaked past ``before``; returns the kept
        (non-suppressed, non-foreign) findings."""
        out: List[Finding] = []
        foreign_ok = os.environ.get("DTX_SAN_FOREIGN", "") == "1"
        for t in self.leaked_since(before, grace):
            info = self._spawns.get(t)
            site = info.site if info else ("<unknown>", 0)
            if info and not self._in_repo(site) and not foreign_ok:
                continue  # library-internal pool; opt in via DTX_SAN_FOREIGN
            base_name = _COUNTER_RE.sub("", t.name) or t.name
            msg = (f"thread leaked: {base_name!r} spawned at "
                   f"{site_str(site)} is still alive at teardown — join it "
                   "on close or give it a stop Event the cleanup sets")
            detail_lines = []
            if testid:
                detail_lines.append(f"first leaked past: {testid}")
            if info:
                detail_lines.append(f"spawned by thread {info.spawner!r}; "
                                    "spawn stack:")
                detail_lines.extend("  " + ln for ln in info.stack)
            f = collector.add(SAN_THREAD_LEAK, site, msg,
                              detail="\n".join(detail_lines))
            if f is not None:
                out.append(f)
        return out


def allow_thread(thread: threading.Thread) -> threading.Thread:
    """Mark one thread as intentionally outliving test teardown (e.g. a
    session-scoped fixture's server thread that a later finalizer joins)."""
    thread._dtxsan_allowed = True
    return thread


THREAD_SANITIZER = ThreadLeakSanitizer()

__all__: Sequence[str] = ("THREAD_SANITIZER", "ThreadLeakSanitizer",
                          "allow_thread")
