"""On-demand ``torch.profiler`` capture behind ``POST /debug/profile`` (the
port of ``datatunerx_tpu/obs/profiling.py``, with ``torch.profiler`` in
place of ``jax.profiler``).

The serving server arms a profiler window of N seconds on request over its
own process: CPU activity always, CUDA kernels when a card is present. The
engine labels its ticks with ``torch.profiler.record_function`` ranges
(``dtx_engine_decode``, ``dtx_engine_prefill_chunk``,
``dtx_engine_spec_step``, ``dtx_engine_spec_tree``), so the capture reads
like the scheduler's own timeline. At the window's end a Chrome trace
(``trace.json``) is written into the capture directory; open it in
Perfetto or ``chrome://tracing``.

The window is armed on an HTTP handler thread while the engine ticks on its
scheduler thread. A profiler records ``record_function`` ranges of the
thread that started it only, so the window is opened with Kineto's
``profile_all_threads`` config: every thread's ranges land in the capture,
and the CUDA kernels (which CUPTI sees for the whole process) line up with
them in time. Capturing changes no route: the kernels' wrappers launch the
same kernels with a window open or not.

One capture at a time per process — the profiler is process-global state,
so a second concurrent request is refused (409 at the HTTP layer) rather
than corrupting the active trace.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional

MAX_SECONDS = 120.0
TRACE_FILE = "trace.json"


def resolve_profile_dir(requested: Optional[str] = None) -> str:
    """Resolve a capture directory, confined under the allowed root.

    /debug/profile is unauthenticated on the serving port (like /admin/*,
    it trusts the operator network) — but a requested ``dir`` must not turn
    into arbitrary filesystem writes. Paths resolve under the root
    (``DTX_PROFILE_DIR``, default the system tempdir): relative requests
    join it, absolute requests must already lie inside it; anything
    escaping raises ValueError (a client error, not a server fault).
    No request → a fresh ``dtx-profile-*`` tempdir under the root."""
    base = os.path.realpath(
        os.environ.get("DTX_PROFILE_DIR") or tempfile.gettempdir())
    if not requested:
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(prefix="dtx-profile-", dir=base)
    path = os.path.realpath(os.path.join(base, requested))
    if path != base and not path.startswith(base + os.sep):
        raise ValueError(
            f"profile dir {requested!r} escapes the allowed root {base!r} "
            "(set DTX_PROFILE_DIR to change it)")
    return path


def _open_profiler():
    """A started ``torch.profiler.profile`` over every thread of the
    process: CPU activity, plus CUDA when a card is visible."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    return prof


class Profiler:
    """One-at-a-time background profiler window. ``start`` returns the
    EFFECTIVE window length (the request clamped to [0.05, MAX_SECONDS] —
    callers echo this, not the raw request, so an operator never waits on
    a 600s window that actually stopped at 120), or None when a capture is
    already running; the worker thread stops the capture after the window
    elapses (or earlier on ``close``) and writes ``<dir>/trace.json``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Optional[dict] = None
        self._cancel = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the last finished window: {"dir", "trace", "seconds"} or with
        # "error" when the stop or the export failed
        self.last: Optional[dict] = None

    def start(self, log_dir: str, seconds: float) -> Optional[float]:
        seconds = min(max(float(seconds), 0.05), MAX_SECONDS)
        with self._lock:
            if self._active is not None:
                return None
            self._active = {"dir": log_dir, "seconds": seconds,
                            "started": time.time()}
            self._cancel.clear()
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = _open_profiler()
        except Exception:
            with self._lock:
                self._active = None
            raise
        self._thread = threading.Thread(
            target=self._window, args=(prof, log_dir, seconds),
            name="dtx-profile-window", daemon=True)
        self._thread.start()
        return seconds

    def _window(self, prof, log_dir: str, seconds: float):
        self._cancel.wait(timeout=seconds)
        done = {"dir": log_dir, "seconds": seconds}
        try:
            prof.stop()
            path = os.path.join(log_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
            done["trace"] = path
        except Exception as e:  # noqa: BLE001 — a failed stop leaks no state
            done["error"] = repr(e)
        with self._lock:
            self.last = done
            self._active = None

    def status(self) -> Optional[dict]:
        with self._lock:
            return dict(self._active) if self._active else None

    def wait(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Join the running window (if any) and return the last finished
        one's record."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        with self._lock:
            return dict(self.last) if self.last else None

    def close(self):
        """Cancel an in-flight window and join the worker (shutdown path)."""
        self._cancel.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None


_PROFILER = Profiler()


def process_profiler() -> Profiler:
    """The process-wide profiler (the torch profiler is process-global)."""
    return _PROFILER
