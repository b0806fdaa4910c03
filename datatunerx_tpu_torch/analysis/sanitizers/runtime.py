"""Shared dtxsan plumbing: finding collection, site capture, suppressions.

Findings reuse ``analysis.core.Finding`` so the dtxlint baseline module
(`analysis/baseline.py`) partitions them unchanged; the extra runtime
evidence (acquisition stacks, leaked-thread stacks, compile sites) rides
in a parallel ``detail`` string keyed by the finding, because a frozen
Finding stays the stable (rule, path, message) identity the baseline and
the JSON contract key on.

Rule ids: SAN001 lock-order, SAN002 thread-leak, SAN003 compile-budget.

Inline suppression mirrors dtxlint's: ``# dtxsan: disable=SAN001`` on
the line a finding anchors to (the acquisition site, the spawn site, the
``with compile_budget`` line) silences it — with a reason in the
comment, per the empty-baseline policy.
"""

from __future__ import annotations

import linecache
import os
import re
import sys
import threading
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from datatunerx_tpu_torch.analysis.core import Finding

SAN_LOCK_ORDER = "SAN001"
SAN_THREAD_LEAK = "SAN002"
SAN_COMPILE_BUDGET = "SAN003"

_SUPPRESS_RE = re.compile(r"#\s*dtxsan:\s*disable=([A-Za-z0-9_,\s]+)")

# the repository root every finding path is made relative to — the package
# lives at <root>/datatunerx_tpu_torch/analysis/sanitizers
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# frames belonging to the sanitizer machinery or the interpreter's own
# locking layers are never "the" acquisition site
_SKIP_FILE_TOKENS = (
    os.sep + "sanitizers" + os.sep,
    os.sep + "threading.py",
    os.sep + "queue.py",
    os.sep + "concurrent" + os.sep + "futures" + os.sep,
    os.sep + "socketserver.py",
    os.sep + "logging" + os.sep,
)


def display_path(path: str) -> str:
    """Repo-root-relative, /-normalized — finding identity must not depend
    on the invoking cwd (same contract as dtxlint's _display_path)."""
    ap = os.path.abspath(path)
    try:
        rel = os.path.relpath(ap, REPO_ROOT)
    except ValueError:
        return path.replace(os.sep, "/")
    if rel.startswith(".."):
        return path.replace(os.sep, "/")
    return rel.replace(os.sep, "/")


def _skippable(filename: str) -> bool:
    return any(tok in filename for tok in _SKIP_FILE_TOKENS)


def user_site(extra_skip: int = 0) -> Tuple[str, int]:
    """(abs file, line) of the nearest caller frame outside the sanitizer
    machinery and the stdlib locking layers. Cheap: sys._getframe walk,
    no stack object materialization."""
    try:
        frame = sys._getframe(2 + extra_skip)
    except ValueError:
        return ("<unknown>", 0)
    while frame is not None:
        fn = frame.f_code.co_filename
        if not _skippable(fn):
            return (fn, frame.f_lineno)
        frame = frame.f_back
    return ("<unknown>", 0)


def capture_stack(limit: int = 14) -> List[str]:
    """Trimmed human-readable stack of the CURRENT thread, innermost last,
    sanitizer/locking frames dropped. Only called on rare events (a new
    lock-order edge, a leak, a budget breach), never per acquisition."""
    out: List[str] = []
    for fr in traceback.extract_stack()[:-1]:
        if _skippable(fr.filename):
            continue
        out.append(f"{display_path(fr.filename)}:{fr.lineno} in {fr.name}"
                   + (f"\n    {fr.line}" if fr.line else ""))
    return out[-limit:]


def site_str(site: Tuple[str, int]) -> str:
    return f"{display_path(site[0])}:{site[1]}"


def suppressed_at(site: Tuple[str, int], rule: str) -> bool:
    """True when the source line at ``site`` carries an inline
    ``# dtxsan: disable=`` naming ``rule`` (or ``all``)."""
    path, line = site
    if not path or path.startswith("<") or line <= 0:
        return False
    text = linecache.getline(path, line)
    m = _SUPPRESS_RE.search(text)
    if not m:
        return False
    ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return "all" in ids or rule in ids


@dataclass
class SanFinding:
    """One runtime finding + its side-band evidence."""

    finding: Finding
    detail: str = ""


@dataclass
class Collector:
    """Process-global accumulation point all three sanitizers feed.

    ``add`` applies inline suppression at the anchoring site, so what the
    collector holds is already the post-suppression set (matching the
    dtxlint pipeline where suppression happens before baseline)."""

    findings: List[SanFinding] = field(default_factory=list)
    suppressed: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                repr=False)

    def add(self, rule: str, site: Tuple[str, int], message: str,
            detail: str = "", severity: str = "error") -> Optional[Finding]:
        """Record (or suppress) one finding anchored at ``site``; returns
        the Finding when it was kept."""
        if suppressed_at(site, rule):
            with self._mu:
                self.suppressed += 1
            return None
        f = Finding(rule, display_path(site[0]), site[1], 0, message,
                    severity)
        with self._mu:
            # idempotent re-runs (finalize called twice, or a leak seen by
            # both the per-test audit and the session sweep) must not
            # double-report one fact
            if any(sf.finding.key() == f.key()
                   and sf.finding.line == f.line
                   for sf in self.findings):
                return None
            self.findings.append(SanFinding(f, detail))
        return f

    def snapshot(self) -> Tuple[List[SanFinding], int]:
        with self._mu:
            return list(self.findings), self.suppressed

    def reset(self):
        with self._mu:
            self.findings.clear()
            self.suppressed = 0


COLLECTOR = Collector()

_VALID_CLASSES = ("lock", "thread", "compile")
_active: Tuple[str, ...] = ()


def parse_classes(spec: str) -> Tuple[str, ...]:
    """DTX_SAN / DTX_TORCH_SAN value → sanitizer classes. "1"/"all"/"on" =
    everything."""
    spec = (spec or "").strip().lower()
    if not spec or spec in ("0", "off", "false"):
        return ()
    if spec in ("1", "all", "on", "true", "yes"):
        return _VALID_CLASSES
    out = tuple(tok.strip() for tok in spec.split(",")
                if tok.strip() in _VALID_CLASSES)
    return out


def active_classes() -> Tuple[str, ...]:
    return _active


def install_from_env(env: Optional[str] = None) -> Tuple[str, ...]:
    """Install the sanitizers ``env`` names (default: the DTX_SAN
    variable; idempotent); returns the active class tuple. The global
    singletons in lockorder/threads/compile are used, so a whole process
    shares one graph/registry."""
    global _active
    classes = parse_classes(
        env if env is not None else os.environ.get("DTX_SAN", ""))
    if not classes:
        return _active
    if "lock" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.lockorder import LOCK_SANITIZER

        LOCK_SANITIZER.install()
    if "thread" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.threads import THREAD_SANITIZER

        THREAD_SANITIZER.install()
    if "compile" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import COMPILE_SANITIZER

        COMPILE_SANITIZER.install()
    _active = tuple(dict.fromkeys(_active + classes))
    return _active


def uninstall(classes: Sequence[str]) -> Tuple[str, ...]:
    """Take the named sanitizers out again (``threading.Lock``, the thread
    start hook and the build counters back as they were), so a bracket
    such as a replay leaves the process as it found it; returns the
    classes still active. Findings stay in the collector."""
    global _active
    if "lock" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.lockorder import LOCK_SANITIZER

        LOCK_SANITIZER.uninstall()
    if "thread" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.threads import THREAD_SANITIZER

        THREAD_SANITIZER.uninstall()
    if "compile" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import COMPILE_SANITIZER

        COMPILE_SANITIZER.uninstall()
    _active = tuple(c for c in _active if c not in classes)
    return _active


def finalize(collector: Optional[Collector] = None) -> List[SanFinding]:
    """Run the end-of-session scans (lock-order cycles, module compile
    budgets) into the collector and return everything gathered. Safe to
    call more than once — the collector dedupes."""
    col = collector or COLLECTOR
    if "lock" in _active:
        from datatunerx_tpu_torch.analysis.sanitizers.lockorder import LOCK_SANITIZER

        LOCK_SANITIZER.scan_into(col)
    if "compile" in _active:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import COMPILE_SANITIZER

        COMPILE_SANITIZER.scan_into(col)
    findings, _ = col.snapshot()
    return findings


@dataclass
class Window:
    """A sanitized stretch of a run (a replay, a smoke phase): the classes
    active in it, those it installed itself, the threads alive at its
    start and the build count there."""

    classes: Tuple[str, ...]
    installed: Tuple[str, ...]
    threads: set
    builds: int = 0


def open_window(spec: str) -> Optional[Window]:
    """Install the sanitizers ``spec`` (a DTX_SAN value) names, beside any
    already active; None when ``spec`` names none."""
    if not parse_classes(spec):
        return None
    already = _active
    classes = install_from_env(spec)
    builds = 0
    if "compile" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import COMPILE_SANITIZER

        builds = COMPILE_SANITIZER.counts()["builds"]
    return Window(classes, tuple(c for c in classes if c not in already),
                  set(threading.enumerate()), builds)


def close_window(win: Window, testid: str,
                 collector: Optional[Collector] = None
                 ) -> Tuple[List[SanFinding], int, Dict[str, int]]:
    """The sweep at the end of ``win``: lock-order cycles, module build
    budgets, the repo threads started in it and still alive; then the
    classes it installed come out again (those a caller had installed
    stay). Returns (findings, suppressed, build counters, with
    ``window_builds`` the builds since the window opened)."""
    col = collector or COLLECTOR
    counters: Dict[str, int] = {}
    try:
        finalize(col)
        if "thread" in win.classes:
            from datatunerx_tpu_torch.analysis.sanitizers.threads import THREAD_SANITIZER

            if THREAD_SANITIZER.installed:
                THREAD_SANITIZER.audit(win.threads, col, testid=testid)
        if "compile" in win.classes:
            from datatunerx_tpu_torch.analysis.sanitizers.compile import COMPILE_SANITIZER

            counters = COMPILE_SANITIZER.counts()
            counters["window_builds"] = counters["builds"] - win.builds
        findings, suppressed = col.snapshot()
    finally:
        uninstall(win.installed)
    return findings, suppressed, counters


def render(sf: SanFinding, with_detail: bool = True) -> str:
    text = sf.finding.render()
    if with_detail and sf.detail:
        text += "\n" + "\n".join("    " + ln
                                 for ln in sf.detail.splitlines())
    return text


__all__: Sequence[str] = (
    "COLLECTOR", "Collector", "SanFinding", "SAN_LOCK_ORDER",
    "SAN_THREAD_LEAK", "SAN_COMPILE_BUDGET", "REPO_ROOT",
    "active_classes", "capture_stack", "display_path", "finalize",
    "Window", "close_window", "install_from_env", "open_window",
    "parse_classes", "render", "site_str", "suppressed_at", "uninstall",
    "user_site",
)


def _fresh_collector() -> Collector:  # test helper
    return Collector()


def details_by_key(findings: List[SanFinding]) -> Dict[str, str]:
    """finding-render → detail map for the JSON report."""
    return {sf.finding.render(): sf.detail for sf in findings if sf.detail}
