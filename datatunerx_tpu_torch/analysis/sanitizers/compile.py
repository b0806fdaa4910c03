"""SAN003 — the compile-budget sanitizer, counting what the port builds.

The reference counts XLA lowerings. The port lowers nothing: what it
compiles at run time is

  * the CUDA kernel library (``ops/_build._build``: one ``nvcc`` per
    ``csrc/*.cu`` and a link — seconds to minutes, once per source digest);
  * the native packer (``native._build``: one ``g++``);
  * anything ``torch.compile`` compiles, if the port ever uses it (each
    dynamo frame compile).

Each build is one event, recorded with the repo frame that asked for it
(the kernel wrapper or loader that needed the library, not the build
helper), and budgets are enforced as in the reference:

  * ``with compile_budget(n):`` — the block may trigger at most ``n``
    builds; a breach raises :class:`CompileBudgetExceeded` naming every
    build site seen inside the window, and records a SAN003 finding
    anchored at the ``with`` line. ``compile_budget(0)`` turns "a warmed
    server builds nothing more" into a hard error.
  * ``register_module_budget("path/substr", n)`` — bounds the total
    builds attributed to sites in matching files over a whole run;
    checked by ``scan_into`` at session finish (the pytest plugin reads
    ``DTX_SAN_MODULE_BUDGETS=path=count,...``).

``install`` wraps the two build functions (``uninstall`` restores them)
and registers a dynamo compile-start callback once ``torch._dynamo`` is
loaded (``torch.compile`` is wrapped to register it on first use, so an
install never imports dynamo itself).
"""

from __future__ import annotations

import _thread
import functools
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from datatunerx_tpu_torch.analysis.sanitizers import runtime
from datatunerx_tpu_torch.analysis.sanitizers.runtime import (
    REPO_ROOT,
    SAN_COMPILE_BUDGET,
    Collector,
    _skippable,
    site_str,
    user_site,
)

Site = Tuple[str, int]

KINDS = ("kernel_builds", "native_builds", "torch_compiles")
# the build helpers themselves are never "the" site that asked for a build
_BUILDER_FILES = ("ops/_build.py", "native/__init__.py")


class CompileBudgetExceeded(RuntimeError):
    """A ``compile_budget`` window saw more builds than declared."""


def _repo_site() -> Site:
    """First frame under the repo root (excluding sanitizer machinery and
    the build helpers) — the repo code that triggered this build;
    ("<torch-internal>", 0) when the build never passed through repo code."""
    try:
        frame = sys._getframe(2)
    except ValueError:
        return ("<torch-internal>", 0)
    while frame is not None:
        fn = frame.f_code.co_filename
        if fn.startswith(REPO_ROOT) and not _skippable(fn) \
                and not fn.replace("\\", "/").endswith(_BUILDER_FILES):
            return (fn, frame.f_lineno)
        frame = frame.f_back
    return ("<torch-internal>", 0)


class CompileSanitizer:
    def __init__(self):
        self.installed = False
        self.enabled = False
        self._mu = _thread.allocate_lock()
        self._counts: Dict[str, int] = dict.fromkeys(KINDS, 0)
        # one site per build, in order, for budget-window slicing
        self._events: List[Site] = []
        self._site_counts: Dict[Site, int] = {}
        self._module_budgets: Dict[str, int] = {}
        self._patched: List[Tuple[object, str, object]] = []
        self._dynamo_hooked = False

    # ------------------------------------------------------------ events
    def record(self, kind: str):
        """One build of ``kind`` happened now (called by the wrappers)."""
        if not self.enabled:
            return
        site = _repo_site()
        with self._mu:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._events.append(site)
            self._site_counts[site] = self._site_counts.get(site, 0) + 1

    def _wrap(self, module, attr: str, kind: str):
        orig = getattr(module, attr)
        san = self

        @functools.wraps(orig)
        def counted(*a, **kw):
            san.record(kind)
            return orig(*a, **kw)

        setattr(module, attr, counted)
        self._patched.append((module, attr, orig))

    def _hook_dynamo(self):
        if self._dynamo_hooked or "torch._dynamo" not in sys.modules:
            return
        try:
            from torch._dynamo.callback import callback_handler
        except Exception:  # pragma: no cover - layout of another torch
            return
        callback_handler.register_start_callback(
            lambda *a, **kw: self.record("torch_compiles"))
        self._dynamo_hooked = True

    # ------------------------------------------------------------ install
    def install(self):
        self.enabled = True
        if self.installed:
            return
        import torch

        from datatunerx_tpu_torch import native
        from datatunerx_tpu_torch.ops import _build

        self._wrap(_build, "_build", "kernel_builds")
        self._wrap(native, "_build", "native_builds")
        orig_compile = torch.compile
        san = self

        @functools.wraps(orig_compile)
        def compile_hooked(*a, **kw):
            out = orig_compile(*a, **kw)
            san._hook_dynamo()  # dynamo is loaded once compile ran
            return out

        torch.compile = compile_hooked
        self._patched.append((torch, "compile", orig_compile))
        self._hook_dynamo()
        self.installed = True

    def uninstall(self):
        """Restore the wrapped functions; the dynamo callback (which has no
        per-listener removal here) stays registered but goes inert."""
        self.enabled = False
        for module, attr, orig in reversed(self._patched):
            setattr(module, attr, orig)
        self._patched.clear()
        self.installed = False

    def reset(self):
        with self._mu:
            self._counts = dict.fromkeys(KINDS, 0)
            self._events.clear()
            self._site_counts.clear()

    # ------------------------------------------------------------ queries
    def counts(self) -> Dict[str, int]:
        with self._mu:
            out = dict(self._counts)
        out["builds"] = sum(out[k] for k in KINDS)
        return out

    def event_index(self) -> int:
        with self._mu:
            return len(self._events)

    def events_since(self, index: int) -> List[Site]:
        with self._mu:
            return list(self._events[index:])

    # ------------------------------------------------------------ budgets
    def register_module_budget(self, path_substr: str, budget: int):
        with self._mu:
            self._module_budgets[path_substr] = int(budget)

    def scan_into(self, collector: Collector) -> List:
        out = []
        with self._mu:
            budgets = dict(self._module_budgets)
            counts = dict(self._site_counts)
        for substr, budget in sorted(budgets.items()):
            hits = {s: n for s, n in counts.items()
                    if substr in s[0].replace("\\", "/")}
            total = sum(hits.values())
            if total <= budget:
                continue
            top = sorted(hits.items(), key=lambda kv: (-kv[1],
                                                       site_str(kv[0])))[:6]
            sites = ", ".join(f"{site_str(s)} ({n}x)" for s, n in top)
            f = collector.add(
                SAN_COMPILE_BUDGET, (substr, 1),
                f"module compile budget exceeded: {total} builds "
                f"attributed to '{substr}' (budget {budget}) — top sites: "
                f"{sites}",
                detail="per-site counts: "
                       + "; ".join(f"{site_str(s)}={n}"
                                   for s, n in sorted(
                                       hits.items(),
                                       key=lambda kv: site_str(kv[0]))))
            if f is not None:
                out.append(f)
        return out


COMPILE_SANITIZER = CompileSanitizer()


class compile_budget:
    """``with compile_budget(n, "label"):`` — assert at most ``n`` builds
    (kernel library, native packer, torch.compile) happen inside the
    block. Installs the build counters on first use, so it works
    standalone (no DTX_SAN needed). A breach records a SAN003 finding at
    the ``with`` line and raises :class:`CompileBudgetExceeded` (suppress
    with ``# dtxsan: disable=SAN003`` on that line, or pass
    ``raise_on_exceed=False`` to only record)."""

    def __init__(self, budget: int, label: str = "",
                 raise_on_exceed: bool = True,
                 collector: Optional[Collector] = None):
        self.budget = int(budget)
        self.label = label
        self.raise_on_exceed = raise_on_exceed
        self.collector = collector
        self.seen = 0
        self.sites: List[Site] = []
        self._start = 0
        self._site: Site = ("<unknown>", 0)

    def __enter__(self) -> "compile_budget":
        COMPILE_SANITIZER.install()
        self._site = user_site()
        self._start = COMPILE_SANITIZER.event_index()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.sites = COMPILE_SANITIZER.events_since(self._start)
        self.seen = len(self.sites)
        if exc_type is not None or self.seen <= self.budget:
            return False
        counts: Dict[Site, int] = {}
        for s in self.sites:
            counts[s] = counts.get(s, 0) + 1
        top = sorted(counts.items(), key=lambda kv: (-kv[1],
                                                     site_str(kv[0])))[:6]
        sites = ", ".join(f"{site_str(s)} ({n}x)" for s, n in top)
        what = f" [{self.label}]" if self.label else ""
        msg = (f"compile budget exceeded{what}: {self.seen} builds inside "
               f"a compile_budget({self.budget}) window — build sites: "
               f"{sites}")
        col = self.collector or runtime.COLLECTOR
        f = col.add(SAN_COMPILE_BUDGET, self._site, msg,
                    detail="each site is the nearest repo frame on the "
                           "stack when a kernel library, the native packer "
                           "or a torch.compile frame was built")
        if f is not None and self.raise_on_exceed:
            raise CompileBudgetExceeded(msg)
        return False


def register_module_budget(path_substr: str, budget: int):
    """Bound total builds attributed to files matching ``path_substr``
    across the whole run (checked at session finish)."""
    COMPILE_SANITIZER.install()
    COMPILE_SANITIZER.register_module_budget(path_substr, budget)


__all__: Sequence[str] = ("COMPILE_SANITIZER", "CompileSanitizer",
                          "CompileBudgetExceeded", "KINDS",
                          "compile_budget", "register_module_budget")
