"""DTX001: host-synchronizing calls inside hot-path functions.

A ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` / ``.to("cpu")``
/ ``float(t)`` / ``np.asarray(t)`` / ``torch.cuda.synchronize()`` /
``Event.synchronize()`` inside the step loop blocks the host until the
card's stream drains, every step: the launch queue runs dry and the card
idles while the host catches up — silent, and worth double-digit % of step
time.

"Hot path" = any function whose bare name matches a configured
``hot-functions`` pattern, plus any code inside a ``# dtxlint: hot-begin``
/ ``# dtxlint: hot-end`` region, plus everything reachable from either
through the call graph (call, reference, and nesting edges). With the
program graph on (the default for ``dtx-torch lint``), reachability
crosses module boundaries — this per-module rule is then replaced by the
program-level pass in ``analysis/program.py``, which reuses the helpers
here.

Not flagged: ``float()``/``int()``/``bool()`` of plain constants (unit
conversion, argument parsing) — only conversions of computed values can
sync.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from datatunerx_tpu_torch.analysis.callgraph import walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

# dotted names that force a device→host transfer / stream sync
_SYNC_CALLS = {
    "numpy.asarray": "np.asarray",
    "numpy.array": "np.array",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}
# method names with the same effect regardless of receiver
# (``synchronize`` covers torch.cuda.Event/Stream)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _cpu_target(node: ast.AST) -> bool:
    """True for ``"cpu"`` and ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device" and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def sync_label(ctx: ModuleContext, node: ast.Call) -> str:
    """Human label when ``node`` is a host-sync call, else ''. Shared by
    the per-module rule, the program-level pass, and DTX009."""
    func = node.func
    # float(t)/int(t)/bool(t) of a computed value
    if isinstance(func, ast.Name) and func.id in ("float", "int", "bool"):
        if node.args and not isinstance(node.args[0], ast.Constant):
            return f"{func.id}() on a device value"
        return ""
    resolved = ctx.resolve(func)
    if resolved in _SYNC_CALLS:
        return f"{_SYNC_CALLS[resolved]}()"
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
        return f".{func.attr}()"
    if isinstance(func, ast.Attribute) and func.attr == "to":
        targets = list(node.args[:1]) + [kw.value for kw in node.keywords
                                         if kw.arg == "device"]
        if any(_cpu_target(t) for t in targets):
            return '.to("cpu")'
    return ""


def hot_roots(ctx: ModuleContext) -> Set[str]:
    """Module-local hot roots: functions matching a hot-functions pattern,
    functions DEFINED inside a hot region, and local targets of calls made
    from inside a hot region (at module import time or within any
    function)."""
    graph = ctx.graph
    roots = set(graph.reachable(tuple(ctx.config.hot_functions)))
    if not ctx.hot_regions:
        return roots
    for qualname, info in graph.functions.items():
        if ctx.in_hot_region(info.lineno):
            roots.add(qualname)
    for caller, sites in graph.edge_sites.items():
        for target, line in sites:
            if ctx.in_hot_region(line):
                roots.add(target)
    for target, line in graph.module_sites:
        if ctx.in_hot_region(line):
            roots.add(target)
    return roots


def region_sync_findings(rule: Rule, ctx: ModuleContext,
                         hot: Set[str]) -> List[Tuple[ast.Call, str, str]]:
    """(call node, label, where) for sync calls lexically inside a hot
    region but NOT already covered by a hot function in ``hot`` — so a
    marked step loop inside an otherwise-cold ``main`` still flags."""
    out: List[Tuple[ast.Call, str, str]] = []
    if not ctx.hot_regions:
        return out
    covered_spans = []
    for qualname in hot:
        info = ctx.graph.functions.get(qualname)
        if info is not None:
            covered_spans.append(
                (info.lineno, getattr(info.node, "end_lineno", info.lineno),
                 qualname))
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not ctx.in_hot_region(node.lineno):
            continue
        if any(s <= node.lineno <= e for s, e, _ in covered_spans):
            continue
        label = sync_label(ctx, node)
        if label:
            out.append((node, label, "a `# dtxlint: hot-begin` region"))
    return out


class HostSyncInHotPath(Rule):
    id = "DTX001"
    name = "host-sync-in-hot-path"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        hot = ctx.graph.reachable_from(hot_roots(ctx))
        for qualname in sorted(hot):
            info = ctx.graph.functions[qualname]
            for node in walk_function(info.node):
                if not isinstance(node, ast.Call):
                    continue
                label = sync_label(ctx, node)
                if label:
                    out.append(self.finding(
                        ctx, node,
                        f"{label} in hot path "
                        f"({qualname} is reachable from a hot function); "
                        "this blocks the host on the device stream every "
                        "step — move it behind a logging boundary or use "
                        "MetricsBuffer"))
        for node, label, where in region_sync_findings(self, ctx, hot):
            out.append(self.finding(
                ctx, node,
                f"{label} in hot path (inside {where}); this blocks the "
                "host on the device stream every step — move it behind a "
                "logging boundary or use MetricsBuffer"))
        return out
