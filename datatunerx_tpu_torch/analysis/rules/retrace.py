"""DTX002: compile or capture in a loop. DTX008: CUDA work at import.

DTX002 — ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` /
``torch.cuda.make_graphed_callables`` evaluated inside a ``for``/``while``
body builds a fresh wrapper (an empty compile cache) per iteration, and a
``torch.cuda.graph(g)`` capture entered in a loop records the graph anew
each time: a recompile or recapture storm that looks like "GPU slow" rather
than an error. The port compiles nothing and captures no graph today, so
the rule finds nothing in it: it guards the CUDA-graph and compile work the
ROADMAP queues. (The reference's second DTX002 check, unstable
``static_argnums``, has no PyTorch construct to check.)

DTX008 — CUDA work executed at module top level (module body, class body,
or a function's DEFAULT ARGUMENT) runs at import: a ``torch.*(...,
device="cuda")`` factory, ``.cuda()``, ``.to("cuda")``, a
``torch.cuda.*`` call that touches the device, or a load of the kernel
library through ``ops/_build.py``. It creates the CUDA context before the
program can pick its device (breaks ``CUDA_VISIBLE_DEVICES`` choices made
after import, forks and the CPU test suite) and allocates on whichever
card import happened to land on. Hoist into a function or compute lazily.
``torch.compile(fn)`` at module level is fine — building a wrapper is
host-only; dtype attributes (``torch.bfloat16``) are data, not work.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

COMPILE_NAMES = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                 "torch.cuda.make_graphed_callables")
CAPTURE_NAMES = ("torch.cuda.graph", "torch.cuda.graphs.graph")
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


class _LoopVisitor(ast.NodeVisitor):
    """Tracks loop depth; function scopes reset it (their bodies run when
    called, not where defined), but decorators and default args evaluate
    in the enclosing scope and keep the current depth."""

    def __init__(self, rule: "JitInLoop", ctx: ModuleContext):
        self.rule = rule
        self.ctx = ctx
        self.out: List[Finding] = []
        self.depth = 0

    def _visit_loop(self, node):
        for header in ("iter", "test"):  # evaluated once, outside the body
            expr = getattr(node, header, None)
            if expr is not None:
                self.visit(expr)
        self.depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.depth -= 1

    visit_For = visit_AsyncFor = visit_While = _visit_loop

    def _visit_scope(self, node):
        for dec in getattr(node, "decorator_list", []):
            self.visit(dec)
        if isinstance(node, _FUNC_NODES):
            for default in node.args.defaults + node.args.kw_defaults:
                if default is not None:
                    self.visit(default)
        saved, self.depth = self.depth, 0
        for stmt in node.body:
            self.visit(stmt)
        self.depth = saved

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _visit_scope

    def visit_Call(self, node: ast.Call):
        resolved = self.ctx.resolve(node.func)
        if self.depth > 0 and resolved in COMPILE_NAMES + CAPTURE_NAMES:
            self.out.append(self.rule.finding(
                self.ctx, node,
                f"{resolved}() evaluated inside a loop compiles or captures "
                "afresh every iteration (an empty compile cache, a new "
                "graph) — hoist it out of the loop"))
        self.generic_visit(node)


class JitInLoop(Rule):
    id = "DTX002"
    name = "compile-in-loop"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        visitor = _LoopVisitor(self, ctx)
        visitor.visit(ctx.tree)
        return visitor.out


_BUILD_LIBRARY = "datatunerx_tpu_torch.ops._build.library"
# torch.cuda calls that read no device state and create no context
_CUDA_QUERIES = {"torch.cuda.is_available", "torch.cuda.is_initialized",
                 "torch.cuda.device_count"}


def _cuda_device(node: ast.AST) -> bool:
    """True for ``"cuda"``/``"cuda:N"`` and ``torch.device("cuda...")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cuda" or node.value.startswith("cuda:")
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device" and bool(node.args)
            and _cuda_device(node.args[0]))


def device_work_label(ctx: ModuleContext, node: ast.Call) -> Optional[str]:
    """What a call does on the card, when it does anything there."""
    resolved = ctx.resolve(node.func)
    if resolved == _BUILD_LIBRARY:
        return f"{resolved}()"
    if resolved and resolved.startswith("torch.cuda.") \
            and resolved not in _CUDA_QUERIES:
        return f"{resolved}()"
    if resolved and resolved.startswith("torch.") and any(
            kw.arg == "device" and _cuda_device(kw.value)
            for kw in node.keywords):
        return f'{resolved}(device="cuda")'
    if isinstance(node.func, ast.Attribute):
        if node.func.attr == "cuda":
            return ".cuda()"
        if node.func.attr == "to":
            targets = list(node.args[:1]) + [kw.value for kw in node.keywords
                                             if kw.arg == "device"]
            if any(_cuda_device(t) for t in targets):
                return '.to("cuda")'
    return None


class ModuleImportDeviceWork(Rule):
    id = "DTX008"
    name = "module-import-device-work"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        self._scan_body(ctx, ctx.tree.body, out, where="module import")
        return out

    def _scan_body(self, ctx, body, out, where: str):
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                self._scan_body(ctx, stmt.body, out,
                                where="class body (import time)")
                continue
            if isinstance(stmt, _FUNC_NODES):
                # default args evaluate at import; bodies do not
                for default in stmt.args.defaults + stmt.args.kw_defaults:
                    if default is not None:
                        self._scan_expr(ctx, default, out,
                                        where="function default argument")
                for dec in stmt.decorator_list:
                    self._scan_expr(ctx, dec, out, where="decorator")
                continue
            self._scan_expr(ctx, stmt, out, where=where)

    def _scan_expr(self, ctx, root, out, where: str):
        stack = [root]
        while stack:
            node = stack.pop()
            # lambda/def bodies run when called, not at import
            if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Call):
                continue
            label = device_work_label(ctx, node)
            if label is None:
                continue
            out.append(self.finding(
                ctx, node,
                f"{label} runs at {where}: CUDA work during import creates "
                "the CUDA context early and allocates before the device is "
                "chosen — hoist it into a function or compute it lazily"))
