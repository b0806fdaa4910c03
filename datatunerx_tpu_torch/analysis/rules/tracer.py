"""DTX003: Python control flow on tensor values inside compiled functions.

``if torch.any(mask):`` inside a ``torch.compile``d function asks for the
truth value of a tensor: dynamo breaks the graph there (a host sync and a
second graph, every call) or installs a value guard that recompiles when
the branch flips; under ``torch.jit.script`` the branch is scripted, but a
``torch.jit.trace`` of the same code bakes in whichever branch the example
took. The fix is ``torch.where`` (or ``torch.cond``).

Detection: a function is "compiled" when decorated with ``torch.compile``
or ``torch.jit.script`` (bare, called, or via ``functools.partial``), or
when the module wraps it by name — ``g = torch.compile(f)``. Inside such
functions, an ``if``/``while`` whose TEST contains a ``torch.*`` tensor
CALL is flagged. Attribute-only tests (``x.ndim``, ``x.shape[0]``,
``x.dtype``) are static under compilation and stay allowed, as are the
predicates that read no tensor (``torch.is_tensor``,
``torch.cuda.is_available``, ...). The port compiles nothing today, so
the rule finds nothing in it: it guards the compile work the ROADMAP
queues.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from datatunerx_tpu_torch.analysis.callgraph import walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

_COMPILE_NAMES = ("torch.compile", "torch.jit.script")
# torch namespaces whose calls answer from host state, not a tensor's value
_HOST_PREFIXES = ("torch.cuda.", "torch.jit.", "torch.compiler.",
                  "torch.distributed.", "torch.backends.", "torch.is_",
                  "torch.are_", "torch.get_")


def _is_compile_expr(ctx: ModuleContext, node: ast.AST) -> bool:
    """True for ``torch.compile``, ``torch.compile(...)``,
    ``partial(torch.compile, ...)`` (and torch.jit.script alike)."""
    if ctx.resolve(node) in _COMPILE_NAMES:
        return True
    if isinstance(node, ast.Call):
        if ctx.resolve(node.func) in _COMPILE_NAMES:
            return True
        if ctx.resolve(node.func) == "functools.partial" and node.args \
                and ctx.resolve(node.args[0]) in _COMPILE_NAMES:
            return True
    return False


class TracerControlFlow(Rule):
    id = "DTX003"
    name = "tensor-control-flow"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for qualname in sorted(self._compiled(ctx)):
            info = ctx.graph.functions[qualname]
            for node in walk_function(info.node, include_nested=True):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                traced = self._tensor_call_in(ctx, node.test)
                if traced:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    out.append(self.finding(
                        ctx, node,
                        f"Python `{kind}` on the tensor value "
                        f"{traced}(...) inside compiled {qualname}: use "
                        "torch.where or torch.cond — a tensor's truth value "
                        "breaks the graph (a host sync) or guards a "
                        "recompile"))
        return out

    def _compiled(self, ctx: ModuleContext) -> Set[str]:
        compiled: Set[str] = set()
        for qualname, info in ctx.graph.functions.items():
            for dec in getattr(info.node, "decorator_list", []):
                if _is_compile_expr(ctx, dec):
                    compiled.add(qualname)
        # g = torch.compile(f) / self._fn = torch.compile(self._impl)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and ctx.resolve(node.func) in _COMPILE_NAMES
                    and node.args):
                continue
            target = node.args[0]
            if isinstance(target, ast.Name):
                compiled.update(q for q, i in ctx.graph.functions.items()
                                if i.name == target.id and i.cls is None)
            elif isinstance(target, ast.Attribute) \
                    and isinstance(target.value, ast.Name) \
                    and target.value.id == "self":
                compiled.update(q for q, i in ctx.graph.functions.items()
                                if i.name == target.attr
                                and i.cls is not None)
        return {q for q in compiled if q in ctx.graph.functions}

    def _tensor_call_in(self, ctx: ModuleContext, test: ast.AST) -> str:
        for node in ast.walk(test):
            if isinstance(node, ast.Call):
                resolved = ctx.resolve(node.func)
                if resolved and resolved.startswith("torch.") \
                        and not resolved.startswith(_HOST_PREFIXES):
                    return resolved
        return ""
