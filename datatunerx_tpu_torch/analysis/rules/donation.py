"""DTX010: a CUDA graph's static output read after a later replay.

A captured ``torch.cuda.CUDAGraph`` writes its outputs into the SAME
static buffers on every ``replay()``: a name bound to one of them
(``logits = static_out`` after a replay) aliases the buffer, not the
values, and the next ``g.replay()`` overwrites it in place — exactly as
XLA reuses a donated operand's buffer for an output (the reference's
DTX010). Reading the alias after that replay silently sees the NEXT
step's values. The port captures no graph today, so the rule finds
nothing in it: it guards the CUDA-graph decode work the ROADMAP queues.

Detection, over the module:
  * captures: ``with torch.cuda.graph(G):`` — every name or ``self``
    attribute assigned in the body is one of G's static outputs (G is a
    name or a ``self`` attribute);
  * per function scope, an alias: ``name = OUT`` or ``name = OUT[...]``
    for a static output OUT of G;
  * a later ``G.replay()`` in the same scope, after the alias's
    statement;
  * flag the first LOAD of the alias after that replay — unless the
    name is rebound before the use by a store that DOMINATES it (a
    conditional rebind — ``if fresh: logits = static_out.clone()`` —
    does not clear the un-rebound path). Reading a ``.clone()`` of the
    output, or the output itself, is what a replay loop means to do and
    stays clean.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from datatunerx_tpu_torch.analysis.callgraph import walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

_CAPTURE_NAMES = ("torch.cuda.graph", "torch.cuda.graphs.graph")
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# statement-list fields whose execution is conditional on control flow;
# `finally` bodies always run and are deliberately absent
_COND_ARMS = {
    ast.If: ("body", "orelse"),
    ast.While: ("body", "orelse"),
    ast.For: ("body", "orelse"),
    ast.AsyncFor: ("body", "orelse"),
    ast.Try: ("body", "handlers", "orelse"),
    ast.ExceptHandler: ("body",),
}


def _branch_paths(fn_node: ast.AST) -> Dict[int, Tuple]:
    """id(node) → tuple of (construct id, arm field) conditional arms
    enclosing it within ``fn_node``. A store dominates a load iff the
    store's path is a prefix of the load's — same or enclosing arm."""
    paths: Dict[int, Tuple] = {id(fn_node): ()}

    def visit(node: ast.AST, path: Tuple):
        cond_fields = _COND_ARMS.get(type(node), ())
        for field, value in ast.iter_fields(node):
            arm = path + ((id(node), field),) if field in cond_fields \
                else path
            children = value if isinstance(value, list) else [value]
            for child in children:
                if not isinstance(child, ast.AST):
                    continue
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # separate frame; walk_function skips it too
                paths[id(child)] = arm
                visit(child, arm)

    visit(fn_node, ())
    return paths


def _ref(node: ast.AST) -> Optional[str]:
    """``name`` or ``self.attr`` as text, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return f"self.{node.attr}"
    return None


def _stored_refs(body: List[ast.stmt]) -> Set[str]:
    out: Set[str] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(node.ctx, ast.Store):
                ref = _ref(node)
                if ref:
                    out.add(ref)
    return out


def static_outputs(ctx: ModuleContext) -> Dict[str, Set[str]]:
    """graph ref → the refs its capture bodies assign (its static outputs)."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            call = item.context_expr
            if isinstance(call, ast.Call) and call.args \
                    and ctx.resolve(call.func) in _CAPTURE_NAMES:
                graph = _ref(call.args[0])
                if graph:
                    out.setdefault(graph, set()).update(
                        _stored_refs(node.body))
    return out


class DonatedBufferReuse(Rule):
    id = "DTX010"
    name = "graph-output-reuse"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        outputs = static_outputs(ctx)
        if not outputs:
            return []
        out: List[Finding] = []
        for qualname in sorted(ctx.graph.functions):
            info = ctx.graph.functions[qualname]
            out.extend(self._check_function(ctx, info.node, outputs))
        return out

    def _check_function(self, ctx: ModuleContext, fn_node: ast.AST,
                        outputs: Dict[str, Set[str]]) -> List[Finding]:
        replays: List[Tuple[str, Tuple[int, int]]] = []
        aliases: List[Tuple[str, str, str, ast.stmt]] = []
        for node in walk_function(fn_node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "replay" and not node.args:
                graph = _ref(node.func.value)
                if graph in outputs:
                    replays.append((graph, (node.lineno, node.col_offset)))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                src = node.value
                if isinstance(src, ast.Subscript):
                    src = src.value
                ref = _ref(src)
                for graph, outs in outputs.items():
                    if ref in outs and ref != node.targets[0].id:
                        aliases.append((node.targets[0].id, graph, ref, node))
        out: List[Finding] = []
        for name, graph, ref, stmt in aliases:
            end = (stmt.end_lineno, stmt.end_col_offset)
            later = [at for g, at in replays if g == graph and at > end]
            if not later:
                continue
            use = self._first_read_after(fn_node, name, min(later)[0])
            if use is not None:
                out.append(self.finding(
                    ctx, use,
                    f"`{name}` was bound to {graph}'s static output "
                    f"`{ref}` and is read after a later {graph}.replay() "
                    "— the replay rewrites the buffer in place; clone() "
                    "it before the replay or read it first"))
        return out

    def _first_read_after(self, fn_node: ast.AST, name: str,
                          after_line: int) -> Optional[ast.Name]:
        """First Load of ``name`` after ``after_line`` that is not preceded
        by a DOMINATING rebinding — a store whose branch path is a prefix
        of the load's. ``if fresh: x = out.clone()`` only clears reads on
        the ``fresh`` path; the fall-through still reads the old alias."""
        paths = _branch_paths(fn_node)
        events: List[Tuple[int, str, ast.AST]] = []
        for node in walk_function(fn_node):
            if isinstance(node, ast.Name) and node.id == name:
                kind = "store" if isinstance(node.ctx, ast.Store) else "load"
                events.append((node.lineno, kind, node))
        events.sort(key=lambda e: e[0])
        stores: List[Tuple] = []
        for line, kind, node in events:
            if line <= after_line:
                continue
            p = paths.get(id(node), ())
            if kind == "store":
                stores.append(p)
                continue
            if any(p[:len(sp)] == sp for sp in stores):
                continue  # every path to this read rebound the name
            return node
        return None
