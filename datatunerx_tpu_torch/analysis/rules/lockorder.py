"""DTX011: static lock-order inversion — the compile-time mirror of the
runtime SAN001 sanitizer (`analysis/sanitizers/lockorder.py`).

A lock here is the DTX009 naming heuristic (``with self._lock:``,
``_POOL_LOCK`` — see ``rules/blocking.py``), contextualized to a stable
identity so orders compare across functions and modules:

    ``self._lock`` in class C of module M      →  ``M.C._lock``
    bare/module-level ``_POOL_LOCK`` in M      →  ``M._POOL_LOCK``

Two sources of ordering edges:

  * **lexical** — a lock-guarded ``with`` nested inside another in the
    same function body acquires inner while holding outer;
  * **call-chain** (program pass in ``analysis/program.py``) — a call
    made under a lock to a function whose reachable closure (over
    call-only edges, same reachability DTX009 uses) acquires another
    lock; the edge lands on the call site and the finding names the
    acquiring LEAF, like DTX009 names its blocking leaf.

A cycle in the resulting order graph is a potential ABBA deadlock. This
per-module rule reports cycles provable from one file's lexical edges
alone; the program pass reports every cycle that needs a call edge or a
second module (and skips the purely-lexical single-module ones, so
nothing is reported twice). Suppress with ``# dtxlint: disable=DTX011``
— and tell the runtime sanitizer the same story with
``# dtxsan: order(N)`` ranks on the allocation sites.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from datatunerx_tpu_torch.analysis.rules.blocking import lock_name

Edge = Tuple[str, str]


def lock_context_id(module: Optional[str], cls: Optional[str],
                    name: str) -> str:
    """Stable cross-module identity for a lock name seen in source."""
    mod = module or "?"
    if name.startswith(("self.", "cls.")):
        attr = name.split(".", 1)[1]
        return f"{mod}.{cls}.{attr}" if cls else f"{mod}.{attr}"
    return f"{mod}.{name}"


def _with_lock_ids(ctx: ModuleContext, cls: Optional[str],
                   node: ast.AST) -> List[str]:
    """Contextualized ids of the lock-guarded items of one with-stmt, in
    acquisition order (multi-item withs acquire left to right)."""
    out: List[str] = []
    for item in node.items:
        name = lock_name(item.context_expr)
        if name:
            out.append(lock_context_id(ctx.module, cls, name))
    return out


def function_lock_info(ctx: ModuleContext, info
                       ) -> Tuple[List[List], List[List]]:
    """(acquires, lexical edges) for one function:
    acquires = [[lock_id, line], ...] for every lock-guarded with;
    edges    = [[outer_id, inner_id, line], ...] for every acquisition
    made while another lock is lexically held (line = inner with)."""
    acquires: List[List] = []
    edges: List[List] = []

    def visit(node: ast.AST, held: List[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue  # nested def runs later, maybe without the lock
            inner_held = held
            if isinstance(child, (ast.With, ast.AsyncWith)):
                ids = _with_lock_ids(ctx, info.cls, child)
                if ids:
                    inner_held = list(held)
                    for lid in ids:
                        acquires.append([lid, child.lineno])
                        for h in inner_held:
                            if h != lid:
                                edges.append([h, lid, child.lineno])
                        inner_held.append(lid)
            visit(child, inner_held)

    visit(info.node, [])
    return acquires, edges


class LockOrderInversion(Rule):
    id = "DTX011"
    name = "lock-order-inversion"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        # edge → (line of the inner acquisition, holder qualname)
        edges: Dict[Edge, Tuple[int, str]] = {}
        for qualname in sorted(ctx.graph.functions):
            info = ctx.graph.functions[qualname]
            _acq, fn_edges = function_lock_info(ctx, info)
            for a, b, line in fn_edges:
                edges.setdefault((a, b), (line, qualname))
        out: List[Finding] = []
        graph: Dict[str, Set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[frozenset] = set()
        for (a, b) in sorted(edges):
            path = shortest_path(graph, b, a)
            if path is None:
                continue
            cycle = [a] + path
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            line, qualname = edges[(a, b)]
            back = edges.get((path[-2] if len(path) >= 2 else b, a))
            back_at = f"line {back[0]} in {back[1]}" if back else "?"
            chain = " -> ".join(cycle)
            out.append(Finding(
                self.id, ctx.path, line, 0,
                f"lock-order inversion: {b} acquired in {qualname} while "
                f"holding {a}, but the opposite order is taken at "
                f"{back_at} (cycle {chain}) — two threads interleaving "
                "these paths deadlock; acquire in one global order",
                self.severity))
        return out


def shortest_path(graph: Dict[str, Set[str]], src: str,
                  dst: str) -> Optional[List[str]]:
    """BFS path src..dst inclusive over a lock-id graph; None when
    unreachable. Shared with the program pass."""
    if src == dst:
        return [src]
    prev: Dict[str, str] = {}
    queue = [src]
    seen = {src}
    while queue:
        cur = queue.pop(0)
        for nxt in sorted(graph.get(cur, ())):
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
