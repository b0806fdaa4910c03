"""DTX004: the same PRNG key consumed by two ``ops/prng`` draws.

The port's sampler, LoRA init, dropout and NEFTune draw through
``ops/prng`` (the threefry twin of ``jax.random``): its keys are values,
not stateful generators, exactly as in JAX. Passing one key to two
consumers (``prng.uniform(key, ...)`` then ``prng.bernoulli(key, ...)``)
silently correlates the two draws — every consumption should go through
its own ``split``/``fold_in`` product. ``fold_in(key, i)`` itself may take
the same base key any number of times (the distinct-stream idiom);
``split`` may not — two bare ``split(key)`` calls return identical
children. The rule tracks each local name consumed by an ``ops/prng``
call (through any import spelling or ``import ... as`` alias; as first
positional arg or ``key=``) in statement order and flags:

  * a second consumption of the same name with no reassignment between
    (mutually exclusive if/else branches are NOT double consumption and
    stay allowed);
  * a consumption inside a loop whose key was last assigned OUTSIDE the
    loop — every iteration reuses the same key (the loop-carry idiom
    ``key, sub = prng.split(key)`` is recognized and allowed).

Heuristic and intra-function only — it cannot see a key escaping through
a call — but this is exactly the shape key-reuse bugs take in practice.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

# fold_in is deliberately non-consuming: deriving per-step/per-layer
# streams as fold_in(base_key, i) with distinct data REQUIRES passing the
# same base key repeatedly — that's the documented idiom, not reuse.
# (Statically we can't prove the fold data differs; flagging the idiom
# would bury real findings under suppressions.)
_NON_CONSUMING = {"PRNGKey", "fold_in", "to_device", "slice_index",
                  "threefry2x32", "xla_log"}
# the module whose calls draw from a key (canonical dotted prefix)
PRNG_MODULE = "datatunerx_tpu_torch.ops.prng."
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

IfPath = Tuple[Tuple[int, str], ...]
LoopPath = Tuple[int, ...]


def _compatible(a: IfPath, b: IfPath) -> bool:
    """Two branch paths can execute in the same run unless they take
    different arms of the same ``if``."""
    arms_a = dict(a)
    for if_id, arm in b:
        if if_id in arms_a and arms_a[if_id] != arm:
            return False
    return True


class _Event:
    __slots__ = ("kind", "name", "if_path", "loop_path", "node", "carry")

    def __init__(self, kind, name, if_path, loop_path, node, carry=False):
        self.kind = kind  # "use" | "assign"
        self.name = name
        self.if_path = if_path
        self.loop_path = loop_path
        self.node = node
        self.carry = carry  # use feeding a reassignment of the same name


class PRNGKeyReuse(Rule):
    id = "DTX004"
    name = "prng-key-reuse"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for qualname in sorted(ctx.graph.functions):
            info = ctx.graph.functions[qualname]
            events: List[_Event] = []
            for arg in self._params(info.node):
                events.append(_Event("assign", arg, (), (), info.node))
            self._scan(ctx, info.node.body, (), (), events)
            out.extend(self._analyze(ctx, events))
        return out

    @staticmethod
    def _params(fn) -> List[str]:
        args = fn.args
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                names.append(extra.arg)
        return names

    # ------------------------------------------------------------- events
    def _scan(self, ctx, stmts, if_path: IfPath, loop_path: LoopPath,
              events: List[_Event]):
        for stmt in stmts:
            if isinstance(stmt, _FUNC_NODES + (ast.ClassDef, ast.Lambda)):
                continue  # separate scope; analyzed as its own function
            if isinstance(stmt, ast.If):
                self._uses(ctx, stmt.test, if_path, loop_path, events)
                self._scan(ctx, stmt.body,
                           if_path + ((id(stmt), "body"),), loop_path, events)
                self._scan(ctx, stmt.orelse,
                           if_path + ((id(stmt), "orelse"),), loop_path,
                           events)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._uses(ctx, stmt.iter, if_path, loop_path, events)
                self._assigns(stmt.target, if_path,
                              loop_path + (id(stmt),), events)
                self._scan(ctx, stmt.body, if_path,
                           loop_path + (id(stmt),), events)
                self._scan(ctx, stmt.orelse, if_path, loop_path, events)
            elif isinstance(stmt, ast.While):
                inner = loop_path + (id(stmt),)
                self._uses(ctx, stmt.test, if_path, inner, events)
                self._scan(ctx, stmt.body, if_path, inner, events)
                self._scan(ctx, stmt.orelse, if_path, loop_path, events)
            elif isinstance(stmt, ast.Try):
                self._scan(ctx, stmt.body, if_path, loop_path, events)
                for handler in stmt.handlers:
                    self._scan(ctx, handler.body, if_path, loop_path, events)
                self._scan(ctx, stmt.orelse, if_path, loop_path, events)
                self._scan(ctx, stmt.finalbody, if_path, loop_path, events)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._uses(ctx, item.context_expr, if_path, loop_path,
                               events)
                    if item.optional_vars is not None:
                        self._assigns(item.optional_vars, if_path, loop_path,
                                      events)
                self._scan(ctx, stmt.body, if_path, loop_path, events)
            elif isinstance(stmt, ast.Assign):
                targets = self._target_names(stmt.targets)
                self._uses(ctx, stmt.value, if_path, loop_path, events,
                           carry_names=targets)
                for t in stmt.targets:
                    self._assigns(t, if_path, loop_path, events)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                if stmt.value is not None:
                    targets = self._target_names([stmt.target])
                    self._uses(ctx, stmt.value, if_path, loop_path, events,
                               carry_names=targets)
                self._assigns(stmt.target, if_path, loop_path, events)
            else:
                for child in ast.iter_child_nodes(stmt):
                    self._uses(ctx, child, if_path, loop_path, events)

    def _target_names(self, targets) -> Set[str]:
        names: Set[str] = set()
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List, ast.Starred)):
                stack.extend(ast.iter_child_nodes(t))
        return names

    def _uses(self, ctx, expr, if_path, loop_path, events,
              carry_names: Optional[Set[str]] = None):
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func)
            if not resolved or not resolved.startswith(PRNG_MODULE):
                continue
            fn = resolved.rsplit(".", 1)[1]
            if fn in _NON_CONSUMING:
                continue
            key_arg = None
            if node.args and isinstance(node.args[0], ast.Name):
                key_arg = node.args[0]
            else:
                for kw in node.keywords:
                    if kw.arg == "key" and isinstance(kw.value, ast.Name):
                        key_arg = kw.value
            if key_arg is None:
                continue
            carry = bool(carry_names) and key_arg.id in carry_names
            events.append(_Event("use", key_arg.id, if_path, loop_path,
                                 node, carry=carry))

    def _assigns(self, target, if_path, loop_path, events):
        for name in sorted(self._target_names([target])):
            events.append(_Event("assign", name, if_path, loop_path, target))

    # ----------------------------------------------------------- analysis
    def _analyze(self, ctx, events: List[_Event]) -> List[Finding]:
        out: List[Finding] = []
        last_assign: Dict[str, _Event] = {}
        uses_since: Dict[str, List[_Event]] = {}
        for e in events:
            if e.kind == "assign":
                last_assign[e.name] = e
                uses_since[e.name] = []
                continue
            prior = [u for u in uses_since.setdefault(e.name, [])
                     if _compatible(u.if_path, e.if_path)]
            if prior:
                out.append(self.finding(
                    ctx, e.node,
                    f"PRNG key `{e.name}` already consumed at line "
                    f"{prior[0].node.lineno} — every consumer needs its "
                    "own key from prng.split/fold_in"))
            elif not e.carry:
                la = last_assign.get(e.name)
                assigned_loops = set(la.loop_path) if la is not None else set()
                if any(lp not in assigned_loops for lp in e.loop_path):
                    out.append(self.finding(
                        ctx, e.node,
                        f"PRNG key `{e.name}` consumed inside a loop but "
                        "assigned outside it — every iteration draws with "
                        "the SAME key; split or fold_in per iteration"))
            uses_since[e.name].append(e)
        return out
