"""DTX006: lock discipline around thread-shared attributes.
DTX007: subprocess/thread/socket created and never reaped.

Both target the gateway/prefetch bug family: state shared between a
``threading.Thread`` target and the public API of the same class, and process/socket handles whose cleanup path exists but is
never reached (the ``/admin/drain`` zombie-replica leak).

DTX006 — for every class that starts a thread on one of its own methods
(``threading.Thread(target=self._worker)``), attributes the thread
context reads or writes are "shared". A PUBLIC method assigning a shared
attribute outside a ``with self.<lock>:`` block races the thread — int
stores happen to be atomic in CPython today, but compound updates and
dict/list mutations are not, and the discipline should not depend on
which kind today's diff touches. ``__init__`` and other underscore
methods are exempt (construction happens-before thread start; private
helpers are assumed called under the caller's lock).

DTX007 — a ``subprocess.Popen``/``threading.Thread``/``socket.socket``
created in a function must have a reachable disposal: a cleanup call
(terminate/kill/join/close/…) on the handle, a ``with`` block, or an
escape (returned, passed on, stored). Handles stored on ``self`` get a
class-wide check instead: SOME method of the class must dispose of
values derived from that attribute, else every instance leaks its
children. Threads marked ``daemon=True`` are exempt — they cannot block
interpreter exit, which is this rule's severity bar.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from datatunerx_tpu_torch.analysis.callgraph import walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

_RESOURCES = {
    "subprocess.Popen": "subprocess",
    "threading.Thread": "thread",
    "threading.Timer": "thread",
    "multiprocessing.Process": "process",
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "concurrent.futures.ThreadPoolExecutor": "executor",
    "concurrent.futures.ProcessPoolExecutor": "executor",
}
_CLEANUP_METHODS = {"close", "terminate", "kill", "join", "wait",
                    "communicate", "shutdown", "stop", "cancel", "detach"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is exactly ``self.X``."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _write_targets(stmt: ast.AST) -> List[Tuple[str, ast.AST]]:
    """self-attributes written by an assignment statement: plain
    ``self.X = ...`` and container mutation ``self.X[k] = ...``."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: List[Tuple[str, ast.AST]] = []
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List, ast.Starred)):
            stack.extend(ast.iter_child_nodes(t))
            continue
        attr = _self_attr(t)
        if attr is not None:
            out.append((attr, t))
        elif isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                out.append((attr, t))
    return out


def _under_self_lock(ctx: ModuleContext, node: ast.AST,
                     stop: ast.AST) -> bool:
    """Is ``node`` inside a ``with self.<anything>:`` block (within the
    function ``stop``)? Any with-on-a-self-attribute counts as a lock —
    being lenient here keeps FPs down; naming doesn't matter."""
    cur = node
    parents = ctx.parents
    while cur is not stop and cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                if _self_attr(item.context_expr) is not None:
                    return True
    return False


class LockDiscipline(Rule):
    id = "DTX006"
    name = "lock-discipline"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for cls_name in sorted(ctx.graph.classes):
            out.extend(self._check_class(ctx, cls_name))
        return out

    def _check_class(self, ctx: ModuleContext, cls: str) -> List[Finding]:
        graph = ctx.graph
        entries = graph.thread_entry_methods(cls)
        if not entries:
            return []
        thread_ctx = graph.class_reachable(cls, entries)
        shared: Set[str] = set()
        for qualname in thread_ctx:
            info = graph.functions[qualname]
            for node in walk_function(info.node, include_nested=True):
                attr = _self_attr(node)
                if attr is not None:
                    shared.add(attr)
        # thread-started attributes like self._thread itself are lifecycle,
        # not data; they'd still be flagged if a public method reassigns
        # them unlocked, which is genuinely racy — so no exemption.
        out: List[Finding] = []
        entry_names = ", ".join(sorted(entries))
        for name, info in sorted(graph.classes[cls].methods.items()):
            if name.startswith("_") or info.qualname in thread_ctx:
                continue
            for node in walk_function(info.node, include_nested=True):
                for attr, target in _write_targets(node):
                    if attr not in shared:
                        continue
                    if _under_self_lock(ctx, target, info.node):
                        continue
                    out.append(self.finding(
                        ctx, target,
                        f"self.{attr} is used by {cls}'s background "
                        f"thread ({entry_names}) but written here in "
                        f"public {name}() without holding a lock — wrap "
                        "the write in `with self.<lock>:`"))
        return out


class ResourceLeak(Rule):
    id = "DTX007"
    name = "resource-leak"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for qualname in sorted(ctx.graph.functions):
            info = ctx.graph.functions[qualname]
            for node in walk_function(info.node):
                if not isinstance(node, ast.Call):
                    continue
                kind = _RESOURCES.get(ctx.resolve(node.func) or "")
                if kind is None:
                    continue
                if kind == "thread" and self._is_daemon(node):
                    continue
                problem = self._disposition(ctx, qualname, info, node, kind)
                if problem:
                    out.append(self.finding(ctx, node, problem))
        return out

    @staticmethod
    def _is_daemon(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False

    # --------------------------------------------------------- disposition
    def _disposition(self, ctx, qualname, info, call, kind) -> str:
        """'' when the handle is disposed/escapes; else the finding text."""
        parent = ctx.parents.get(call)
        # with Popen(...) as p: — managed
        if isinstance(parent, ast.withitem):
            return ""
        # chained immediate use: Popen(...).wait() disposes inline;
        # Thread(...).start() drops the handle
        if isinstance(parent, ast.Attribute):
            if parent.attr in _CLEANUP_METHODS:
                return ""
            return (f"{kind} handle is dropped after "
                    f"`.{parent.attr}()` — keep it and terminate/join it "
                    "on shutdown")
        if isinstance(parent, ast.Expr):
            return f"{kind} handle is created and immediately dropped"
        if isinstance(parent, ast.Assign):
            targets = parent.targets
            if len(targets) == 1:
                t = targets[0]
                if isinstance(t, ast.Name):
                    return self._check_local(ctx, info, t.id, kind)
                attr = _self_attr(t) or (
                    _self_attr(t.value) if isinstance(t, ast.Subscript)
                    else None)
                if attr is not None and info.cls is not None:
                    return self._check_class_attr(ctx, info.cls, attr, kind)
        # returned / yielded / passed as an argument / stored via other
        # shapes: the handle escapes, its owner is responsible
        return ""

    def _check_local(self, ctx, info, name: str, kind: str) -> str:
        # handle-passed-to-an-internal-callee uses: with the program graph
        # on, the callee's parameter disposition decides whether this was a
        # true handoff or a drop — recorded for the program pass, treated
        # as an escape (no module-level finding) either way
        candidates: List[dict] = []
        for node in walk_function(info.node, include_nested=True):
            if not (isinstance(node, ast.Name) and node.id == name):
                continue
            if isinstance(node.ctx, ast.Store):
                continue  # the binding (or a rebinding) itself
            parent = ctx.parents.get(node)
            if isinstance(parent, ast.Attribute):
                grand = ctx.parents.get(parent)
                if isinstance(grand, ast.Call) and grand.func is parent \
                        and parent.attr in _CLEANUP_METHODS:
                    return ""
                continue  # p.poll()/p.pid — neutral receiver use
            cand = self._call_arg_candidate(ctx, node, parent)
            if cand is not None:
                candidates.append(cand)
                continue
            # any other Load use — return, yield, `with p:`, container
            # literal, alias assignment — escapes to code we can't see;
            # its new owner is responsible
            return ""
        if candidates:
            ctx.xescape_candidates.append({
                "var": name, "kind": kind,
                "line": candidates[0]["line"], "col": candidates[0]["col"],
                "targets": candidates,
            })
            return ""
        return (f"{kind} handle `{name}` has no reachable "
                "terminate/join/close in this function and never escapes "
                "— it leaks when the function returns")

    @staticmethod
    def _call_arg_candidate(ctx, node, parent) -> Optional[dict]:
        """When ``node`` is a plain positional/keyword argument of a call
        whose callee resolves to a name, describe the pass-through:
        {callee, arg (int position or str kwarg), line, col}. None for any
        other use."""
        call, arg = None, None
        if isinstance(parent, ast.Call) and node in parent.args:
            if any(isinstance(a, ast.Starred) for a in parent.args):
                return None  # positional index unknowable
            call, arg = parent, parent.args.index(node)
        elif isinstance(parent, ast.keyword) and parent.value is node \
                and parent.arg is not None:
            grand = ctx.parents.get(parent)
            if isinstance(grand, ast.Call):
                call, arg = grand, parent.arg
        if call is None or call.func is node:
            return None
        callee = ctx.resolve(call.func)
        if not callee:
            return None
        return {"callee": callee, "arg": arg,
                "line": node.lineno, "col": node.col_offset}

    def _check_class_attr(self, ctx, cls: str, attr: str, kind: str) -> str:
        graph = ctx.graph
        for name, minfo in graph.classes[cls].methods.items():
            derived = self._derived_locals(minfo.node, attr)
            for node in walk_function(minfo.node, include_nested=True):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _CLEANUP_METHODS \
                        and self._mentions(node.func.value, attr, derived):
                    return ""
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if self._mentions(item.context_expr, attr, derived):
                            return ""
        return (f"{kind} handle stored in self.{attr} but no method of "
                f"{cls} ever terminates/joins/closes values from "
                f"self.{attr} — each instance leaks its children "
                "(the /admin/drain zombie shape)")

    def _derived_locals(self, fn_node, attr: str) -> Set[str]:
        """Local names whose value derives from self.<attr> (two data-flow
        hops: covers `procs = list(self._procs.values())` then
        `for p in procs:`)."""
        derived: Set[str] = set()
        for _ in range(2):
            for node in walk_function(fn_node, include_nested=True):
                value, targets = None, []
                if isinstance(node, ast.Assign):
                    value, targets = node.value, node.targets
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    value, targets = node.iter, [node.target]
                if value is None or not self._mentions(value, attr, derived):
                    continue
                stack = list(targets)
                while stack:
                    t = stack.pop()
                    if isinstance(t, ast.Name):
                        derived.add(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List, ast.Starred)):
                        stack.extend(ast.iter_child_nodes(t))
        return derived

    @staticmethod
    def _mentions(expr: ast.AST, attr: str, derived: Set[str]) -> bool:
        for node in ast.walk(expr):
            if _self_attr(node) == attr:
                return True
            if isinstance(node, ast.Name) and node.id in derived:
                return True
        return False


def param_disposition(ctx, fn_node, pname: str) -> str:
    """What a function does with one of its parameters, for the program
    pass's cross-module escape analysis:

      * ``disposes`` — a cleanup method is called on it (or ``with p:``);
      * ``escapes``  — returned/stored/passed on: someone else owns it;
      * ``drops``    — only neutral receiver uses (or none): a resource
        handle passed here dies with the frame, so the CALLER still leaks.
    """
    for node in walk_function(fn_node, include_nested=True):
        if not (isinstance(node, ast.Name) and node.id == pname):
            continue
        if isinstance(node.ctx, ast.Store):
            return "escapes"  # rebound: can't track further, be safe
        parent = ctx.parents.get(node)
        if isinstance(parent, ast.Attribute):
            grand = ctx.parents.get(parent)
            if isinstance(grand, ast.Call) and grand.func is parent \
                    and parent.attr in _CLEANUP_METHODS:
                return "disposes"
            continue  # p.poll()/p.pid — neutral receiver use
        if isinstance(parent, ast.withitem) and parent.context_expr is node:
            return "disposes"
        return "escapes"
    return "drops"
