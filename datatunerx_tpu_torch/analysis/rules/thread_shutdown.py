"""DTX012: daemon thread started by a class with no shutdown evidence.

DTX007 deliberately exempts ``daemon=True`` threads — they cannot block
interpreter exit, which is that rule's severity bar. But a daemon worker
a class starts and can never stop has its own failure mode: it dies
MID-OPERATION at interpreter exit (half-written spill file, orphaned
lease), keeps ticking against a torn-down object during tests (the
thread-leak sanitizer SAN002 sees exactly these), and pins the object
alive through its bound-method target. The discipline this rule checks:
a class that starts a daemon ``threading.Thread``/``Timer`` must show
SOME shutdown path — any method that

  * ``join()``s / ``cancel()``s the stored handle (or a local derived
    from it, two data-flow hops like DTX007), or
  * ``set()``s an event-ish ``self`` attribute (``self._stop.set()`` —
    the loop-checks-an-Event idiom; names containing stop/shut/exit/
    quit/done/close/drain/event/halt/kill count), or
  * for a locally-created handle, joins/cancels it in the same function —
    or the handle escapes into a ``self`` attribute (``self.X = t`` /
    ``self.X.append(t)``) that some method joins/cancels.

``daemon=True`` in the constructor or a later ``x.daemon = True``
assignment both count as daemonizing. Threads that are never
``start()``ed anywhere in the class are ignored. Module-level functions
are out of scope (no lifecycle to hang cleanup on — DTX007 already
covers non-daemon handles there). Suppress with
``# dtxlint: disable=DTX012`` plus a reason when the worker is
genuinely fire-and-forget for the process lifetime.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from datatunerx_tpu_torch.analysis.callgraph import walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from datatunerx_tpu_torch.analysis.rules.concurrency import ResourceLeak, _self_attr

_THREAD_TYPES = {"threading.Thread", "threading.Timer"}
_STOP_METHODS = {"join", "cancel", "shutdown"}
_EVENTISH = ("stop", "shut", "exit", "quit", "done", "close", "drain",
             "event", "halt", "kill")

_RL = ResourceLeak()  # borrow DTX007's derived-locals data flow


def _is_daemon_kwarg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _stored_name(ctx: ModuleContext, call: ast.Call):
    """('attr', name) for ``self.X = Thread(...)``, ('local', name) for
    ``t = Thread(...)``, (None, None) otherwise (chained/dropped)."""
    parent = ctx.parents.get(call)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        t = parent.targets[0]
        attr = _self_attr(t)
        if attr is not None:
            return "attr", attr
        if isinstance(t, ast.Name):
            return "local", t.id
        if isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                return "attr", attr
    return None, None


def _daemonized(ctx: ModuleContext, fn_node: ast.AST, call: ast.Call,
                kind: Optional[str], name: Optional[str]) -> bool:
    if _is_daemon_kwarg(call):
        return True
    if name is None:
        return False
    for node in walk_function(fn_node, include_nested=True):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Attribute) and t.attr == "daemon"
                and isinstance(node.value, ast.Constant)
                and node.value.value):
            continue
        recv = t.value
        if kind == "local" and isinstance(recv, ast.Name) \
                and recv.id == name:
            return True
        if kind == "attr" and _self_attr(recv) == name:
            return True
    return False


def _method_calls(cls_info):
    for _mname, minfo in sorted(cls_info.methods.items()):
        for node in walk_function(minfo.node, include_nested=True):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                yield minfo, node


class ThreadShutdownEvidence(Rule):
    id = "DTX012"
    name = "daemon-thread-without-shutdown-evidence"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        for cls_name in sorted(ctx.graph.classes):
            out.extend(self._check_class(ctx, cls_name))
        return out

    # ------------------------------------------------------------ evidence
    @staticmethod
    def _event_set_somewhere(cls_info) -> bool:
        for _minfo, call in _method_calls(cls_info):
            if call.func.attr != "set":
                continue
            attr = _self_attr(call.func.value)
            if attr is not None \
                    and any(tok in attr.lower() for tok in _EVENTISH):
                return True
        return False

    @staticmethod
    def _attr_stopped(cls_info, attr: str) -> bool:
        for minfo, call in _method_calls(cls_info):
            if call.func.attr not in _STOP_METHODS:
                continue
            derived = _RL._derived_locals(minfo.node, attr)
            if _RL._mentions(call.func.value, attr, derived):
                return True
        return False

    @staticmethod
    def _escaped_attr(fn_node, name: str) -> Optional[str]:
        """Attr a local handle escapes into within the same function —
        ``self.X = t`` / ``self.X[k] = t`` / ``self.X.append(t)`` (or
        ``.add``) — so class-wide attr evidence applies to it."""
        for node in walk_function(fn_node, include_nested=True):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == name:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None and isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                    if attr is not None:
                        return attr
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("append", "add") \
                    and any(isinstance(a, ast.Name) and a.id == name
                            for a in node.args):
                attr = _self_attr(node.func.value)
                if attr is not None:
                    return attr
        return None

    @staticmethod
    def _local_stopped(fn_node, name: str) -> bool:
        for node in walk_function(fn_node, include_nested=True):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _STOP_METHODS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == name:
                return True
        return False

    @staticmethod
    def _started(cls_info, fn_node, kind: Optional[str],
                 name: Optional[str], call: ast.Call,
                 ctx: ModuleContext) -> bool:
        parent = ctx.parents.get(call)
        if isinstance(parent, ast.Attribute) and parent.attr == "start":
            return True  # Thread(...).start()
        if name is None:
            return False
        scopes = ([m.node for m in cls_info.methods.values()]
                  if kind == "attr" else [fn_node])
        for scope in scopes:
            for node in walk_function(scope, include_nested=True):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "start"):
                    continue
                recv = node.func.value
                if kind == "local" and isinstance(recv, ast.Name) \
                        and recv.id == name:
                    return True
                if kind == "attr" and _self_attr(recv) == name:
                    return True
        return False

    # ---------------------------------------------------------------- core
    def _check_class(self, ctx: ModuleContext, cls: str) -> List[Finding]:
        cls_info = ctx.graph.classes[cls]
        out: List[Finding] = []
        event_evidence: Optional[bool] = None  # computed lazily, once
        for mname, minfo in sorted(cls_info.methods.items()):
            for node in walk_function(minfo.node, include_nested=True):
                if not isinstance(node, ast.Call):
                    continue
                if ctx.resolve(node.func) not in _THREAD_TYPES:
                    continue
                kind, name = _stored_name(ctx, node)
                if not _daemonized(ctx, minfo.node, node, kind, name):
                    continue
                if not self._started(cls_info, minfo.node, kind, name,
                                     node, ctx):
                    continue
                if kind == "attr" and self._attr_stopped(cls_info, name):
                    continue
                if kind == "local":
                    if self._local_stopped(minfo.node, name):
                        continue
                    escaped = self._escaped_attr(minfo.node, name)
                    if escaped is not None \
                            and self._attr_stopped(cls_info, escaped):
                        continue
                if event_evidence is None:
                    event_evidence = self._event_set_somewhere(cls_info)
                if event_evidence:
                    continue
                handle = (f"self.{name}" if kind == "attr"
                          else name if kind == "local" else "the handle")
                out.append(self.finding(
                    ctx, node,
                    f"daemon thread started in {cls}.{mname}() with no "
                    f"shutdown evidence: no method joins/cancels {handle} "
                    f"and no stop-event .set() anywhere in {cls} — the "
                    "worker dies mid-operation at interpreter exit and "
                    "outlives the object in tests; give it a stop Event "
                    "its loop checks, then set+join it in close()"))
        return out
