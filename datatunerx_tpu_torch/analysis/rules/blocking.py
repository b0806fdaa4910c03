"""DTX009: blocking calls inside a lock-guarded `with` body.

The gateway-stall shape we keep hand-auditing: the replica pool, engine
scheduler, and prefetchers all serialize state behind ``with self._lock:``
— a device sync, ``subprocess`` wait, ``requests``/socket I/O, an
unbounded ``queue.get()``, or a bare ``time.sleep`` inside that body
holds the lock across an operation with no latency bound, and every
other thread (including the request path) convoys behind it.

A "lock" is a ``with`` context whose expression is ``self.<attr>`` or a
bare/module-level name containing ``lock``/``mutex``/``cond``/``sem``
(case-insensitive) — naming-based on purpose: ``with self._session:`` is
not a lock and must not flag.

Blocking calls (direct):
  * device sync — the explicit DTX001 set (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray``,
    ``torch.cuda.synchronize()``, ``Event/Stream.synchronize()``); the
    ``float()``-of-a-computed-value heuristic stays DTX001-only (under a
    lock it would flag ordinary parsing);
  * ``subprocess.run/call/check_call/check_output`` and no-timeout
    ``.wait()`` / ``.communicate()`` / ``.join()`` on any receiver
    (``proc.wait(timeout=10)`` and ``event.wait(interval)`` are bounded
    and exempt);
  * ``requests.*`` / ``urllib.request.urlopen`` / ``socket.create_
    connection`` and socket-ish ``.recv/.accept/.connect/.sendall``;
  * ``.get()`` with no positional args and no finite ``timeout=`` (the
    ``queue.get(timeout=None)`` shape; ``d.get(key)`` has args and is
    exempt);
  * ``time.sleep``.

With the program graph on, the pass in ``analysis/program.py`` extends
this transitively: a call under a lock to a function whose reachable
closure contains one of the sites above is flagged at the call site.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from datatunerx_tpu_torch.analysis.callgraph import resolve_name, walk_function
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from datatunerx_tpu_torch.analysis.rules.host_sync import sync_label

_LOCKISH = ("lock", "mutex", "cond", "sem")

_BLOCKING_EXACT = {
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
    "urllib.request.urlopen": "urllib.request.urlopen()",
    "socket.create_connection": "socket.create_connection()",
    "time.sleep": "time.sleep()",
}
_BLOCKING_PREFIXES = ("requests.",)
_BLOCKING_METHODS = {"recv", "recvfrom", "accept", "connect", "sendall"}
# blocking only without a bound: a positional arg or finite timeout= is a
# latency cap (proc.wait(timeout=10), event.wait(interval), t.join(5))
_BOUNDABLE_METHODS = {"wait", "communicate", "join"}


def _lockish_name(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _LOCKISH)


def lock_name(item_expr: ast.AST) -> Optional[str]:
    """Rendered lock name when a with-item expression looks like a lock
    (``self._lock``, ``_POOL_LOCK``, ``cls._cv``), else None."""
    if isinstance(item_expr, ast.Attribute) and _lockish_name(item_expr.attr):
        if isinstance(item_expr.value, ast.Name):
            return f"{item_expr.value.id}.{item_expr.attr}"
        return item_expr.attr
    if isinstance(item_expr, ast.Name) and _lockish_name(item_expr.id):
        return item_expr.id
    return None


def _no_finite_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout":
            return isinstance(kw.value, ast.Constant) and kw.value.value is None
    return True


def blocking_label(ctx: ModuleContext, node: ast.Call) -> str:
    """Human label when ``node`` is a blocking call, else ''."""
    sync = sync_label(ctx, node)
    if sync and not sync.endswith("on a device value"):
        # the float()/int() heuristic is DTX001's: under a lock it would
        # flag ordinary string/number parsing, so only explicit syncs count
        return f"device sync {sync}"
    resolved = ctx.resolve(node.func)
    if resolved in _BLOCKING_EXACT:
        return _BLOCKING_EXACT[resolved]
    if resolved and any(resolved.startswith(p) for p in _BLOCKING_PREFIXES):
        return f"{resolved}()"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _BLOCKING_METHODS:
            return f".{attr}()"
        if attr in _BOUNDABLE_METHODS and not node.args \
                and _no_finite_timeout(node):
            return f".{attr}() without timeout"
        if attr == "get" and not node.args and _no_finite_timeout(node):
            for kw in node.keywords:
                if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                        and not kw.value.value:
                    return ""
            return ".get() without timeout"
    return ""


def locked_regions(fn_node: ast.AST) -> List[Tuple[ast.AST, str]]:
    """(with-node, lock name) for every lock-guarded with in one function."""
    out: List[Tuple[ast.AST, str]] = []
    for node in walk_function(fn_node, include_nested=True):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = lock_name(item.context_expr)
                if name:
                    out.append((node, name))
                    break
    return out


def calls_under_lock(ctx: ModuleContext,
                     fn_node: ast.AST) -> List[Tuple[ast.Call, str]]:
    """(call, lock name) for calls lexically inside a lock-guarded with
    body (the with-item expressions themselves are outside)."""
    out: List[Tuple[ast.Call, str]] = []
    for with_node, name in locked_regions(fn_node):
        body_stack: List[ast.AST] = list(with_node.body)
        while body_stack:
            node = body_stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # nested def runs later, maybe without the lock
            body_stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, ast.Call):
                out.append((node, name))
    return out


class BlockingUnderLock(Rule):
    id = "DTX009"
    name = "blocking-call-under-lock"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        out: List[Finding] = []
        seen = set()
        for qualname in sorted(ctx.graph.functions):
            info = ctx.graph.functions[qualname]
            for call, lock in calls_under_lock(ctx, info.node):
                key = (call.lineno, call.col_offset)
                if key in seen:
                    continue  # nested locks: report once, innermost lock
                seen.add(key)
                label = blocking_label(ctx, call)
                if label:
                    out.append(self.finding(
                        ctx, call,
                        f"{label} while holding {lock}: every thread "
                        "contending on the lock convoys behind an "
                        "unbounded operation — move it outside the "
                        "critical section or add a timeout"))
        return out
