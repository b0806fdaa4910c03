"""Lightweight intra-module call graph for dtxlint rules.

Whole-program analysis is out of scope (and overkill for the bug classes
we chase); what the rules need is "which functions in THIS module are
reachable from a hot root" (DTX001) and "which methods of THIS class run
on a background thread" (DTX006). Both come from one pass:

  * every def/async def gets a qualname — ``f`` at module level,
    ``C.m`` for methods, ``outer.<locals>.inner`` for nested defs;
  * call edges: bare-name calls to module-level functions, and
    ``self.m()`` / ``cls.m()`` calls to sibling methods;
  * reference edges: a function passed as a call ARGUMENT
    (``torch.compile(f)``, ``Thread(target=self._worker)``) — the callee will run it, so
    reachability must flow through;
  * nesting edges: an enclosing function reaches its nested defs (the
    closure is defined there; if it escapes uncalled we over-approximate,
    which for a linter is the safe direction).

Import aliases (``import numpy as np``, ``from torch import cuda``,
``from ..ops import prng``) are resolved so rules can match on canonical
dotted names like ``torch.cuda.synchronize`` regardless of local
spelling.
"""

from __future__ import annotations

import ast
import fnmatch
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def collect_aliases(tree: ast.Module, module: Optional[str] = None,
                    is_package: bool = False) -> Dict[str, str]:
    """Local name → canonical dotted prefix for every import in the module.

    ``module``/``is_package`` give the importing module's own dotted name so
    RELATIVE imports resolve to canonical names too: inside
    ``datatunerx_tpu_torch.gateway.server``, ``from ..utils.storage import open_uri``
    maps ``open_uri`` → ``datatunerx_tpu_torch.utils.storage.open_uri``. Without
    module context (fixtures, stdin) relative imports are skipped as before.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            elif module:
                parts = module.split(".")
                if not is_package:
                    parts = parts[:-1]
                if node.level - 1 > len(parts):
                    continue
                parts = parts[:len(parts) - (node.level - 1)]
                base = ".".join(parts + ([node.module] if node.module else []))
            else:
                continue
            if not base:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def resolve_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name for a Name/Attribute chain, through aliases.
    ``np.asarray`` → ``numpy.asarray``; non-name expressions → None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(aliases.get(cur.id, cur.id))
    return ".".join(reversed(parts))


def walk_function(fn: ast.AST, include_nested: bool = False) -> Iterator[ast.AST]:
    """Yield the nodes of one function's own body, optionally descending
    into nested def/class bodies (default: stop at them — nested defs are
    separate call-graph nodes)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not include_nested and isinstance(node, _FUNC_NODES + (ast.ClassDef,)):
            continue
        stack.extend(ast.iter_child_nodes(node))


@dataclass
class FunctionInfo:
    qualname: str
    name: str
    node: ast.AST
    cls: Optional[str] = None  # owning class name for methods
    lineno: int = 0


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)


class ModuleGraph:
    def __init__(self, tree: ast.Module, aliases: Optional[Dict[str, str]] = None):
        self.aliases = aliases if aliases is not None else collect_aliases(tree)
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.edges: Dict[str, Set[str]] = {}
        # per-caller call/reference sites with line numbers: local targets
        # (qualnames) and external dotted names (through import aliases) —
        # the raw material for hot-region roots and the program graph
        self.edge_sites: Dict[str, List[Tuple[str, int]]] = {}
        self.external_sites: Dict[str, List[Tuple[str, int]]] = {}
        # CALL-only subsets (no reference/nesting edges): a function handed
        # to Thread(target=...) or map() runs on another frame — DTX009's
        # held-lock reachability must not follow it, while DTX001 hot-path
        # reachability deliberately does
        self.call_edges: Dict[str, Set[str]] = {}
        self.external_calls: Dict[str, List[Tuple[str, int]]] = {}
        # calls executed at import time (module/class bodies, not functions)
        self.module_sites: List[Tuple[str, int]] = []
        self.module_external_sites: List[Tuple[str, int]] = []
        self._module_level: Dict[str, str] = {}  # bare name → qualname
        self._collect(tree.body, prefix="", cls=None)
        for qualname, info in self.functions.items():
            self.edges[qualname] = self._edges_from(qualname, info)
        self._collect_module_sites(tree)

    # ------------------------------------------------------------ building
    def _collect(self, body, prefix: str, cls: Optional[str]):
        for node in body:
            if isinstance(node, _FUNC_NODES):
                qual = f"{prefix}{node.name}"
                info = FunctionInfo(qual, node.name, node, cls=cls,
                                    lineno=node.lineno)
                self.functions[qual] = info
                if cls is not None and prefix == f"{cls}.":
                    self.classes[cls].methods[node.name] = info
                if prefix == "":
                    self._module_level[node.name] = qual
                self._collect(node.body, prefix=f"{qual}.<locals>.", cls=cls)
            elif isinstance(node, ast.ClassDef) and prefix == "":
                self.classes[node.name] = ClassInfo(node.name, node)
                self._collect(node.body, prefix=f"{node.name}.", cls=node.name)

    def _target_of(self, expr: ast.AST, info: FunctionInfo) -> Optional[str]:
        """Qualname a Name/Attribute expression refers to, if it names a
        function in this module."""
        if isinstance(expr, ast.Name):
            local = f"{info.qualname}.<locals>.{expr.id}"
            if local in self.functions:
                return local
            return self._module_level.get(expr.id)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls") and info.cls):
            sibling = f"{info.cls}.{expr.attr}"
            if sibling in self.functions:
                return sibling
        return None

    def _edges_from(self, qualname: str, info: FunctionInfo) -> Set[str]:
        out: Set[str] = set()
        sites = self.edge_sites.setdefault(qualname, [])
        ext = self.external_sites.setdefault(qualname, [])
        calls = self.call_edges.setdefault(qualname, set())
        ext_calls = self.external_calls.setdefault(qualname, [])
        # nesting edges
        nested_prefix = f"{qualname}.<locals>."
        for other in self.functions:
            if other.startswith(nested_prefix) and "." not in other[len(nested_prefix):]:
                out.add(other)
                sites.append((other, info.lineno))
        for node in walk_function(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee = self._target_of(node.func, info)
            if callee:
                out.add(callee)
                sites.append((callee, node.lineno))
                calls.add(callee)
            else:
                dotted = resolve_name(node.func, self.aliases)
                if dotted:
                    ext.append((dotted, node.lineno))
                    ext_calls.append((dotted, node.lineno))
            # reference edges: functions handed to another callable
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                ref = self._target_of(arg, info)
                if ref:
                    out.add(ref)
                    sites.append((ref, node.lineno))
                elif isinstance(arg, (ast.Name, ast.Attribute)):
                    dotted = resolve_name(arg, self.aliases)
                    if dotted:
                        ext.append((dotted, node.lineno))
        return out

    def _collect_module_sites(self, tree: ast.Module):
        """Call sites at import time: module body and class bodies, stopping
        at function boundaries (their bodies run when called)."""
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) \
                    and node.func.id in self._module_level:
                self.module_sites.append(
                    (self._module_level[node.func.id], node.lineno))
            else:
                dotted = resolve_name(node.func, self.aliases)
                if dotted:
                    self.module_external_sites.append((dotted, node.lineno))

    # ------------------------------------------------------------- queries
    def call_target(self, expr: ast.AST, caller: str) -> Optional[str]:
        """Qualname a call's func expression refers to, when it names a
        function in this module and ``caller`` is the enclosing function's
        qualname (public form of the edge-building resolution, used by the
        program pass's summaries)."""
        info = self.functions.get(caller)
        if info is None:
            return None
        return self._target_of(expr, info)

    def reachable(self, patterns: Tuple[str, ...]) -> Set[str]:
        """Every function reachable (inclusive) from functions whose BARE
        name matches one of the fnmatch patterns."""
        roots = [q for q, i in self.functions.items()
                 if any(fnmatch.fnmatchcase(i.name, p) for p in patterns)]
        return self.reachable_from(roots)

    def reachable_from(self, roots) -> Set[str]:
        """Every function reachable (inclusive) from the given qualnames."""
        seen: Set[str] = set()
        stack = [q for q in roots if q in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.edges.get(cur, ()))
        return seen

    def class_reachable(self, cls: str, method_names: Set[str]) -> Set[str]:
        """Methods of ``cls`` reachable (inclusive) from the named methods,
        following only intra-class edges."""
        seen: Set[str] = set()
        stack = [f"{cls}.{m}" for m in method_names if f"{cls}.{m}" in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in self.edges.get(cur, ()):
                fi = self.functions.get(nxt)
                if fi is not None and fi.cls == cls:
                    stack.append(nxt)
        return seen

    def thread_entry_methods(self, cls: str) -> Set[str]:
        """Bare names of ``cls`` methods used as a Thread/Timer ``target=``
        anywhere in the class body."""
        entries: Set[str] = set()
        cinfo = self.classes.get(cls)
        if cinfo is None:
            return entries
        for node in ast.walk(cinfo.node):
            if not isinstance(node, ast.Call):
                continue
            callee = resolve_name(node.func, self.aliases)
            if callee not in ("threading.Thread", "threading.Timer"):
                continue
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value, ast.Attribute) \
                        and isinstance(kw.value.value, ast.Name) \
                        and kw.value.value.id == "self":
                    entries.add(kw.value.attr)
        return entries
