"""Program-level analysis: the cross-module pass behind ``dtx-torch lint``.

The per-module rules stop at the file boundary, where the bugs of
threaded gateway and engine code tend to sit (a drain leak, a shutdown
flag race, a blocking call behind a module seam). This pass stitches
the per-module call graphs into ONE program graph over ``datatunerx_tpu_torch.*`` imports
(absolute, relative, aliased, ``from x import f``, and package
re-exports through ``__init__``) and runs three cross-module checks:

  * DTX001 — hot-path reachability follows calls across files: a
    ``utils/`` helper that calls ``.item()`` is flagged when reachable
    from ``train_step`` or the engine's ``_scheduler``, with the root
    named in the message. Findings are emitted only for functions hot
    EXCLUSIVELY through cross-module edges (module-local hot paths are
    the per-module rule's job, so nothing is reported twice).
  * DTX007 — escape adjudication: a resource handle whose only use is
    "passed to an internal callee" is no longer assumed safe; the
    callee's parameter disposition (drops / disposes / escapes) decides
    whether the caller still leaks.
  * DTX009 — transitive blocking-under-lock: a call under ``with
    self._lock:`` to a function whose reachable closure contains a
    blocking site (device sync, subprocess wait, socket I/O, unbounded
    ``queue.get``) is flagged at the call site with the blocking leaf
    named.

Every analyzed module is distilled into a JSON-serializable SUMMARY
(functions, edges, sync/blocking sites, suppression lines, …) cached in
``config.cache`` keyed on file mtime+size plus a config/rule-set
fingerprint — repeat ``dtx-torch lint`` runs skip re-parsing unchanged files
entirely and only re-run the (cheap) program pass over the summaries.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from datatunerx_tpu_torch.analysis.config import (
    LintConfig,
    mesh_axes_for,
    rule_enabled,
)
from datatunerx_tpu_torch.analysis.core import (
    Finding,
    LintResult,
    ModuleContext,
    Rule,
    _display_path,
    filter_findings,
    iter_python_files,
    module_name_for_path,
    suppressions,
)
from datatunerx_tpu_torch.analysis.rules.blocking import (
    blocking_label,
    calls_under_lock,
)
from datatunerx_tpu_torch.analysis.rules.concurrency import param_disposition
from datatunerx_tpu_torch.analysis.rules.host_sync import sync_label
from datatunerx_tpu_torch.analysis.rules.lockorder import (
    function_lock_info,
    lock_context_id,
    shortest_path,
)

CACHE_VERSION = 3  # v3: lock_acquires / lock_edges / lock_id (DTX011)

Node = Tuple[str, str]  # (abs file path, qualname)


# ----------------------------------------------------------- module summary

def _call_sites(ctx: ModuleContext, fn_node: ast.AST,
                label_fn) -> List[List]:
    """[line, col, label] for every call in one function's own body that
    ``label_fn`` labels (sync_label / blocking_label)."""
    from datatunerx_tpu_torch.analysis.callgraph import walk_function

    out: List[List] = []
    for node in walk_function(fn_node):
        if isinstance(node, ast.Call):
            label = label_fn(ctx, node)
            if label:
                out.append([node.lineno, node.col_offset, label])
    return out


def _locked_calls(ctx: ModuleContext, qualname: str, fn_node: ast.AST,
                  seen: Set[Tuple[int, int]],
                  cls: Optional[str] = None) -> List[dict]:
    """Calls under a lock that are NOT directly blocking (those are the
    per-module DTX009's) but resolve to a local function or an imported
    dotted name — the program pass follows them through the graph (DTX009
    transitively; DTX011 via the held lock's contextualized id)."""
    out: List[dict] = []
    for call, lock in calls_under_lock(ctx, fn_node):
        key = (call.lineno, call.col_offset)
        if key in seen:
            continue
        seen.add(key)
        if blocking_label(ctx, call):
            continue
        entry = {"line": call.lineno, "col": call.col_offset, "lock": lock,
                 "lock_id": lock_context_id(ctx.module, cls, lock)}
        local = ctx.graph.call_target(call.func, qualname)
        if local:
            entry["local"] = local
        else:
            dotted = ctx.resolve(call.func)
            if not dotted:
                continue
            entry["ext"] = dotted
        out.append(entry)
    return out


def build_summary(ctx: ModuleContext) -> dict:
    """Distill one analyzed module into the JSON-serializable form the
    program pass (and the cache) consumes. Built AFTER the per-module
    rules ran, so DTX007's ``xescape_candidates`` are populated."""
    graph = ctx.graph
    funcs: Dict[str, dict] = {}
    locked_seen: Set[Tuple[int, int]] = set()
    for qualname in sorted(graph.functions):
        info = graph.functions[qualname]
        entry = {
            "name": info.name,
            "lineno": info.lineno,
            "edges": sorted(graph.edges.get(qualname, ())),
            "external": [[d, ln]
                         for d, ln in graph.external_sites.get(qualname, [])],
            # CALL-only subsets: what actually executes on this frame —
            # DTX009's held-lock reachability follows these, never the
            # reference edges (a Thread(target=...) callee runs elsewhere)
            "call_edges": sorted(graph.call_edges.get(qualname, ())),
            "external_calls": [[d, ln] for d, ln
                               in graph.external_calls.get(qualname, [])],
            "sync_sites": _call_sites(ctx, info.node, sync_label),
            "blocking_sites": _call_sites(ctx, info.node, blocking_label),
            "locked_calls": _locked_calls(ctx, qualname, info.node,
                                          locked_seen, cls=info.cls),
        }
        acquires, lock_edges = function_lock_info(ctx, info)
        entry["lock_acquires"] = acquires
        entry["lock_edges"] = lock_edges
        if "." not in qualname:  # module-level fn: DTX007 adjudication data
            a = info.node.args
            entry["params"] = [p.arg for p in a.posonlyargs + a.args]
            entry["dispositions"] = {
                p.arg: param_disposition(ctx, info.node, p.arg)
                for p in a.posonlyargs + a.args + a.kwonlyargs}
        funcs[qualname] = entry
    return {
        "module": ctx.module,
        "functions": funcs,
        "classes": {c: "__init__" in graph.classes[c].methods
                    for c in graph.classes},
        "aliases": dict(ctx.aliases),
        "hot_regions": [list(r) for r in ctx.hot_regions],
        "edge_sites": {q: [[t, ln] for t, ln in s]
                       for q, s in graph.edge_sites.items() if s},
        "module_sites": [[t, ln] for t, ln in graph.module_sites],
        "suppressions": {str(ln): sorted(ids)
                         for ln, ids in suppressions(ctx.source).items()},
        "xescape": list(ctx.xescape_candidates),
    }


def _empty_summary(module: Optional[str] = None) -> dict:
    return {"module": module, "functions": {}, "classes": {}, "aliases": {},
            "hot_regions": [], "edge_sites": {}, "module_sites": [],
            "suppressions": {}, "xescape": []}


# ------------------------------------------------------------ program graph

class ProgramGraph:
    """Cross-module call graph over module summaries. ``records`` maps the
    abs file path to {"display", "summary", "findings", "suppressed"}."""

    def __init__(self, records: Dict[str, dict]):
        self.records = records
        self.mod_by_name: Dict[str, str] = {}
        self.func_map: Dict[str, Node] = {}
        for path, rec in records.items():
            s = rec["summary"]
            m = s.get("module")
            if not m:
                continue
            self.mod_by_name[m] = path
            for q in s["functions"]:
                self.func_map[f"{m}.{q}"] = (path, q)
            for cname, has_init in s["classes"].items():
                if has_init:
                    # instantiation runs __init__: SomeClass() edges there
                    self.func_map.setdefault(
                        f"{m}.{cname}", (path, f"{cname}.__init__"))
        self._edges_memo: Dict[Tuple[Node, str], List[Node]] = {}

    def resolve(self, dotted: str, depth: int = 0) -> Optional[Node]:
        """Dotted call name → program node, following package re-exports
        (``from datatunerx_tpu_torch.utils import open_uri`` where ``utils/
        __init__`` re-exports it from ``storage``) a bounded number of
        hops."""
        if not dotted or depth > 8:
            return None
        hit = self.func_map.get(dotted)
        if hit is not None:
            return hit
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            path = self.mod_by_name.get(mod)
            if path is None:
                continue
            aliases = self.records[path]["summary"]["aliases"]
            head = parts[i]
            if head in aliases:
                renamed = ".".join([aliases[head]] + parts[i + 1:])
                if renamed != dotted:
                    return self.resolve(renamed, depth + 1)
            return None
        return None

    def edges_of(self, node: Node) -> List[Node]:
        return self._edges(node, "edges", "external")

    def call_edges_of(self, node: Node) -> List[Node]:
        """Only edges that execute on the caller's frame (no reference /
        nesting edges) — what DTX009's held-lock reachability follows."""
        return self._edges(node, "call_edges", "external_calls")

    def _edges(self, node: Node, local_key: str, ext_key: str) -> List[Node]:
        memo_key = (node, local_key)
        memo = self._edges_memo.get(memo_key)
        if memo is not None:
            return memo
        path, q = node
        s = self.records[path]["summary"]
        f = s["functions"].get(q)
        out: List[Node] = []
        if f is not None:
            out = [(path, t) for t in f[local_key] if t in s["functions"]]
            for dotted, _ln in f[ext_key]:
                hit = self.resolve(dotted)
                if hit is not None:
                    out.append(hit)
        self._edges_memo[memo_key] = out
        return out


def _module_hot_roots(summary: dict, config: LintConfig) -> Set[str]:
    """Summary-form mirror of rules.host_sync.hot_roots: hot-pattern
    functions, functions defined in a hot region, and call targets of
    hot-region call sites."""
    funcs = summary["functions"]
    pats = tuple(config.hot_functions)
    roots = {q for q, f in funcs.items()
             if any(fnmatch.fnmatchcase(f["name"], p) for p in pats)}
    regions = [tuple(r) for r in summary["hot_regions"]]
    if regions:
        def in_region(line: int) -> bool:
            return any(s <= line <= e for s, e in regions)

        for q, f in funcs.items():
            if in_region(f["lineno"]):
                roots.add(q)
        for _q, sites in summary["edge_sites"].items():
            for target, ln in sites:
                if in_region(ln):
                    roots.add(target)
        for target, ln in summary["module_sites"]:
            if in_region(ln):
                roots.add(target)
    return roots


def _intra_reachable(summary: dict, roots: Set[str]) -> Set[str]:
    funcs = summary["functions"]
    seen: Set[str] = set()
    stack = [q for q in roots if q in funcs]
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(t for t in funcs[cur]["edges"] if t in funcs)
    return seen


# ---------------------------------------------------------- program passes

def _program_dtx001(prog: ProgramGraph, config: LintConfig) -> List[Finding]:
    """Sync sites in functions hot ONLY through cross-module reachability
    (module-local hot paths are already the per-module rule's)."""
    local_hot: Dict[str, Set[str]] = {}
    stack: List[Tuple[Node, Node]] = []
    for path, rec in prog.records.items():
        s = rec["summary"]
        roots = _module_hot_roots(s, config)
        local_hot[path] = _intra_reachable(s, roots)
        # sorted: the root a finding names must not depend on the set's
        # hash order, or the message (a baseline key) changes run to run
        stack.extend(((path, q), (path, q))
                     for q in sorted(roots) if q in s["functions"])
    origin: Dict[Node, Node] = {}
    while stack:
        node, root = stack.pop()
        if node in origin:
            continue
        origin[node] = root
        stack.extend((n, root) for n in prog.edges_of(node))
    out: List[Finding] = []
    for node in sorted(origin):
        path, q = node
        if q in local_hot.get(path, ()):
            continue
        rec = prog.records[path]
        f = rec["summary"]["functions"].get(q)
        if f is None:
            continue
        rpath, rq = origin[node]
        root_desc = f"{prog.records[rpath]['display']}::{rq}"
        for ln, col, label in f["sync_sites"]:
            out.append(Finding(
                "DTX001", rec["display"], ln, col,
                f"{label} in hot path ({q} is reachable from {root_desc} "
                "via the program call graph); this blocks the host on the "
                "device stream every step — move it behind a logging "
                "boundary or use MetricsBuffer"))
    return out


def _param_for(f: dict, arg) -> Optional[str]:
    if isinstance(arg, int):
        params = f.get("params", [])
        return params[arg] if 0 <= arg < len(params) else None
    return arg if arg in f.get("dispositions", {}) else None


def _program_dtx007(prog: ProgramGraph) -> List[Finding]:
    """Adjudicate handle-passed-to-internal-callee candidates: if EVERY
    target is an internal function that merely drops the parameter, the
    caller still leaks the handle."""
    out: List[Finding] = []
    for path in sorted(prog.records):
        rec = prog.records[path]
        s = rec["summary"]
        for cand in s["xescape"]:
            if not cand["targets"]:
                continue
            callee_desc = None
            all_drop = True
            for t in cand["targets"]:
                callee = t["callee"]
                if "." not in callee:
                    node = (path, callee) if callee in s["functions"] \
                        else None
                else:
                    node = prog.resolve(callee)
                f = (prog.records[node[0]]["summary"]["functions"]
                     .get(node[1]) if node is not None else None)
                pname = _param_for(f, t["arg"]) if f is not None else None
                if pname is None \
                        or f["dispositions"].get(pname, "escapes") != "drops":
                    all_drop = False  # unknown/external/disposing: escape
                    break
                callee_desc = callee
            if all_drop:
                out.append(Finding(
                    "DTX007", rec["display"], cand["line"], cand["col"],
                    f"{cand['kind']} handle `{cand['var']}` is only passed "
                    f"to {callee_desc}(), which neither closes, stores, nor "
                    "hands it on (program-graph escape analysis) — the "
                    "handle still leaks when the caller returns"))
    return out


def _program_dtx009(prog: ProgramGraph) -> List[Finding]:
    """Locked calls whose callee's reachable closure contains a blocking
    site: flagged at the call site, with the blocking leaf named."""
    direct: Dict[Node, Tuple[str, int]] = {}
    for path, rec in prog.records.items():
        for q, f in rec["summary"]["functions"].items():
            if f["blocking_sites"]:
                ln, _col, label = f["blocking_sites"][0]
                direct[(path, q)] = (label, ln)
    memo: Dict[Node, Optional[Node]] = {}

    def reach_blocker(start: Node) -> Optional[Node]:
        if start in memo:
            return memo[start]
        seen: Set[Node] = set()
        stack = [start]
        hit: Optional[Node] = None
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if cur in direct:
                hit = cur
                break
            stack.extend(prog.call_edges_of(cur))
        memo[start] = hit
        return hit

    out: List[Finding] = []
    for path in sorted(prog.records):
        rec = prog.records[path]
        s = rec["summary"]
        for q in sorted(s["functions"]):
            for lc in s["functions"][q]["locked_calls"]:
                if "local" in lc:
                    target: Optional[Node] = (path, lc["local"])
                    if lc["local"] not in s["functions"]:
                        target = None
                    name = lc["local"]
                else:
                    target = prog.resolve(lc["ext"])
                    name = lc["ext"]
                if target is None:
                    continue
                blocker = reach_blocker(target)
                if blocker is None:
                    continue
                label, bln = direct[blocker]
                bdisp = prog.records[blocker[0]]["display"]
                out.append(Finding(
                    "DTX009", rec["display"], lc["line"], lc["col"],
                    f"{name}() called while holding {lc['lock']} reaches "
                    f"{label} ({bdisp}:{bln}, via the program call graph) "
                    "— every thread contending on the lock convoys behind "
                    "an unbounded operation; move the call outside the "
                    "critical section or add a timeout"))
    return out


def _program_dtx011(prog: ProgramGraph) -> List[Finding]:
    """Lock-order inversions over the program graph: lexical nesting
    edges from every module, plus call-chain edges — a call made under a
    lock to a function whose reachable closure (call-only edges, DTX009's
    reachability) acquires another lock. Cycles are potential ABBA
    deadlocks; cycles provable from ONE module's lexical edges alone are
    the per-module DTX011's and are skipped here."""
    # lock-id edge → evidence {display, line, col, kind, mod, desc}
    edges: Dict[Tuple[str, str], dict] = {}

    def note(a: str, b: str, ev: dict):
        edges.setdefault((a, b), ev)

    # reachable lock acquisitions per node (over call-only edges)
    acq_memo: Dict[Node, Dict[str, Tuple[Node, int]]] = {}

    def reach_acquires(start: Node) -> Dict[str, Tuple[Node, int]]:
        hit = acq_memo.get(start)
        if hit is not None:
            return hit
        found: Dict[str, Tuple[Node, int]] = {}
        seen: Set[Node] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            f = prog.records[cur[0]]["summary"]["functions"].get(cur[1])
            if f is None:
                continue
            for lid, ln in f.get("lock_acquires", ()):
                found.setdefault(lid, (cur, ln))
            stack.extend(prog.call_edges_of(cur))
        acq_memo[start] = found
        return found

    for path in sorted(prog.records):
        rec = prog.records[path]
        s = rec["summary"]
        for q in sorted(s["functions"]):
            f = s["functions"][q]
            for a, b, ln in f.get("lock_edges", ()):
                note(a, b, {"display": rec["display"], "line": ln,
                            "col": 0, "kind": "lex", "mod": path,
                            "desc": f"{b} acquired in {q} while holding "
                                    f"{a}"})
            for lc in f.get("locked_calls", ()):
                held = lc.get("lock_id")
                if not held:
                    continue
                if "local" in lc:
                    target: Optional[Node] = (path, lc["local"])
                    if lc["local"] not in s["functions"]:
                        target = None
                    name = lc["local"]
                else:
                    target = prog.resolve(lc["ext"])
                    name = lc["ext"]
                if target is None:
                    continue
                for lid, (leaf, lln) in sorted(reach_acquires(target)
                                               .items()):
                    if lid == held:
                        continue
                    leaf_disp = prog.records[leaf[0]]["display"]
                    note(held, lid, {
                        "display": rec["display"], "line": lc["line"],
                        "col": lc["col"], "kind": "call", "mod": path,
                        "desc": f"{name}() called in {q} while holding "
                                f"{lc['lock']} acquires {lid} at "
                                f"{leaf_disp}:{lln} (via the program "
                                "call graph)"})

    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: List[Finding] = []
    seen_cycles: Set[frozenset] = set()
    for (a, b) in sorted(edges):
        path_ids = shortest_path(graph, b, a)
        if path_ids is None:
            continue
        cycle = [a] + path_ids
        key = frozenset(cycle)
        if key in seen_cycles:
            continue
        seen_cycles.add(key)
        cycle_edges = [edges[(cycle[i], cycle[i + 1])]
                       for i in range(len(cycle) - 1)
                       if (cycle[i], cycle[i + 1]) in edges]
        if cycle_edges and all(e["kind"] == "lex" for e in cycle_edges) \
                and len({e["mod"] for e in cycle_edges}) == 1:
            continue  # single-module lexical cycle: per-module DTX011's
        ev = edges[(a, b)]
        back = edges.get((cycle[-2], a))
        back_at = (f"{back['display']}:{back['line']}" if back else "?")
        chain = " -> ".join(cycle)
        out.append(Finding(
            "DTX011", ev["display"], ev["line"], ev["col"],
            f"lock-order inversion: {ev['desc']}, but the opposite order "
            f"is taken at {back_at} (cycle {chain}) — two threads "
            "interleaving these paths deadlock; acquire in one global "
            "order",
            "error"))
    return out


# -------------------------------------------------------------- the runner

@dataclass
class ProgramStats:
    files: int = 0
    analyzed: int = 0
    reused: int = 0


def _fingerprint(config: LintConfig, rules: Sequence[Rule]) -> str:
    """Cache key half that isn't per-file: rule set + every config knob +
    the EXTRACTED mesh axes (so editing parallel/mesh.py invalidates
    cached DTX005 findings in other files)."""
    payload = {
        "v": CACHE_VERSION,
        "rules": sorted(r.id for r in rules),
        "config": {f.name: list(v) if isinstance(v, tuple) else v
                   for f in dataclasses.fields(config)
                   for v in (getattr(config, f.name),)},
        "mesh": list(mesh_axes_for(config)),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _load_cache(path: str, fingerprint: str) -> dict:
    if path and os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("fingerprint") == fingerprint:
                return doc
        except (OSError, ValueError):
            pass
    return {"fingerprint": fingerprint, "modules": {}}


def _save_cache(path: str, cache: dict):
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(cache, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _analyze_file(path: str, display: str, config: LintConfig,
                  rules: Sequence[Rule]) -> dict:
    with open(path, encoding="utf-8", errors="replace") as f:
        source = f.read()
    module, is_package = module_name_for_path(path)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return {"display": display, "summary": _empty_summary(module),
                "findings": [Finding("DTX000", display, e.lineno or 0,
                                     e.offset or 0,
                                     f"syntax error: {e.msg}", "error")],
                "suppressed": 0}
    ctx = ModuleContext(display, source, tree, config, module=module,
                        is_package=is_package)
    raw: List[Finding] = []
    for rule in rules:
        if rule_enabled(config, rule.id):
            raw.extend(rule.check(ctx))
    findings, suppressed = filter_findings(raw, suppressions(source), config)
    return {"display": display, "summary": build_summary(ctx),
            "findings": findings, "suppressed": suppressed}


def _filter_program_findings(raw: List[Finding], records: Dict[str, dict],
                             config: LintConfig) -> Tuple[List[Finding], int]:
    """Program findings land on lines of files we may not have re-read
    this run — filter them against the SUMMARIES' suppression maps."""
    sup_by_display: Dict[str, Dict[int, Set[str]]] = {}
    for rec in records.values():
        sup_by_display[rec["display"]] = {
            int(ln): set(ids)
            for ln, ids in rec["summary"]["suppressions"].items()}
    kept: List[Finding] = []
    suppressed = 0
    by_file: Dict[str, List[Finding]] = {}
    for f in raw:
        by_file.setdefault(f.path, []).append(f)
    for display in sorted(by_file):
        k, s = filter_findings(by_file[display],
                               sup_by_display.get(display, {}), config)
        kept.extend(k)
        suppressed += s
    return kept, suppressed


def lint_program(paths: Sequence[str], config: Optional[LintConfig] = None,
                 rules: Optional[Sequence[Rule]] = None,
                 ) -> Tuple[LintResult, ProgramStats]:
    """The full ``dtx-torch lint`` pipeline: per-module rules (cache-accelerated)
    + the cross-module program pass. Returns (result, cache stats)."""
    from datatunerx_tpu_torch.analysis.rules import all_rules

    config = config or LintConfig()
    rules = all_rules() if rules is None else rules
    stats = ProgramStats()
    cache_path = config.resolve(config.cache) if config.cache else ""
    fingerprint = _fingerprint(config, rules)
    cache = _load_cache(cache_path, fingerprint)
    records: Dict[str, dict] = {}
    dirty = False
    for path in iter_python_files(paths, config):
        ap = os.path.abspath(path)
        if ap in records:
            continue
        display = _display_path(path, config)
        try:
            st = os.stat(ap)
        except OSError:
            continue
        stats.files += 1
        ent = cache["modules"].get(ap)
        if ent is not None and ent["mtime"] == st.st_mtime \
                and ent["size"] == st.st_size:
            records[ap] = {
                "display": display, "summary": ent["summary"],
                "findings": [Finding(**f) for f in ent["findings"]],
                "suppressed": ent["suppressed"]}
            stats.reused += 1
            continue
        rec = _analyze_file(ap, display, config, rules)
        records[ap] = rec
        cache["modules"][ap] = {
            "mtime": st.st_mtime, "size": st.st_size,
            "summary": rec["summary"],
            "findings": [f.to_json() for f in rec["findings"]],
            "suppressed": rec["suppressed"]}
        dirty = True
        stats.analyzed += 1

    result = LintResult()
    for ap in sorted(records):
        result.files += 1
        result.findings.extend(records[ap]["findings"])
        result.suppressed += records[ap]["suppressed"]

    if config.program:
        prog = ProgramGraph(records)
        wanted = {r.id for r in rules}
        raw: List[Finding] = []
        if "DTX001" in wanted and rule_enabled(config, "DTX001"):
            raw.extend(_program_dtx001(prog, config))
        if "DTX007" in wanted and rule_enabled(config, "DTX007"):
            raw.extend(_program_dtx007(prog))
        if "DTX009" in wanted and rule_enabled(config, "DTX009"):
            raw.extend(_program_dtx009(prog))
        if "DTX011" in wanted and rule_enabled(config, "DTX011"):
            raw.extend(_program_dtx011(prog))
        kept, suppressed = _filter_program_findings(raw, records, config)
        result.findings.extend(kept)
        result.suppressed += suppressed

    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if cache_path and dirty:
        _save_cache(cache_path, cache)
    return result, stats
