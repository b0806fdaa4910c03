"""``dtxlint-torch --fix``: AST-anchored span edits for the mechanical rules.

Scope is deliberately narrow — a fix is only offered when it is
*provably* behavior-preserving at the AST level, and every applied fix
is validated by re-parsing and re-linting the result (a fix that does
not strictly reduce the fixable-finding count is rolled back and the
file left untouched):

  * DTX002 hoist-compile-out-of-loop — ``name = torch.compile(...)``
    (or ``torch.jit.script/trace``, ``make_graphed_callables``) directly
    in a loop body is hoisted above the (outermost enclosing) loop, but
    ONLY when the right-hand side reads no name assigned anywhere in those
    loops (``for f in fns: g = torch.compile(f)`` is NOT hoistable — ``f``
    varies — and is reported as unfixable instead of mangled). A
    ``with torch.cuda.graph(g):`` capture in a loop stays manual.
  * DTX008 wrap-import-time-device-work — a CUDA-allocating function
    DEFAULT (``def f(x, fill=torch.zeros(4, device="cuda")):``) becomes
    ``fill=None`` plus an ``if fill is None: fill = torch.zeros(...)``
    materialization at the top of the body: the classic default-argument
    deferral. Module-level constants (``TABLE = torch.ones(8).cuda()``)
    have no call-site-compatible mechanical rewrite and stay manual.
  * DTX004 prng-key-split insertion — the canonical recipe for key
    reuse: ``key, key_split1 = prng.split(key)`` is inserted
    before the anchor consumption and the anchor call is rewritten to
    consume the fresh subkey. For a straight double-consumption the
    anchor is the FIRST consuming statement (splitting after it would
    itself reuse the key); for a key consumed inside a loop but
    assigned outside, the anchor is the flagged statement in the loop
    body — the inserted split rebinds the carry each iteration. This
    fixer deliberately CHANGES runtime values: that is the point (the
    flagged code draws correlated randomness; the fix decorrelates it),
    so unlike DTX002/DTX008 it is value-changing-by-design.

The edit engine is a flat list of non-overlapping ``SpanEdit``s in
character offsets; ``apply_edits`` refuses (raises ``OverlapError``)
rather than guessing when two edits touch the same span.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

from datatunerx_tpu_torch.analysis.config import LintConfig, rule_enabled
from datatunerx_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    filter_findings,
    module_name_for_path,
    suppressions,
)
from datatunerx_tpu_torch.analysis.rules.prng import PRNG_MODULE
from datatunerx_tpu_torch.analysis.rules.retrace import COMPILE_NAMES

FIXABLE_RULES = ("DTX002", "DTX004", "DTX008")
_MAX_PASSES = 8
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_JIT_NAMES = COMPILE_NAMES


class OverlapError(ValueError):
    """Two edits touch the same span — refuse rather than guess."""


@dataclass(frozen=True)
class SpanEdit:
    start: int
    end: int
    text: str


def apply_edits(source: str, edits: Sequence[SpanEdit]) -> str:
    """Apply non-overlapping edits (insertions are zero-width spans).
    Adjacent edits are fine; overlapping ones raise OverlapError."""
    out: List[str] = []
    pos = 0
    for e in sorted(edits, key=lambda e: (e.start, e.end)):
        if e.end < e.start or e.start < 0 or e.end > len(source):
            raise OverlapError(f"edit span ({e.start}, {e.end}) out of range")
        if e.start < pos:
            raise OverlapError(
                f"edit at {e.start} overlaps a previous edit ending at {pos}")
        out.append(source[pos:e.start])
        out.append(e.text)
        pos = e.end
    out.append(source[pos:])
    return "".join(out)


def _line_offsets(source: str) -> List[int]:
    """offsets[i] = char offset where 1-based line i starts (offsets[0]
    unused); one trailing sentinel for end-of-source."""
    offsets = [0, 0]
    for i, ch in enumerate(source):
        if ch == "\n":
            offsets.append(i + 1)
    offsets.append(len(source))
    return offsets


def _node_span(offsets: List[int], node: ast.AST) -> Tuple[int, int]:
    start = offsets[node.lineno] + node.col_offset
    end = offsets[node.end_lineno] + node.end_col_offset
    return start, end


def _line_start(offsets: List[int], line: int) -> int:
    return offsets[min(line, len(offsets) - 1)]


def _find_call(ctx: ModuleContext, finding: Finding) -> Optional[ast.Call]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and node.lineno == finding.line \
                and node.col_offset == finding.col:
            return node
    return None


# ------------------------------------------------------------ DTX002 hoist

def _stores_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,
                                                          ast.Del)):
            out.add(n.id)
    return out


def _loads_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _fix_dtx002(ctx: ModuleContext, finding: Finding,
                offsets: List[int]) -> Optional[List[SpanEdit]]:
    call = _find_call(ctx, finding)
    if call is None or ctx.resolve(call.func) not in _JIT_NAMES:
        return None  # the static_argnums sub-finding anchors on the kwarg
    stmt = ctx.parents.get(call)
    if not (isinstance(stmt, ast.Assign) and stmt.value is call
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return None
    # the statement must sit DIRECTLY in a loop body; collect the chain of
    # enclosing loops up to the function/module boundary
    loops: List[ast.AST] = []
    cur: Optional[ast.AST] = stmt
    while cur is not None:
        parent = ctx.parents.get(cur)
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda, ast.ClassDef)) or parent is None:
            break
        if isinstance(parent, _LOOPS):
            loops.append(parent)
        cur = parent
    if not loops or stmt not in loops[0].body:
        return None
    mutated: Set[str] = set()
    for loop in loops:
        mutated |= _stores_in(loop)
    if _loads_in(stmt.value) & mutated:
        return None  # rhs depends on loop state: hoisting changes behavior
    outer = loops[-1]
    # whole-line statement only (no `a = 1; b = torch.compile(f)` splicing)
    line = ctx.lines[stmt.lineno - 1]
    if line[:stmt.col_offset].strip():
        return None
    tail = ctx.lines[stmt.end_lineno - 1][stmt.end_col_offset:].strip()
    if tail and not tail.startswith("#"):
        return None
    dedent = stmt.col_offset - outer.col_offset
    moved_lines = []
    for ln in range(stmt.lineno, stmt.end_lineno + 1):
        text = ctx.lines[ln - 1]
        moved_lines.append(text[dedent:] if text[:dedent].strip() == ""
                           else text)
    moved = "\n".join(moved_lines) + "\n"
    del_start = _line_start(offsets, stmt.lineno)
    del_end = _line_start(offsets, stmt.end_lineno + 1)
    ins_at = _line_start(offsets, outer.lineno)
    return [SpanEdit(ins_at, ins_at, moved),
            SpanEdit(del_start, del_end, "")]


# --------------------------------------------------- DTX008 default-arg fix

def _default_param(fn: ast.AST, node: ast.AST) -> Optional[str]:
    """Param name when ``node`` is exactly one of ``fn``'s default-value
    expressions."""
    a = fn.args
    pos_params = [p.arg for p in a.posonlyargs + a.args]
    for i, default in enumerate(a.defaults):
        if default is node:
            return pos_params[len(pos_params) - len(a.defaults) + i]
    for i, default in enumerate(a.kw_defaults):
        if default is node:
            return a.kwonlyargs[i].arg
    return None


def _fix_dtx008(ctx: ModuleContext, finding: Finding,
                offsets: List[int]) -> Optional[List[SpanEdit]]:
    call = _find_call(ctx, finding)
    if call is None:
        return None
    fn = ctx.parents.get(call)
    while fn is not None and not isinstance(fn, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
        fn = ctx.parents.get(fn)
    if fn is None:
        return None  # module/class-level device work: no mechanical rewrite
    pname = _default_param(fn, call)
    if pname is None:
        return None  # flagged call is a SUBEXPRESSION of the default
    if call.lineno != call.end_lineno:
        return None  # multiline default: keep the fix mechanical
    expr = ast.get_source_segment(ctx.source, call)
    if expr is None:
        return None
    body = fn.body
    has_doc = (isinstance(body[0], ast.Expr)
               and isinstance(body[0].value, ast.Constant)
               and isinstance(body[0].value.value, str))
    if has_doc and len(body) > 1:
        insert_before = body[1]  # keep the docstring first
        indent = " " * insert_before.col_offset
        ins_at = _line_start(offsets, insert_before.lineno)
    elif has_doc:
        # docstring-only body: insert AFTER it (inserting before would
        # demote it to a bare string and destroy __doc__)
        indent = " " * body[0].col_offset
        ins_at = _line_start(offsets, body[0].end_lineno + 1)
    else:
        insert_before = body[0]
        indent = " " * insert_before.col_offset
        ins_at = _line_start(offsets, insert_before.lineno)
    guard = (f"{indent}if {pname} is None:\n"
             f"{indent}    {pname} = {expr}\n")
    start, end = _node_span(offsets, call)
    return [SpanEdit(start, end, "None"), SpanEdit(ins_at, ins_at, guard)]


# ----------------------------------------------- DTX004 key-split insertion

_PRIOR_LINE_RE = re.compile(r"already consumed at line (\d+)")


def _key_arg_node(call: ast.Call) -> Optional[ast.Name]:
    """The Name node the call consumes as its PRNG key (first positional
    arg or ``key=``) — the same extraction DTX004's rule does."""
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "key" and isinstance(kw.value, ast.Name):
            return kw.value
    return None


def _enclosing_stmt(ctx: ModuleContext, node: ast.AST) -> Optional[ast.stmt]:
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = ctx.parents.get(cur)
    return cur if isinstance(cur, ast.stmt) else None


def _whole_line_stmt(ctx: ModuleContext, stmt: ast.stmt) -> bool:
    """True when the statement owns its line(s): nothing before it on its
    first line, nothing but a comment after it on its last (the same guard
    DTX002's hoist applies — no `a = 1; b = f(k)` splicing)."""
    line = ctx.lines[stmt.lineno - 1]
    if line[:stmt.col_offset].strip():
        return False
    tail = ctx.lines[stmt.end_lineno - 1][stmt.end_col_offset:].strip()
    return not tail or tail.startswith("#")


def _fresh_name(ctx: ModuleContext, base: str) -> str:
    used = {n.id for n in ast.walk(ctx.tree) if isinstance(n, ast.Name)}
    for fn in ast.walk(ctx.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn.args
            used.update(p.arg for p in a.posonlyargs + a.args + a.kwonlyargs)
    i = 1
    while f"{base}_split{i}" in used:
        i += 1
    return f"{base}_split{i}"


def _first_consumer_at(ctx: ModuleContext, line: int,
                       name: str) -> Optional[ast.Call]:
    """Earliest ops/prng call on ``line`` consuming ``name`` as its key
    (the prior consumption the finding message points at)."""
    best: Optional[ast.Call] = None
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and node.lineno == line):
            continue
        resolved = ctx.resolve(node.func)
        if not resolved or not resolved.startswith(PRNG_MODULE):
            continue
        key = _key_arg_node(node)
        if key is None or key.id != name:
            continue
        if best is None or node.col_offset < best.col_offset:
            best = node
    return best


def _fix_dtx004(ctx: ModuleContext, finding: Finding,
                offsets: List[int]) -> Optional[List[SpanEdit]]:
    flagged = _find_call(ctx, finding)
    if flagged is None:
        return None
    key = _key_arg_node(flagged)
    if key is None:
        return None
    # the split expression reuses the flagged call's own module path
    # (`prng.uniform(k)` → `prng.split`), so the insertion can never
    # reference a name the module didn't import; a bare imported name
    # (`from datatunerx_tpu_torch.ops.prng import uniform`) has no such
    # path → manual
    if not isinstance(flagged.func, ast.Attribute):
        return None
    base_src = ast.get_source_segment(ctx.source, flagged.func.value)
    if base_src is None or "\n" in base_src:
        return None
    m = _PRIOR_LINE_RE.search(finding.message)
    if m:
        # double consumption: anchor at the FIRST consuming statement —
        # splitting before it rebinds the key, so the flagged (later)
        # consumption draws from the new carry, not the consumed value
        anchor_call = _first_consumer_at(ctx, int(m.group(1)), key.id)
        if anchor_call is None:
            return None
    else:
        # loop-reuse: anchor at the flagged statement inside the loop —
        # the inserted split rebinds the carry every iteration
        anchor_call = flagged
    stmt = _enclosing_stmt(ctx, anchor_call)
    if stmt is None or not _whole_line_stmt(ctx, stmt):
        return None
    target = _key_arg_node(anchor_call)
    if target is None or target.id != key.id:
        return None
    fresh = _fresh_name(ctx, key.id)
    indent = " " * stmt.col_offset
    ins = (f"{indent}{key.id}, {fresh} = {base_src}.split({key.id})\n")
    ins_at = _line_start(offsets, stmt.lineno)
    kstart, kend = _node_span(offsets, target)
    return [SpanEdit(ins_at, ins_at, ins), SpanEdit(kstart, kend, fresh)]


_FIXERS = {"DTX002": _fix_dtx002, "DTX004": _fix_dtx004,
           "DTX008": _fix_dtx008}


def _overlaps(group: Sequence[SpanEdit],
              spans: Sequence[Tuple[int, int]]) -> bool:
    """True when any edit in ``group`` intersects an already-chosen span.
    Zero-width insertions never overlap anything (apply_edits orders
    same-offset insertions stably)."""
    for ge in group:
        for s, e in spans:
            if max(ge.start, s) < min(ge.end, e):
                return True
    return False


# ------------------------------------------------------------ fix loop

@dataclass
class FixResult:
    path: str
    applied: int = 0
    unfixable: int = 0
    changed: bool = False


def _fixable_findings(source: str, path: str, config: LintConfig,
                      rule_ids: Sequence[str]) -> Tuple[List[Finding],
                                                        Optional[ModuleContext]]:
    from datatunerx_tpu_torch.analysis.rules import rules_by_id

    module, is_package = module_name_for_path(path)
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return [], None
    ctx = ModuleContext(path, source, tree, config, module=module,
                        is_package=is_package)
    raw: List[Finding] = []
    for rule in rules_by_id(list(rule_ids)):
        if rule_enabled(config, rule.id):
            raw.extend(rule.check(ctx))
    findings, _ = filter_findings(raw, suppressions(source), config)
    return findings, ctx


def fix_source(source: str, path: str,
               config: Optional[LintConfig] = None,
               rule_ids: Sequence[str] = FIXABLE_RULES,
               ) -> Tuple[str, FixResult]:
    """Iteratively apply safe fixes to one module's source. Each pass
    re-parses and re-lints; a pass that fails to strictly reduce the
    fixable-finding count is rolled back."""
    config = config or LintConfig()
    rule_ids = [r for r in rule_ids if r in _FIXERS]
    res = FixResult(path=path)
    for _ in range(_MAX_PASSES):
        findings, ctx = _fixable_findings(source, path, config, rule_ids)
        if ctx is None or not findings:
            res.unfixable = len(findings)
            break
        offsets = _line_offsets(source)
        chosen: List[SpanEdit] = []
        spans: List[Tuple[int, int]] = []
        for finding in findings:
            fixer = _FIXERS.get(finding.rule)
            group = fixer(ctx, finding, offsets) if fixer else None
            if not group:
                continue
            if _overlaps(group, spans):
                continue  # refused: the next pass re-derives it post-shift
            chosen.extend(group)
            spans.extend((ge.start, ge.end) for ge in group)
        if not chosen:
            res.unfixable = len(findings)
            break
        try:
            candidate = apply_edits(source, chosen)
            ast.parse(candidate)
        except (OverlapError, SyntaxError):
            res.unfixable = len(findings)
            break
        after, _ = _fixable_findings(candidate, path, config, rule_ids)
        if len(after) >= len(findings):
            res.unfixable = len(findings)
            break  # the fix didn't resolve its finding: roll back
        res.applied += len(findings) - len(after)
        source = candidate
        res.changed = True
    else:
        findings, _ = _fixable_findings(source, path, config, rule_ids)
        res.unfixable = len(findings)
    return source, res


def fix_paths(paths: Sequence[str], config: Optional[LintConfig] = None,
              rule_ids: Sequence[str] = FIXABLE_RULES,
              write: bool = True) -> List[FixResult]:
    """Run the fixer over files/trees. ``write=False`` is ``--fix
    --check``: report what WOULD change, touch nothing."""
    from datatunerx_tpu_torch.analysis.core import _display_path, iter_python_files

    config = config or LintConfig()
    results: List[FixResult] = []
    for path in iter_python_files(paths, config):
        with open(path, encoding="utf-8", errors="replace") as f:
            source = f.read()
        fixed, res = fix_source(source, path, config=config,
                                rule_ids=rule_ids)
        res.path = _display_path(path, config)
        if res.changed and write:
            tmp = f"{path}.dtxfix.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(fixed)
            os.replace(tmp, path)
        results.append(res)
    return results
