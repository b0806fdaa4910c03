"""dtxlint framework: Finding/Rule/ModuleContext + the file runner.

A rule is a self-contained class with an ``id``, ``severity``, and a
``check(ctx) -> Iterable[Finding]``; the runner parses each file once,
hands every enabled rule the shared ModuleContext (AST, import aliases,
intra-module call graph, config), then filters findings through inline
``# dtxlint: disable=RULE`` suppressions. Baseline handling (carrying
pre-existing debt) lives in ``baseline.py``; this layer only reports.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from datatunerx_tpu_torch.analysis.callgraph import (
    ModuleGraph,
    collect_aliases,
    resolve_name,
)
from datatunerx_tpu_torch.analysis.config import (
    LintConfig,
    per_file_disabled,
    rule_enabled,
)

_SUPPRESS_RE = re.compile(r"#\s*dtxlint:\s*disable=([A-Za-z0-9_,\s]+)")
_HOT_BEGIN_RE = re.compile(r"#\s*dtxlint:\s*hot-begin\b")
_HOT_END_RE = re.compile(r"#\s*dtxlint:\s*hot-end\b")


def hot_region_spans(source: str) -> List[Tuple[int, int]]:
    """Inclusive (start, end) line ranges between ``# dtxlint: hot-begin``
    and ``# dtxlint: hot-end`` markers. An unmatched begin extends to EOF
    (the conservative direction for a hot-path rule); nested begins fold
    into the enclosing region."""
    spans: List[Tuple[int, int]] = []
    start = None
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        if _HOT_BEGIN_RE.search(line):
            if start is None:
                start = i
        elif _HOT_END_RE.search(line) and start is not None:
            spans.append((start, i))
            start = None
    if start is not None:
        spans.append((start, len(lines)))
    return spans


def module_name_for_path(path: str) -> Tuple[Optional[str], bool]:
    """(dotted module name, is_package) for a file inside a package tree —
    climbs parent directories while ``__init__.py`` exists. Files outside
    any package get (None, False); relative imports then stay unresolved."""
    ap = os.path.abspath(path)
    d, base = os.path.split(ap)
    if not base.endswith(".py"):
        return None, False
    is_package = base == "__init__.py"
    parts: List[str] = [] if is_package else [base[:-3]]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
    if not parts:
        return None, False
    return ".".join(parts), is_package


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"

    def key(self) -> Tuple[str, str, str]:
        """Line-number-free identity used for baseline matching, so debt
        entries survive unrelated edits above them."""
        return (self.rule, self.path.replace(os.sep, "/"), self.message)

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path.replace(os.sep, "/"),
            "line": self.line, "col": self.col,
            "message": self.message, "severity": self.severity,
        }


class ModuleContext:
    """Per-file state shared by every rule (parse once, analyze N times)."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 config: LintConfig, module: Optional[str] = None,
                 is_package: bool = False):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config = config
        self.module = module
        self.is_package = is_package
        self.aliases = collect_aliases(tree, module=module,
                                       is_package=is_package)
        self.hot_regions = hot_region_spans(source)
        # DTX007 cross-module candidates: resource handles whose only
        # disposition is "passed to a resolvable internal callee" — the
        # program pass adjudicates them against the callee's summary
        self.xescape_candidates: List[dict] = []
        self._graph: Optional[ModuleGraph] = None
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def in_hot_region(self, line: int) -> bool:
        return any(s <= line <= e for s, e in self.hot_regions)

    @property
    def graph(self) -> ModuleGraph:
        if self._graph is None:
            self._graph = ModuleGraph(self.tree, self.aliases)
        return self._graph

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def resolve(self, node: ast.AST) -> Optional[str]:
        return resolve_name(node, self.aliases)


class Rule:
    """Base class; subclasses set ``id``/``name``/``severity`` and
    implement ``check``."""

    id = "DTX000"
    name = "unnamed"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message, self.severity)


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0

    def extend(self, other: "LintResult"):
        self.findings.extend(other.findings)
        self.suppressed += other.suppressed
        self.files += other.files


def suppressions(source: str) -> Dict[int, Set[str]]:
    """Line number → rule ids disabled on that line (``all`` disables
    everything)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return out


def _default_rules() -> Sequence[Rule]:
    from datatunerx_tpu_torch.analysis.rules import all_rules

    return all_rules()


def filter_findings(raw: Sequence[Finding], sup: Dict[int, Set[str]],
                    config: LintConfig) -> Tuple[List[Finding], int]:
    """Apply inline suppressions + per-file config disables to raw findings;
    returns (kept, suppressed_count). ``sup`` is a ``suppressions()`` map —
    passed in (rather than derived from source here) so the program-level
    pass can filter findings against CACHED modules without re-reading
    their files."""
    kept: List[Finding] = []
    suppressed = 0
    for f in sorted(raw, key=lambda f: (f.line, f.col, f.rule)):
        pfd = per_file_disabled(config, f.path)
        if "all" in pfd or f.rule in pfd:
            continue  # config-level: not counted as inline suppression
        disabled = sup.get(f.line, ())
        if "all" in disabled or f.rule in disabled:
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


def lint_source(source: str, path: str = "<string>",
                config: Optional[LintConfig] = None,
                rules: Optional[Sequence[Rule]] = None,
                module: Optional[str] = None,
                is_package: bool = False) -> LintResult:
    config = config or LintConfig()
    rules = _default_rules() if rules is None else rules
    result = LintResult(files=1)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        result.findings.append(Finding(
            "DTX000", path, e.lineno or 0, e.offset or 0,
            f"syntax error: {e.msg}", "error"))
        return result
    ctx = ModuleContext(path, source, tree, config, module=module,
                        is_package=is_package)
    raw: List[Finding] = []
    for rule in rules:
        if not rule_enabled(config, rule.id):
            continue
        raw.extend(rule.check(ctx))
    result.findings, result.suppressed = filter_findings(
        raw, suppressions(source), config)
    return result


def lint_file(path: str, config: Optional[LintConfig] = None,
              rules: Optional[Sequence[Rule]] = None,
              display_path: Optional[str] = None) -> LintResult:
    with open(path, encoding="utf-8", errors="replace") as f:
        source = f.read()
    module, is_package = module_name_for_path(path)
    return lint_source(source, path=display_path or path, config=config,
                       rules=rules, module=module, is_package=is_package)


def iter_python_files(paths: Sequence[str],
                      config: LintConfig) -> Iterable[str]:
    excluded = tuple(config.exclude)

    def skip(name: str) -> bool:
        return name.startswith(".") or name in excluded

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if not skip(d))
            for fn in sorted(files):
                if fn.endswith(".py") and not skip(fn):
                    yield os.path.join(root, fn)


def _display_path(path: str, config: LintConfig) -> str:
    """Project-root-relative path when the file lives under the config
    root (else cwd-relative, else as given) — finding keys must not depend
    on the invoker's cwd or absolute-vs-relative arguments, or baseline
    entries written by one invocation silently stop matching in another."""
    ap = os.path.abspath(path)
    for base in (config.root, os.getcwd()):
        if not base:
            continue
        try:
            rel = os.path.relpath(ap, base)
        except ValueError:  # different drive (windows)
            continue
        if not rel.startswith(".."):
            return rel
    return path


def lint_paths(paths: Sequence[str], config: Optional[LintConfig] = None,
               rules: Optional[Sequence[Rule]] = None) -> LintResult:
    config = config or LintConfig()
    rules = _default_rules() if rules is None else rules
    result = LintResult()
    for path in iter_python_files(paths, config):
        result.extend(lint_file(path, config=config, rules=rules,
                                display_path=_display_path(path, config)))
    return result
