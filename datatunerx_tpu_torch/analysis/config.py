"""dtxlint configuration for the port: defaults + ``dtxlint-torch.toml``.

The reference linter reads the ``[tool.dtxlint]`` table of the nearest
``pyproject.toml``; that table belongs to the JAX package (its baseline,
its mesh module, its hot roots). The port reads a file of its own,
``dtxlint-torch.toml``, found by walking up from the linted path, whose
top-level keys are the same keys. Where neither ``tomllib`` (3.11+) nor
``tomli`` imports, a tiny TOML-subset reader handles the file:
``key = <python-ish literal>`` pairs (strings, ints, booleans, and
possibly-multiline lists of strings) before the first table header.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Optional, Sequence, Tuple

CONFIG_FILE = "dtxlint-torch.toml"


@dataclasses.dataclass
class LintConfig:
    """Knobs the rules and runner consult. Field names match the config
    file's keys with dashes normalized to underscores."""

    # baseline file path (relative to the config file's directory)
    baseline: str = "dtxlint-torch-baseline.json"
    # directory/file basename fragments to skip while collecting sources
    exclude: Tuple[str, ...] = ("__pycache__", ".git", "build", "dist")
    # bare-name fnmatch patterns marking hot-path roots for DTX001
    hot_functions: Tuple[str, ...] = (
        "train_step", "eval_step", "decode_step", "generate_step",
    )
    # declared mesh axis names for DTX005; empty + mesh_module set → the
    # axes are extracted from *_AXES tuple assignments in that module
    mesh_axes: Tuple[str, ...] = ()
    mesh_module: str = ""
    # rule ids disabled globally (inline suppressions handle point FPs)
    disable: Tuple[str, ...] = ()
    # per-file rule disables as "glob:RULE1,RULE2" (or "glob:all") entries —
    # the dtxlint analogue of ruff's per-file-ignores, matched against the
    # finding's display path
    per_file_disable: Tuple[str, ...] = ()
    # cross-module program analysis (call graph over the linted package):
    # DTX001/DTX007/DTX009 follow calls across files when on
    program: bool = True
    # module-summary cache file ("" disables); relative to root. Keyed on
    # each file's mtime+size so repeat `dtx-torch lint` runs skip
    # re-analysis.
    cache: str = "build/dtxlint-torch-cache.json"
    # directory the config file was found in ("" = cwd); baseline and
    # mesh_module resolve against it
    root: str = ""

    def resolve(self, path: str) -> str:
        if not path or os.path.isabs(path) or not self.root:
            return path
        return os.path.join(self.root, path)


def _parse_toml_subset(text: str) -> dict:
    """Extract the top-level key/value pairs without a TOML parser.

    Values are read with ast.literal_eval after mapping TOML's bare
    true/false; anything fancier (dates, inline tables, dotted keys) is
    skipped rather than mis-read.
    """
    lines = text.splitlines()
    out: dict = {}
    in_section = True  # top-level keys come before any table header
    buf_key: Optional[str] = None
    buf_val: list = []

    def flush():
        nonlocal buf_key, buf_val
        if buf_key is None:
            return
        raw = "\n".join(buf_val).strip()
        raw = re.sub(r"\btrue\b", "True", raw)
        raw = re.sub(r"\bfalse\b", "False", raw)
        try:
            out[buf_key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            pass
        buf_key, buf_val = None, []

    for line in lines:
        stripped = line.strip()
        header = re.match(r"^\[(.+?)\]\s*$", stripped)
        if header and buf_key is None:
            in_section = False
            continue
        if not in_section:
            continue
        if buf_key is not None:
            buf_val.append(line.split("#", 1)[0] if '"' not in line else line)
            joined = "\n".join(buf_val)
            if joined.count("[") == joined.count("]"):
                flush()
            continue
        m = re.match(r"^([A-Za-z0-9_-]+)\s*=\s*(.*)$", stripped)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if val.count("[") != val.count("]"):
            buf_key, buf_val = key, [val]
            continue
        buf_key, buf_val = key, [val]
        flush()
    flush()
    return out


def _read_table(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    try:
        import tomllib  # Python ≥ 3.11
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            tomllib = None
    if tomllib is not None:
        table = tomllib.loads(raw.decode("utf-8"))
        return {k: v for k, v in table.items() if not isinstance(v, dict)}
    return _parse_toml_subset(raw.decode("utf-8"))


def find_config_file(start: str) -> Optional[str]:
    """Walk up from ``start`` (file or directory) to the nearest
    ``dtxlint-torch.toml`` (never a pyproject: its ``[tool.dtxlint]``
    table is the JAX package's)."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        cand = os.path.join(cur, CONFIG_FILE)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def load_config(start: str = ".",
                config_file: Optional[str] = None) -> LintConfig:
    """Build a LintConfig from the nearest ``dtxlint-torch.toml`` (missing
    file → defaults)."""
    path = config_file or find_config_file(start)
    cfg = LintConfig()
    if path is None or not os.path.isfile(path):
        return cfg
    table = _read_table(path)
    fields = {f.name: f for f in dataclasses.fields(LintConfig)}
    kwargs: dict = {"root": os.path.dirname(os.path.abspath(path))}
    for key, value in table.items():
        name = key.replace("-", "_")
        if name not in fields or name == "root":
            continue
        if isinstance(value, list):
            value = tuple(str(v) for v in value)
        kwargs[name] = value
    return dataclasses.replace(cfg, **kwargs)


def mesh_axes_for(config: LintConfig) -> Tuple[str, ...]:
    """Declared mesh axis names: the configured list, else every string in
    ``*_AXES`` tuple/list assignments of the configured mesh module."""
    if config.mesh_axes:
        return tuple(config.mesh_axes)
    path = config.resolve(config.mesh_module)
    if not path or not os.path.isfile(path):
        return ()
    try:
        tree = ast.parse(open(path, encoding="utf-8").read())
    except SyntaxError:
        return ()
    axes: list = []
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(n.endswith("_AXES") or n == "AXES" for n in names):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    axes.append(elt.value)
    return tuple(dict.fromkeys(axes))


def rule_enabled(config: LintConfig, rule_id: str) -> bool:
    return rule_id not in set(config.disable)


def per_file_disabled(config: LintConfig, path: str) -> frozenset:
    """Rule ids disabled for ``path`` by ``per-file-disable`` entries
    ("glob:RULE1,RULE2" / "glob:all"), matched on /-normalized paths."""
    import fnmatch

    norm = path.replace(os.sep, "/")
    out: set = set()
    for entry in config.per_file_disable:
        glob, sep, rules = entry.partition(":")
        if not sep:
            continue
        if fnmatch.fnmatch(norm, glob.strip()) \
                or fnmatch.fnmatch(os.path.basename(norm), glob.strip()):
            out.update(r.strip() for r in rules.split(",") if r.strip())
    return frozenset(out)


__all__: Sequence[str] = (
    "CONFIG_FILE", "LintConfig", "find_config_file", "load_config",
    "mesh_axes_for",
    "per_file_disabled", "rule_enabled",
)
