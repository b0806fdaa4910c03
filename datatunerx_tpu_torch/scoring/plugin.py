"""Scoring plugins: the Scoring CR's ``plugin{loadPlugin, name, parameters}``
contract (reference pkg/util/generate/generate.go:343-358).

A plugin is a Python entrypoint ``module:function`` (or a registered name)
called as ``fn(inference_url, parameters) -> str | float`` returning the score.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, Callable] = {}

# ``module:function`` plugin paths execute arbitrary code in the OPERATOR
# process, and any CR author can set them — so they are gated behind an
# operator-side allowlist of module prefixes. Empty by default: only
# explicitly-registered plugins work unless the operator opts in via
# DTX_SCORING_PLUGIN_PREFIXES (comma-separated, e.g. "mycompany.scoring.").
PLUGIN_PREFIX_ENV = "DTX_SCORING_PLUGIN_PREFIXES"


def _allowed_prefixes() -> Tuple[str, ...]:
    raw = os.environ.get(PLUGIN_PREFIX_ENV, "")
    return tuple(p.strip() for p in raw.split(",") if p.strip())


def register_plugin(name: str, fn: Callable) -> None:
    _REGISTRY[name] = fn


def resolve_plugin(name: str) -> Callable:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if ":" in name:
        module, _, attr = name.partition(":")
        if not any(module.startswith(p) for p in _allowed_prefixes()):
            raise PermissionError(
                f"scoring plugin module {module!r} is not allowlisted; set "
                f"{PLUGIN_PREFIX_ENV} on the operator to permit it"
            )
        mod = importlib.import_module(module)
        return getattr(mod, attr)
    raise KeyError(
        f"scoring plugin {name!r} not registered and not a module:function path"
    )
