"""DTX005: mesh axis names not declared by the mesh.

Every literal axis name the port hands its mesh must be an axis the mesh
declares (``parallel/mesh.py::MESH_AXES`` — dp/fsdp/tp/sp): the axes of
``Mesh.group``/``ranks``/``index``/``extent`` (a tuple of names), the
``axes=``/``axis`` arguments of ``parallel/sharding``'s functions, and
string subscripts of a mesh's ``shape``/``coords`` tables. A typo'd or
stale axis name ("data", "mdl", "x") fails far from the typo: a
``KeyError`` deep in a collective's setup on one rank while the others
wait in theirs, or, for a group the mesh never built, a collective over
the wrong ranks. Variable axis names (ring attention's ``axis``
parameter) are out of static reach and not checked.

Declared axes come from the config's ``mesh-axes`` when set, else are
extracted from ``*_AXES`` assignments of the configured ``mesh-module``.
When neither yields axis names the rule stays quiet (nothing to check
against). The mesh module itself is exempt — it's the declaration site.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Tuple

from datatunerx_tpu_torch.analysis.config import mesh_axes_for
from datatunerx_tpu_torch.analysis.core import Finding, ModuleContext, Rule

# Mesh methods that take a tuple of axis names first
_MESH_METHODS = ("group", "ranks", "index", "extent")
# Mesh tables keyed by axis name
_MESH_TABLES = ("shape", "coords")
_SHARDING = "datatunerx_tpu_torch.parallel.sharding."
# parallel/sharding functions → positional index of their axis argument
_SHARDING_AXIS_ARG = {"gather_dim": 3}


def _literal_names(node: ast.AST) -> bool:
    """A tuple/list literal of string constants (the Mesh axes shape)."""
    return isinstance(node, (ast.Tuple, ast.List)) and bool(node.elts) \
        and all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.elts)


class MeshAxisDrift(Rule):
    id = "DTX005"
    name = "mesh-axis-drift"
    severity = "error"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        axes = set(mesh_axes_for(ctx.config))
        if not axes:
            return []
        mesh_module = ctx.config.resolve(ctx.config.mesh_module)
        if mesh_module and os.path.normpath(os.path.abspath(ctx.path)) \
                == os.path.normpath(os.path.abspath(mesh_module)):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            args, what = self._axis_args(ctx, node)
            for name, strnode in self._axis_strings(args):
                if name not in axes:
                    out.append(self.finding(
                        ctx, strnode,
                        f"axis {name!r} is not a declared mesh axis "
                        f"({', '.join(sorted(axes))}) — stale or typo'd "
                        + what))
        return out

    def _axis_args(self, ctx: ModuleContext, node: ast.AST):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr in _MESH_TABLES \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            return [node.slice], (f"mesh.{node.value.attr}[...] raises "
                                  "KeyError far from the typo")
        if not isinstance(node, ast.Call):
            return [], ""
        resolved = ctx.resolve(node.func) or ""
        if resolved.startswith(_SHARDING):
            fn = resolved[len(_SHARDING):]
            args = [kw.value for kw in node.keywords
                    if kw.arg in ("axes", "axis")]
            idx = _SHARDING_AXIS_ARG.get(fn)
            if idx is not None and len(node.args) > idx:
                args.append(node.args[idx])
            return args, (f"{fn} over an unbuilt group fails in the "
                          "collective's setup, far from the typo")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MESH_METHODS and node.args \
                and _literal_names(node.args[0]):
            return [node.args[0]], (f"Mesh.{node.func.attr} over an unbuilt "
                                    "group fails in the collective's setup, "
                                    "far from the typo")
        return [], ""

    def _axis_strings(self, args) -> Iterable[Tuple[str, ast.AST]]:
        stack = list(args)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Tuple, ast.List)):
                stack.extend(node.elts)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                yield node.value, node
