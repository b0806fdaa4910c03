"""Nothing under dtxbench/ imports JAX, Flax or the JAX package, judged by
each import's top-level name compared whole (the port's name begins with
the JAX package's); the reference imports nothing of the port either. A
CPU run of the harness loads none of them."""

import ast
import subprocess
import sys

import pytest

from dtxbench.harness.env import BENCH, FORBIDDEN, ROOT

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_tops(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "datatunerx_tpu_torch" not in set(_tops(path))


def test_top_level_comparison_is_whole():
    from dtxbench.harness import env

    saved = dict(sys.modules)
    try:
        sys.modules["datatunerx_tpu_torch_x"] = sys
        assert "datatunerx_tpu" not in env.forbidden_modules()
        sys.modules["datatunerx_tpu.models"] = sys
        assert "datatunerx_tpu" in env.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from dtxbench.tests import small\n"
            "from dtxbench.harness import env\n"
            "r = small.run('train.qwen1.5-7b.lora')\n"
            "print('FOUND', env.forbidden_modules(), r['correct'])\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert "FOUND [] True" in out.stdout, out.stderr[-2000:]
