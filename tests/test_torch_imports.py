"""The port stands alone: every module of ``datatunerx_tpu_torch`` and
``chip_smoke.py`` import with ``jax``, ``jaxlib`` and ``datatunerx_tpu``
blocked, its entry points default to CUDA and refuse to carry on without
it, and ``chip_smoke.py`` fails (printing no result) without a card or
outside a checkout."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        BLOCKED = ("jax", "jaxlib", "datatunerx_tpu")

        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in self.BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import datatunerx_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    assert not any(m.split(".")[0] in Block.BLOCKED for m in sys.modules)
    print("IMPORTED", len(names))
""")


def test_every_module_imports_without_jax():
    code = f"ROOT = {ROOT!r}\n" + _BLOCKER
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[1])
    assert n >= 17  # the slice's modules


def test_engine_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run")
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine("preset:debug", template="vanilla", max_seq_len=256,
                      slots=2, kv_block_size=16)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
