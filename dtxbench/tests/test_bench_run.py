"""The command without a card, and in a directory holding only
BENCHMARK.json and the benchmark's own files: a non-zero exit and no
result line."""

import os
import shutil
import subprocess
import sys

from dtxbench.harness.env import BENCH, ROOT

ARGS = ["dtxbench/run.py", "--workload", "train.qwen1.5-7b.lora",
        "--seed", "2147483650", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + ARGS, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_non_zero():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "GPU" in out.stderr


def test_bare_directory_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "dtxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_directory_has_no_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from dtxbench.harness import spec\n"
            "spec.driver('train').run(None)\n")
    tmp = ROOT / "build" / "bare-check"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "dtxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    try:
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "datatunerx_tpu_torch" in out.stderr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
