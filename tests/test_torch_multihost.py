"""The port's trainer CLI as several processes on the CPU (gloo), through
``operator/backends.LocalProcessBackend(num_hosts=2)``: each host a rank
wired by the ``DTX_*`` env, rank 0 writing the checkpoint and manifest.

- ``--mesh dp=2`` and ``--mesh sp=2 --attention ring`` (unpacked rows, so
  the ring runs) against the JAX CLI on a 2-device CPU mesh with the same
  flags and base (``preset:debug``'s JAX weights as an export), at the
  default LoRA dropout 0.1: every step's loss within rtol
  1e-5 (step 1) and 1e-4 (later steps), as ``tests/test_training.py``'s
  sharded cases hold the reference to itself;
- a 2-host ``dp=2`` job reaches Succeeded with the losses of a one-host
  run of the same global batch."""

import json
import os
import subprocess
import sys
import time

import pytest

from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer
from datatunerx_tpu_torch.operator.backends import (
    LocalProcessBackend,
    _pkg_root,
)
from test_torch_train_cli import _argv


@pytest.fixture(scope="module")
def debug_export(tmp_path_factory):
    """``preset:debug``'s JAX weights as an export: both CLIs train from
    the same base."""
    from datatunerx_tpu.training.checkpoint import export_merged_model

    cfg, params, _ = load_model_and_tokenizer("preset:debug")
    d = tmp_path_factory.mktemp("multihost_base")
    export_merged_model(params, cfg, str(d))
    return str(d)


def _losses(tmp, name):
    with open(tmp / name / "watch" / "trainer_log.jsonl") as f:
        return [json.loads(line)["loss"] for line in f]


def _jax_cli(tmp, name, devices, **extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=_pkg_root() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = open(tmp / f"{name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "datatunerx_tpu.tuning.train",
         *_argv(tmp, name, **extra)], stdout=log, stderr=subprocess.STDOUT,
        env=env, cwd=str(tmp))


def _wait(backend, names, procs=(), timeout=300):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(backend.status(n) != "Running" for n in names) and all(
                p.poll() is not None for p in procs):
            return
        time.sleep(0.3)
    for n in names:
        backend.delete(n)
    for p in procs:
        p.kill()
    raise AssertionError(f"jobs {names} still running after {timeout} s")


@pytest.mark.parametrize("mesh,extra", [
    ("dp=2", dict(attention="xla")),
    ("sp=2", dict(attention="ring", pack_sequences="false")),
], ids=["dp2", "sp2-ring"])
def test_cli_under_a_mesh_matches_the_jax_cli(tmp_path, debug_export, mesh,
                                             extra):
    flags = dict(mesh=mesh, lora_dropout="0.1", max_steps="3",
                 block_size="64", model_name_or_path=debug_export, **extra)
    backend = LocalProcessBackend(str(tmp_path / "jobs"), device="cpu")
    jax_proc = _jax_cli(tmp_path, "jax", 2, **flags)
    backend.submit("port", {"args": _argv(tmp_path, "port", **flags),
                            "num_hosts": 2})
    _wait(backend, ["port"], [jax_proc])
    assert jax_proc.returncode == 0, (tmp_path / "jax.log").read_text()[-3000:]
    assert backend.status("port") == "Succeeded", backend.log_tail("port")
    want, got = _losses(tmp_path, "jax"), _losses(tmp_path, "port")
    assert len(got) == len(want) == 3
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert got[1:] == pytest.approx(want[1:], rel=1e-4)
    with open(tmp_path / "storage" / "port" / "manifest.json") as f:
        manifest = json.load(f)
    dims = dict(part.split("=") for part in mesh.split(","))
    assert manifest["mesh"] == {ax: int(dims.get(ax, 1)) for ax in
                                ("dp", "fsdp", "tp", "sp")}


def test_two_host_job_trains_as_one_host(tmp_path):
    backend = LocalProcessBackend(str(tmp_path / "jobs"), device="cpu")
    one = _argv(tmp_path, "one", per_device_train_batch_size="4",
                lora_dropout="0.1")
    two = _argv(tmp_path, "two", per_device_train_batch_size="2",
                lora_dropout="0.1", mesh="dp=2")
    backend.submit("one", {"args": one})
    backend.submit("two", {"args": two, "num_hosts": 2})
    _wait(backend, ["one", "two"])
    assert backend.status("one") == "Succeeded", backend.log_tail("one")
    assert backend.status("two") == "Succeeded", backend.log_tail("two")
    assert _losses(tmp_path, "two") == pytest.approx(_losses(tmp_path, "one"),
                                                     rel=1e-5)
    jobdir = tmp_path / "jobs" / "two"
    assert (jobdir / "log.txt").exists() and (jobdir / "log.1.txt").exists()
    assert "[train]" not in (jobdir / "log.1.txt").read_text()
    with open(tmp_path / "storage" / "two" / "manifest.json") as f:
        manifest = json.load(f)
    assert os.path.exists(os.path.join(manifest["checkpoint"], "state.pt"))
    assert not backend.has_active_jobs()
