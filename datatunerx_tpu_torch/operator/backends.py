"""Training backend: the port's trainer CLI as host subprocesses (the port
of ``LocalProcessBackend`` in ``datatunerx_tpu/operator/backends.py``).

The reference operator's controllers talk to a small protocol
(``submit/status/delete``, plus ``log_tail`` for diagnostics), so the same
state machines drive this backend: it runs ``python -m
datatunerx_tpu_torch.tuning.train <args> --device <device>`` per job in
``<workdir>/<job>`` (``cmd.txt``, ``log.txt``), with the port's package
root on ``PYTHONPATH``. Completion is the process's exit plus the
trainer's completion manifest. Status vocabulary: Pending | Running |
Succeeded | Failed | NotFound.

One host only: ``spec["num_hosts"] > 1`` raises (multi-GPU is ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import threading
from typing import Dict, Optional


def _pkg_root() -> str:
    """The directory holding ``datatunerx_tpu_torch`` (a subprocess's
    PYTHONPATH)."""
    import datatunerx_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        datatunerx_tpu_torch.__file__)))


def subprocess_env(extra_env: dict, spec_env: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _pkg_root() + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env)
    env.update(spec_env or {})
    return env


class LocalProcessBackend:
    """Runs the port's trainer CLI as one subprocess per job on
    ``device`` (``"cuda"`` by default; tests pass ``"cpu"``)."""

    def __init__(self, workdir: str, extra_env: Optional[dict] = None,
                 device: str = "cuda"):
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.extra_env = extra_env or {}
        self.device = device
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, name: str, spec: dict) -> None:
        hosts = max(1, int(spec.get("num_hosts", 1) or 1))
        if hosts > 1:
            raise NotImplementedError(
                f"job {name!r} asks for {hosts} hosts: multi-GPU training "
                "is not ported yet (ROADMAP Queue 1 item 10)")
        with self._lock:
            if name in self._procs:
                return
            jobdir = os.path.join(self.workdir, name)
            os.makedirs(jobdir, exist_ok=True)
            argv = [sys.executable, "-m", "datatunerx_tpu_torch.tuning.train",
                    *(str(a) for a in spec["args"]), "--device", self.device]
            with open(os.path.join(jobdir, "cmd.txt"), "w") as f:
                f.write(shlex.join(argv))
            log = open(os.path.join(jobdir, "log.txt"), "w")
            try:
                self._procs[name] = subprocess.Popen(
                    argv, cwd=jobdir, stdout=log, stderr=subprocess.STDOUT,
                    env=subprocess_env(self.extra_env, spec.get("env")))
            finally:
                log.close()  # the child holds its own descriptor

    def status(self, name: str) -> str:
        with self._lock:
            proc = self._procs.get(name)
        if proc is None:
            return "NotFound"
        rc = proc.poll()
        if rc is None:
            return "Running"
        return "Succeeded" if rc == 0 else "Failed"

    def delete(self, name: str) -> None:
        with self._lock:
            proc = self._procs.pop(name, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def has_active_jobs(self) -> bool:
        """True while any trainer subprocess is live."""
        with self._lock:
            return any(p.poll() is None for p in self._procs.values())

    def metrics_series(self, name: str, max_points: int = 2000) -> dict:
        """The job's parsed trainer and eval jsonl curves (the UI's feed)."""
        out = {"train": [], "eval": []}
        for key, fname in (("train", "trainer_log.jsonl"),
                           ("eval", "eval_log.jsonl")):
            path = os.path.join(self.workdir, name, "result", "watch", fname)
            try:
                with open(path) as f:
                    rows = [json.loads(line) for line in f if line.strip()]
                out[key] = rows[-max_points:]
            except (OSError, ValueError):
                pass
        return out

    def log_tail(self, name: str, n: int = 40,
                 max_bytes: int = 256 * 1024) -> str:
        path = os.path.join(self.workdir, name, "log.txt")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(size - max_bytes, 0))
                data = f.read().decode(errors="replace")
            return "".join(data.splitlines(keepends=True)[-n:])
        except OSError:
            return ""
