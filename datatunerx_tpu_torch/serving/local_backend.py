"""Serving backend: one port server subprocess per deployment, health from
``/healthz`` (the port of ``datatunerx_tpu/serving/local_backend.py``).

``deploy`` runs ``python -m datatunerx_tpu_torch.serving.server
--model_path … --checkpoint_path … --device <device>`` in
``<workdir>/serve-<name>`` (``log.txt``), passing the serve config's
engine keys through; ``status`` maps the server's health gate onto the
vocabulary the FinetuneJob controller polls (HEALTHY | PENDING | FAILED |
NotFound). A gateway fronting several port replicas (``replicas > 1`` or
``spec["gateway"]``) is not ported yet (the gateway half of ROADMAP Queue
1 item 11) and raises.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request
from typing import Dict, Optional

from datatunerx_tpu_torch.operator.backends import subprocess_env

# serve-config keys passed through to the server as flags
ENGINE_KEYS = ("kv_block_size", "kv_blocks", "kv_overcommit", "prefill_chunk",
               "prefill_token_budget", "adapter_pool", "adapter_rank_max",
               "paged_kernel", "spec_draft_config", "spec_k", "spec_mode",
               "spec_tree", "sampling_epilogue", "tenants_config",
               "host_adapter_cache_mb")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalServingBackend:
    def __init__(self, workdir: str, template: str = "vanilla",
                 extra_env: Optional[dict] = None, device: str = "cuda"):
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.template = template
        self.extra_env = extra_env or {}
        self.device = device
        self._procs: Dict[str, subprocess.Popen] = {}
        self._ports: Dict[str, int] = {}
        self._lock = threading.Lock()

    def deploy(self, name: str, spec: dict) -> None:
        replicas = int(spec.get("replicas") or 1)
        if replicas > 1 or spec.get("gateway"):
            raise NotImplementedError(
                f"deployment {name!r} asks for a gateway over {replicas} "
                "replicas: a gateway fronting port servers is not ported "
                "yet (the gateway half of ROADMAP Queue 1 item 11)")
        with self._lock:
            if name in self._procs:
                return
            port = _free_port()
            appdir = os.path.join(self.workdir, f"serve-{name}")
            os.makedirs(appdir, exist_ok=True)
            argv = [sys.executable, "-m", "datatunerx_tpu_torch.serving.server",
                    "--model_path", spec["model_path"],
                    "--checkpoint_path", spec.get("checkpoint_path") or "",
                    "--template", spec.get("template", self.template),
                    "--port", str(port),
                    "--quantization", spec.get("quantization") or "",
                    "--device", self.device]
            if spec.get("role"):
                argv += ["--role", str(spec["role"])]
            if spec.get("slots"):
                argv += ["--slots", str(spec["slots"])]
            for key in ENGINE_KEYS:
                if spec.get(key):
                    argv += [f"--{key}", str(spec[key])]
            log = open(os.path.join(appdir, "log.txt"), "w")
            try:
                self._procs[name] = subprocess.Popen(
                    argv, cwd=appdir, stdout=log, stderr=subprocess.STDOUT,
                    env=subprocess_env(self.extra_env))
            finally:
                log.close()  # the child holds its own descriptor
            self._ports[name] = port

    def status(self, name: str) -> str:
        with self._lock:
            proc = self._procs.get(name)
            port = self._ports.get(name)
        if proc is None:
            return "NotFound"
        if proc.poll() is not None:
            return "FAILED"
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2) as resp:
                return json.load(resp).get("status", "PENDING")
        except Exception:  # noqa: BLE001 — not up yet
            return "PENDING"

    def endpoint(self, name: str) -> Optional[str]:
        port = self._ports.get(name)
        return f"http://127.0.0.1:{port}" if port else None

    def scale_hint(self, name: str) -> Optional[dict]:
        """None: a single server has no ``/autoscale`` summary, so the
        controller skips scaling (the gateway's is not ported yet)."""
        return None

    def scale(self, name: str, replicas: int) -> bool:
        """False: a single server has no replicas to scale."""
        return False

    def delete(self, name: str) -> None:
        with self._lock:
            proc = self._procs.pop(name, None)
            self._ports.pop(name, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
