"""Serving backend: one port server, or one port gateway over N port
replicas, per deployment, health from ``/healthz`` (the port of
``datatunerx_tpu/serving/local_backend.py``).

``deploy`` runs ``python -m datatunerx_tpu_torch.serving.server
--model_path … --checkpoint_path … --device <device>`` in
``<workdir>/serve-<name>`` (``log.txt``), passing the serve config's
engine keys through. With ``replicas > 1`` or ``spec["gateway"]`` it runs
``python -m datatunerx_tpu_torch.gateway.server --replicas N … --device
<device>`` instead: the gateway spawns the N port servers on the same
device and fronts them behind the same ``/healthz`` and
``/chat/completions``; ``scale_hint`` reads its ``/autoscale`` and
``scale`` posts ``/admin/scale``. ``status`` maps the health gate onto
the vocabulary the FinetuneJob controller polls (HEALTHY | PENDING |
FAILED | NotFound). ``delete`` stops the gateway with SIGTERM, on which it
stops its replicas.
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
# serve-config keys only the gateway takes
GATEWAY_KEYS = ("role", "prefill_threshold", "fleet_prefix_mb",
                "fleet_handoff", "fleet_spill")


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

    def argv(self, spec: dict, port: int, appdir: str) -> list:
        """The deployment's command line: a port gateway over ``replicas``
        port servers, or one port server."""
        replicas = int(spec.get("replicas") or 1)
        gateway = replicas > 1 or bool(spec.get("gateway"))
        module = ("datatunerx_tpu_torch.gateway.server" if gateway
                  else "datatunerx_tpu_torch.serving.server")
        argv = [sys.executable, "-m", module,
                "--model_path", spec["model_path"],
                "--checkpoint_path", spec.get("checkpoint_path") or "",
                "--template", spec.get("template", self.template),
                "--port", str(port),
                "--quantization", spec.get("quantization") or "",
                "--device", self.device]
        if gateway:
            argv += ["--replicas", str(replicas),
                     "--policy", spec.get("policy") or "least_busy",
                     "--workdir", appdir]
            # disaggregation knobs are gateway-only: role is a comma cycle
            # over the spawned replicas, the prefill threshold and the
            # fleet plane live in the router
            for key in GATEWAY_KEYS:
                val = spec.get(key)
                if val:
                    if isinstance(val, bool):
                        val = int(val)  # the gateway flags are ints
                    argv += [f"--{key}", str(val)]
        elif spec.get("role"):
            argv += ["--role", str(spec["role"])]
        if spec.get("slots"):
            argv += ["--slots", str(spec["slots"])]
        for key in ENGINE_KEYS:
            if spec.get(key):
                argv += [f"--{key}", str(spec[key])]
        return argv

    def deploy(self, name: str, spec: dict) -> None:
        with self._lock:
            if name in self._procs:
                return
            port = _free_port()
            appdir = os.path.join(self.workdir, f"serve-{name}")
            os.makedirs(appdir, exist_ok=True)
            argv = self.argv(spec, port, appdir)
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
        """The gateway's ``/autoscale`` summary, or None for a single
        server or an unreachable gateway (the controller skips scaling)."""
        from datatunerx_tpu_torch.gateway.autoscale import parse_hint

        url = self.endpoint(name)
        if not url:
            return None
        try:
            with urllib.request.urlopen(f"{url}/autoscale", timeout=2) as r:
                return parse_hint(json.load(r))
        except Exception:  # noqa: BLE001 — no hint is a safe no-op
            return None

    def scale(self, name: str, replicas: int) -> bool:
        """POST the gateway's ``/admin/scale``; False for a single server."""
        url = self.endpoint(name)
        if not url:
            return False
        req = urllib.request.Request(
            f"{url}/admin/scale",
            data=json.dumps({"replicas": int(replicas)}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status == 200
        except Exception:  # noqa: BLE001
            return False

    def delete(self, name: str) -> None:
        with self._lock:
            proc = self._procs.pop(name, None)
            self._ports.pop(name, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                # a gateway stops its replicas before it exits
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
