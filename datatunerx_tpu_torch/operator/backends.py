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

``spec["num_hosts"] > 1`` spawns that many trainers wired with the
``DTX_*`` env contract the JobSet sets (``parallel/distributed.py``): one
process a card, rank 0 on ``log.txt``, rank i on ``log.<i>.txt``. Under
``--device cuda`` each rank gets its own card through
``CUDA_VISIBLE_DEVICES`` (index ``i`` of the cards visible to the backend),
and a job asking for more hosts than there are cards raises at submit.

``ManifestBackend`` renders the same workloads as Kubernetes manifests for
a GKE GPU node pool (a JobSet of ``num_hosts`` pods for training, one GPU
each, with the coordinator env; a Deployment and Service for serving:
``nvidia.com/gpu`` limits, a ``cloud.google.com/gke-accelerator`` node
selector, ``--device cuda``; a spec without an image gets
``config.get_base_image()``, the port's trainer image, which also serves)
without submitting them; ``status`` reads a
``<name>-status.json`` dropped beside the manifest.

``FakeTrainingBackend`` and ``FakeServingBackend`` are the scripted
backends of the controllers' tests (tests set each state by hand).
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Protocol

from datatunerx_tpu_torch.operator import config


class TrainingBackend(Protocol):
    def submit(self, name: str, spec: dict) -> None: ...

    def status(self, name: str) -> str: ...

    def delete(self, name: str) -> None: ...


class ServingBackend(Protocol):
    def deploy(self, name: str, spec: dict) -> None: ...

    def status(self, name: str) -> str: ...  # HEALTHY | PENDING | FAILED

    def endpoint(self, name: str) -> Optional[str]: ...

    def delete(self, name: str) -> None: ...


# ----------------------------------------------------------------- fakes

class FakeTrainingBackend:
    """Scripted backend: tests drive transitions explicitly."""

    def __init__(self):
        self.jobs: Dict[str, dict] = {}
        self.states: Dict[str, str] = {}
        self.deleted: List[str] = []

    def submit(self, name, spec):
        self.jobs[name] = spec
        self.states.setdefault(name, "Pending")

    def status(self, name):
        return self.states.get(name, "NotFound")

    def delete(self, name):
        self.deleted.append(name)
        self.states.pop(name, None)
        self.jobs.pop(name, None)

    def set_state(self, name, state):
        self.states[name] = state


class FakeServingBackend:
    def __init__(self):
        self.apps: Dict[str, dict] = {}
        self.states: Dict[str, str] = {}
        self.deleted: List[str] = []

    def deploy(self, name, spec):
        self.apps[name] = spec
        self.states.setdefault(name, "PENDING")

    def status(self, name):
        return self.states.get(name, "NotFound")

    def endpoint(self, name):
        if self.states.get(name) == "HEALTHY":
            return f"http://{name}.default.svc:8000"
        return None

    def delete(self, name):
        self.deleted.append(name)
        self.states.pop(name, None)
        self.apps.pop(name, None)

    def set_state(self, name, state):
        self.states[name] = state


def _pkg_root() -> str:
    """The directory holding ``datatunerx_tpu_torch`` (a subprocess's
    PYTHONPATH)."""
    import datatunerx_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        datatunerx_tpu_torch.__file__)))


def _hosts(spec: dict) -> int:
    return max(1, int(spec.get("num_hosts", 1) or 1))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _visible_cards() -> list:
    """The card indices this process may hand out: its own
    ``CUDA_VISIBLE_DEVICES`` list, else every card torch sees."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c for c in env.split(",") if c.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


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
        hosts = _hosts(spec)
        cards = None
        if hosts > 1 and self.device == "cuda":
            cards = _visible_cards()
            if len(cards) < hosts:
                raise RuntimeError(
                    f"job {name!r} asks for {hosts} hosts on CUDA, one card "
                    f"each, and {len(cards)} card(s) are visible")
        with self._lock:
            if name in self._procs:
                return
            jobdir = os.path.join(self.workdir, name)
            os.makedirs(jobdir, exist_ok=True)
            argv = [sys.executable, "-m", "datatunerx_tpu_torch.tuning.train",
                    *(str(a) for a in spec["args"]), "--device", self.device]
            with open(os.path.join(jobdir, "cmd.txt"), "w") as f:
                f.write(shlex.join(argv))
            env = subprocess_env(self.extra_env, spec.get("env"))
            coord = f"127.0.0.1:{_free_port()}"
            procs = []
            for pid in range(hosts):
                henv = dict(env)
                if hosts > 1:
                    henv.update(DTX_COORDINATOR_ADDRESS=coord,
                                DTX_NUM_PROCESSES=str(hosts),
                                DTX_PROCESS_ID=str(pid))
                    # ranks on one machine share its cores: a starved rank
                    # must not time out its peers
                    henv.setdefault("DTX_DIST_HEARTBEAT_S", "600")
                    henv.setdefault("DTX_DIST_SHUTDOWN_S", "600")
                if cards is not None:
                    henv["CUDA_VISIBLE_DEVICES"] = cards[pid]
                # rank 0 writes checkpoints and the manifest; the rest log
                # beside it
                log_name = "log.txt" if pid == 0 else f"log.{pid}.txt"
                log = open(os.path.join(jobdir, log_name), "w")
                try:
                    procs.append(subprocess.Popen(
                        argv, cwd=jobdir, stdout=log,
                        stderr=subprocess.STDOUT, env=henv))
                finally:
                    log.close()  # the child holds its own descriptor
            self._procs[name] = procs

    def status(self, name: str) -> str:
        with self._lock:
            procs = self._procs.get(name)
        if procs is None:
            return "NotFound"
        rcs = [p.poll() for p in procs]
        if any(rc not in (None, 0) for rc in rcs):
            return "Failed"  # JobSet semantics: a failing host fails the job
        if any(rc is None for rc in rcs):
            return "Running"
        return "Succeeded"

    def delete(self, name: str) -> None:
        with self._lock:
            procs = self._procs.pop(name, None)
        for proc in procs or []:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    def has_active_jobs(self) -> bool:
        """True while any trainer subprocess is live."""
        with self._lock:
            return any(p.poll() is None
                       for procs in self._procs.values() for p in procs)

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


# -------------------------------------------------------------- manifests

def jobset_state(status: dict) -> str:
    """JobSet status → backend state vocabulary. A 'Completed'=True
    condition is terminal success, 'Failed'=True terminal failure; any
    active/ready replicated job counts as Running; otherwise Pending."""
    for cond in status.get("conditions") or []:
        if str(cond.get("status")) != "True":
            continue
        t = cond.get("type", "")
        if t == "Completed":
            return "Succeeded"
        if t in ("Failed", "FailurePolicyComplete"):
            return "Failed"
    for rj in status.get("replicatedJobsStatus") or []:
        if (rj.get("active", 0) or 0) > 0 or (rj.get("ready", 0) or 0) > 0:
            return "Running"
    return "Pending"


def deployment_state(status: dict) -> str:
    for cond in status.get("conditions") or []:
        if (cond.get("type") == "ReplicaFailure"
                and str(cond.get("status")) == "True"):
            return "FAILED"
        # crash-looping pods never set ReplicaFailure; the deployment's
        # progress deadline (default 600s) is the terminal signal for them
        if (cond.get("type") == "Progressing"
                and str(cond.get("status")) == "False"
                and cond.get("reason") == "ProgressDeadlineExceeded"):
            return "FAILED"
    if (status.get("availableReplicas") or 0) >= 1:
        return "HEALTHY"
    return "PENDING"


class ManifestBackend:
    """Renders k8s manifests for a GKE GPU node pool instead of submitting
    them: training → a JobSet of ``num_hosts`` pods (one GPU each) running
    the port's trainer CLI, wired by the coordinator env; serving →
    Deployment + Service running the port's server, one GPU a pod."""

    def __init__(self, out_dir: str, accelerator: str = "nvidia-h100-80gb"):
        self.out_dir = out_dir
        self.accelerator = accelerator
        os.makedirs(out_dir, exist_ok=True)
        self._submitted: Dict[str, dict] = {}

    def _node_selector(self, spec: dict) -> dict:
        return {"cloud.google.com/gke-accelerator": self.accelerator,
                **(spec.get("node_selector") or {})}

    def render_training(self, name: str, spec: dict) -> dict:
        hosts = _hosts(spec)
        image = spec.get("image") or config.get_base_image()
        args = [str(a) for a in spec["args"]] + ["--device", "cuda"]
        return {
            "apiVersion": "jobset.x-k8s.io/v1alpha2",
            "kind": "JobSet",
            "metadata": {"name": name, "labels": spec.get("labels", {})},
            "spec": {
                "replicatedJobs": [{
                    "name": "gpu-hosts",
                    "replicas": 1,
                    "template": {
                        "spec": {
                            "parallelism": hosts,
                            "completions": hosts,
                            "backoffLimit": 0,
                            "template": {
                                "metadata": {"labels": spec.get("labels", {})},
                                "spec": {
                                    "restartPolicy": "Never",
                                    "nodeSelector": self._node_selector(spec),
                                    "containers": [{
                                        "name": "trainer",
                                        "image": image,
                                        "command": ["python", "-m", "datatunerx_tpu_torch.tuning.train"],
                                        "args": args,
                                        "env": [
                                            {"name": "DTX_COORDINATOR_ADDRESS",
                                             "value": f"{name}-gpu-hosts-0-0.{name}:8476"},
                                            {"name": "DTX_NUM_PROCESSES", "value": str(hosts)},
                                            {"name": "DTX_PROCESS_ID",
                                             "valueFrom": {"fieldRef": {"fieldPath": (
                                                 "metadata.annotations['batch.kubernetes.io/job-completion-index']")}}},
                                        ] + [
                                            {"name": k, "value": str(v)}
                                            for k, v in spec.get("env", {}).items()
                                        ],
                                        "resources": {"limits": {"nvidia.com/gpu": "1"}},
                                    }],
                                },
                            },
                        },
                    },
                }],
            },
        }

    def render_serving(self, name: str, spec: dict) -> list:
        labels = {"app": name, **spec.get("labels", {})}
        deployment = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "labels": labels},
            "spec": {
                # horizontal serving scale: the Service spreads requests
                # over the server pods
                "replicas": int(spec.get("replicas") or 1),
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": {
                        "nodeSelector": self._node_selector(spec),
                        "tolerations": spec.get("tolerations", []),
                        "containers": [{
                            "name": "server",
                            # one image trains and serves
                            # (Dockerfile.torch-trainer)
                            "image": spec.get("image") or config.get_base_image(),
                            "command": ["python", "-m", "datatunerx_tpu_torch.serving.server"],
                            "args": [
                                "--model_path", spec["model_path"],
                                "--checkpoint_path", spec.get("checkpoint_path", ""),
                                "--port", "8000",
                                "--quantization", spec.get("quantization", ""),
                                *(["--slots", str(spec["slots"])]
                                  if spec.get("slots") is not None else []),
                                "--device", "cuda",
                            ],
                            "ports": [{"containerPort": 8000}],
                            "readinessProbe": {
                                "httpGet": {"path": "/healthz", "port": 8000},
                                "periodSeconds": 5,
                            },
                            "resources": {"limits": {"nvidia.com/gpu": "1"}},
                        }],
                    },
                },
            },
        }
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "labels": labels},
            "spec": {
                "selector": {"app": name},
                "ports": [{"port": 8000, "targetPort": 8000}],
            },
        }
        return [deployment, service]

    def submit(self, name, spec):
        manifest = self.render_training(name, spec)
        self._submitted[name] = manifest
        with open(os.path.join(self.out_dir, f"{name}-jobset.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    def status(self, name):
        """No apiserver to poll: the feedback is a status file
        (``<name>-status.json``) dropped next to the manifest by whatever
        applied it — either ``{"state": "Running"}`` or a raw JobSet status
        object (mapped through ``jobset_state``). No file = Pending."""
        if name not in self._submitted:
            return "NotFound"
        path = os.path.join(self.out_dir, f"{name}-status.json")
        try:
            with open(path) as f:
                status = json.load(f)
        except (OSError, ValueError):
            return "Pending"
        if isinstance(status, dict) and isinstance(status.get("state"), str):
            return status["state"]
        return jobset_state(status if isinstance(status, dict) else {})

    def delete(self, name):
        self._submitted.pop(name, None)
        for suffix in ("-jobset.json", "-status.json"):
            try:
                os.remove(os.path.join(self.out_dir, f"{name}{suffix}"))
            except OSError:
                pass
