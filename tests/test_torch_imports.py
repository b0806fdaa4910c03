"""The port stands alone: every module of ``datatunerx_tpu_torch`` and
``chip_smoke.py`` import with ``jax``, ``jaxlib``, ``datatunerx_tpu`` and
the HF libraries (``transformers``, ``tokenizers``, ``safetensors``,
``regex``, ``sentencepiece``) and ``cryptography`` (which only the webhook
server's certificate functions import, when called) blocked, and HF
checkpoint directories load
and tokenize under the same blocker; its entry points default to CUDA and
refuse to carry on without it, and ``chip_smoke.py`` fails (printing no
result) without a card or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        BLOCKED = ("jax", "jaxlib", "datatunerx_tpu", "transformers",
                   "tokenizers", "safetensors", "regex", "sentencepiece",
                   "cryptography")

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
    for name in REQUIRED:  # the slices' entry points and kernel modules
        assert name in names, name
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer)

    for path in HF_DIRS:  # weights and tokenizer, read by the port alone
        cfg, params, tok = load_model_and_tokenizer(path)
        text = "HF directories, read by the port → 日本"
        assert tok.decode(tok.encode(text), skip_special_tokens=True) == text
        assert params["embed_tokens"]["embedding"].shape[0] == cfg.vocab_size
    assert not any(m.split(".")[0] in Block.BLOCKED for m in sys.modules)
    # fsspec loads only when a URI is used
    assert "fsspec" not in sys.modules
    print("IMPORTED", len(names))
""")


REQUIRED = (
    "datatunerx_tpu_torch.serving.server",
    "datatunerx_tpu_torch.ops.cuda_paged_attention",
    "datatunerx_tpu_torch.ops.cuda_sampling",
    "datatunerx_tpu_torch.ops.flash_attention",
    "datatunerx_tpu_torch.models.lora",
    "datatunerx_tpu_torch.training.train_lib",
    "datatunerx_tpu_torch.training.checkpoint",
    "datatunerx_tpu_torch.data.prefetch",
    "datatunerx_tpu_torch.tuning.train",
    "datatunerx_tpu_torch.ops.quant",
    "datatunerx_tpu_torch.ops.cuda_quant",
    "datatunerx_tpu_torch.ops.cuda_lora",
    "datatunerx_tpu_torch.serving.engine",
    "datatunerx_tpu_torch.serving.migration",
    "datatunerx_tpu_torch.serving.adapters",
    "datatunerx_tpu_torch.adapters.store",
    "datatunerx_tpu_torch.adapters.registry",
    "datatunerx_tpu_torch.tenancy.directory",
    "datatunerx_tpu_torch.tenancy.host_tier",
    "datatunerx_tpu_torch.utils.hf_tokenizer",
    "datatunerx_tpu_torch.utils.hf_weights",
    "datatunerx_tpu_torch.ops.prng",
    "datatunerx_tpu_torch.serving.speculative",
    "datatunerx_tpu_torch.fleet",
    "datatunerx_tpu_torch.fleet.handoff",
    "datatunerx_tpu_torch.fleet.prefix_tier",
    "datatunerx_tpu_torch.fleet.spill",
    "datatunerx_tpu_torch.ops.cuda_prng",
    "datatunerx_tpu_torch.training.generate",
    "datatunerx_tpu_torch.scoring.metrics",
    "datatunerx_tpu_torch.obs",
    "datatunerx_tpu_torch.obs.metrics",
    "datatunerx_tpu_torch.obs.trace",
    "datatunerx_tpu_torch.obs.slo",
    "datatunerx_tpu_torch.obs.profiling",
    "datatunerx_tpu_torch.training.metrics_log",
    "datatunerx_tpu_torch.training.ppo",
    "datatunerx_tpu_torch.utils.storage",
    "datatunerx_tpu_torch.operator",
    "datatunerx_tpu_torch.operator.backends",
    "datatunerx_tpu_torch.serving.local_backend",
    "datatunerx_tpu_torch.gateway",
    "datatunerx_tpu_torch.gateway.admission",
    "datatunerx_tpu_torch.gateway.autoscale",
    "datatunerx_tpu_torch.gateway.metrics",
    "datatunerx_tpu_torch.gateway.replica_pool",
    "datatunerx_tpu_torch.gateway.router",
    "datatunerx_tpu_torch.gateway.server",
    "datatunerx_tpu_torch.experiment",
    "datatunerx_tpu_torch.experiment.metrics",
    "datatunerx_tpu_torch.experiment.promotion",
    "datatunerx_tpu_torch.cli",
    "datatunerx_tpu_torch.parallel",
    "datatunerx_tpu_torch.parallel.distributed",
    "datatunerx_tpu_torch.parallel.mesh",
    "datatunerx_tpu_torch.parallel.sharding",
    "datatunerx_tpu_torch.parallel.memory",
    "datatunerx_tpu_torch.ops.ring_attention",
    "datatunerx_tpu_torch.operator.capacity",
    "datatunerx_tpu_torch.operator.kubeclient",
    "datatunerx_tpu_torch.operator.kubebackends",
    "datatunerx_tpu_torch.operator.errors",
    "datatunerx_tpu_torch.operator.labels",
    "datatunerx_tpu_torch.operator.events",
    "datatunerx_tpu_torch.operator.api",
    "datatunerx_tpu_torch.operator.store",
    "datatunerx_tpu_torch.operator.reconciler",
    "datatunerx_tpu_torch.operator.webhooks",
    "datatunerx_tpu_torch.operator.config",
    "datatunerx_tpu_torch.operator.generate",
    "datatunerx_tpu_torch.operator.placement",
    "datatunerx_tpu_torch.operator.health",
    "datatunerx_tpu_torch.operator.finetune_controller",
    "datatunerx_tpu_torch.operator.finetunejob_controller",
    "datatunerx_tpu_torch.operator.finetuneexperiment_controller",
    "datatunerx_tpu_torch.operator.apiserver",
    "datatunerx_tpu_torch.operator.manager",
    "datatunerx_tpu_torch.scoring.plugin",
    "datatunerx_tpu_torch.scoring.builtin",
    "datatunerx_tpu_torch.scoring.dataset_scoring",
    "datatunerx_tpu_torch.scoring.controller",
    "datatunerx_tpu_torch.loadgen",
    "datatunerx_tpu_torch.loadgen.__main__",
    "datatunerx_tpu_torch.loadgen.workload",
    "datatunerx_tpu_torch.loadgen.chaos",
    "datatunerx_tpu_torch.loadgen.replay",
    "datatunerx_tpu_torch.experiment.pool",
    "datatunerx_tpu_torch.experiment.scheduler",
    "datatunerx_tpu_torch.experiment.watcher",
    "datatunerx_tpu_torch.experiment.runner",
    "datatunerx_tpu_torch.operator.kubestore",
    "datatunerx_tpu_torch.operator.leaderelection",
    "datatunerx_tpu_torch.operator.webhook_server",
    "datatunerx_tpu_torch.operator.crdgen",
    "datatunerx_tpu_torch.operator.install",
)


def test_every_module_imports_without_jax(tmp_path):
    from torch_hf_dirs import write_hf_dir

    hf_dirs = (write_hf_dir(tmp_path / "llama", "llama", "F16", shard_kb=40),
               write_hf_dir(tmp_path / "qwen2", "qwen2", "BF16", fmt="bin"))
    code = (f"ROOT = {ROOT!r}\nREQUIRED = {REQUIRED!r}\n"
            f"HF_DIRS = {hf_dirs!r}\n" + _BLOCKER)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[1])
    assert n >= 123  # every module of slices 1 to 21


def test_gateway_and_backend_launch_only_port_modules(monkeypatch,
                                                      tmp_path):
    """The port gateway's spawned replicas and ``LocalServingBackend``'s
    command lines name only ``datatunerx_tpu_torch`` modules, on ``--device
    cuda`` unless the caller asks for the CPU."""
    from datatunerx_tpu_torch.gateway import server as gateway
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )

    launched = []

    class FakeProc:
        def __init__(self, argv, **kw):
            launched.append(list(argv))

        def poll(self):
            return None

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(gateway.subprocess, "Popen", FakeProc)
    for device in ("cuda", "cpu"):
        kw = {} if device == "cuda" else {"device": "cpu"}
        rs = gateway.ManagedReplicaSet(
            gateway.ReplicaPool(), ["--model_path", "preset:debug"],
            workdir=str(tmp_path), supervise_interval_s=0,
            roles=["prefill", "decode"], **kw)
        rs.scale(2)
        rs.close()
        backend = LocalServingBackend(str(tmp_path), **kw)
        for replicas in (1, 2):
            launched.append(backend.argv(
                {"model_path": "m", "replicas": replicas, "role": "decode"},
                8000, str(tmp_path)))
        cmds = launched[-4:]
        assert [c[2] for c in cmds] == [
            "datatunerx_tpu_torch.serving.server"] * 3 + [
            "datatunerx_tpu_torch.gateway.server"]
        for c in cmds:
            assert c[1] == "-m" and c[c.index("--device") + 1] == device
            assert not any("datatunerx_tpu." in a for a in c)
        assert [c[c.index("--role") + 1] for c in cmds[:2]] == [
            "prefill", "decode"]


def test_engine_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run")
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine("preset:debug", template="vanilla", max_seq_len=256,
                      slots=2, kv_block_size=16)
    from datatunerx_tpu_torch.serving.engine import InferenceEngine

    for quant in (None, "int8"):
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine("preset:debug", template="vanilla",
                            max_seq_len=256, quantization=quant)


def test_trainer_cli_defaults_to_cuda_and_refuses_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run")
    from datatunerx_tpu_torch.tuning.parser import parse_train_args
    from datatunerx_tpu_torch.tuning.train import main

    train = tmp_path / "train.csv"
    train.write_text("instruction,response\nhi,there\n")
    argv = ["--model_name_or_path", "preset:debug", "--train_path",
            str(train), "--storage_path", str(tmp_path / "s"),
            "--output_dir", str(tmp_path / "o")]
    assert parse_train_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not (tmp_path / "o").exists()  # refused before any work
    from datatunerx_tpu_torch.training.train_lib import Trainer, TrainConfig
    from datatunerx_tpu_torch.models.config import get_config

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_config("debug"), TrainConfig())


def test_launch_backends_default_to_cuda_and_fail_without_it(tmp_path):
    """The port's trainer and server subprocesses get ``--device cuda``
    unless the backend is built with ``device="cpu"``: here, without a
    card, the job fails and the server never turns healthy."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run")
    import time

    from datatunerx_tpu_torch.operator.backends import LocalProcessBackend
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )

    train = tmp_path / "train.csv"
    train.write_text("instruction,response\nhi,there\n")
    training = LocalProcessBackend(str(tmp_path / "jobs"))
    serving = LocalServingBackend(str(tmp_path / "jobs"))
    training.submit("job", {"args": [
        "--model_name_or_path", "preset:debug", "--train_path", str(train),
        "--storage_path", str(tmp_path / "s")]})
    serving.deploy("app", {"model_path": "preset:debug"})
    def health():
        try:
            with urllib.request.urlopen(serving.endpoint("app") + "/healthz",
                                        timeout=2) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:  # a failed load answers 500
            return json.load(e)
        except OSError:
            return {}

    try:
        deadline = time.time() + 90
        while time.time() < deadline and (
                training.status("job") == "Running"
                or health().get("status") != "FAILED"):
            time.sleep(0.2)
        assert training.status("job") == "Failed"
        assert "CUDA" in training.log_tail("job")
        with open(tmp_path / "jobs" / "job" / "cmd.txt") as f:
            assert f.read().endswith("--device cuda")
        doc = health()
        assert doc["status"] == "FAILED" and "CUDA" in doc["error"]
        assert serving.status("app") != "HEALTHY"
    finally:
        training.delete("job")
        serving.delete("app")


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


def test_controller_manager_holds_jobs_without_a_card(tmp_path):
    """The port's controller-manager defaults to the card: its health
    probe runs on ``cuda`` and, without a card, reports unhealthy, so a
    Finetune holds in Pending and nothing is launched (``--device cpu``
    runs it on the CPU: ``tests/test_torch_operator_e2e.py``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run")
    from datatunerx_tpu_torch.operator.api import (
        Dataset,
        Finetune,
        Hyperparameter,
        LLM,
        ObjectMeta,
    )
    from datatunerx_tpu_torch.operator.backends import LocalProcessBackend
    from datatunerx_tpu_torch.operator.health import DeviceHealthProbe
    from datatunerx_tpu_torch.operator.manager import build_manager
    from datatunerx_tpu_torch.operator.store import ObjectStore
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )

    training = LocalProcessBackend(str(tmp_path / "jobs"))
    assert training.device == "cuda"
    probe = DeviceHealthProbe(interval_s=3600)
    assert probe.device == "cuda" and not probe.check_now()
    store = ObjectStore()
    mgr = build_manager(store, training,
                        LocalServingBackend(str(tmp_path / "jobs")),
                        storage_path=str(tmp_path / "s"), health_probe=probe)
    store.create(LLM(metadata=ObjectMeta(name="m"),
                     spec={"path": "preset:debug"}))
    store.create(Hyperparameter(metadata=ObjectMeta(name="hp"),
                                spec={"parameters": {"PEFT": "true"}}))
    store.create(Dataset(metadata=ObjectMeta(name="ds"), spec={
        "datasetMetadata": {"datasetInfo": {"subsets": [{"splits": {
            "train": {"file": "/t.csv"}}}]}}}))
    store.create(Finetune(metadata=ObjectMeta(name="f"), spec={
        "llm": "m", "dataset": "ds",
        "hyperparameter": {"hyperparameterRef": "hp"},
        "image": {"path": "preset:debug"}}))
    mgr.run_until_idle()
    st = store.get(Finetune, "f").status
    assert st["state"] == Finetune.STATE_PENDING
    assert "no CUDA device" in st["backendUnavailable"]
    assert training.status("f") == "NotFound"
