"""The SURVEY §7.3 slice on the port, driven by the reference control
plane (``tests/test_pipeline_e2e.py``'s asserts): the reference
``build_manager`` with only the port's ``LocalProcessBackend`` and
``LocalServingBackend`` (``device="cpu"``, ``preset:debug``, 2 steps)
takes a FinetuneJob through a port trainer subprocess → manifest →
LLMCheckpoint → a port server subprocess → built-in Scoring →
Successful. The reference experiment loop sees a port run's steps
through the port's ``checkpoint_probe``/``checkpoint_steps``."""

import csv
import json
import os
import time

import pytest

from datatunerx_tpu.experiment.pool import PoolSlice, SharedSlicePool
from datatunerx_tpu.experiment.scheduler import (
    PREEMPTED,
    RUNNING,
    SUCCEEDED,
    SliceScheduler,
)
from datatunerx_tpu.experiment.watcher import ContinuousScoringWatcher
from datatunerx_tpu.operator.api import (
    LLM,
    Dataset,
    Finetune,
    FinetuneJob,
    Hyperparameter,
    LLMCheckpoint,
    ObjectMeta,
    Scoring,
)
from datatunerx_tpu.operator.backends import FakeTrainingBackend
from datatunerx_tpu.operator.manager import build_manager
from datatunerx_tpu.operator.store import ObjectStore
from datatunerx_tpu_torch.operator.backends import LocalProcessBackend
from datatunerx_tpu_torch.serving.local_backend import LocalServingBackend
from datatunerx_tpu_torch.training.checkpoint import (
    checkpoint_probe,
    checkpoint_steps,
)


def _train_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["q", "a"])
        w.writerows(rows)
    return str(path)


def test_minimum_end_to_end_slice_on_port_processes(tmp_path, monkeypatch):
    storage = str(tmp_path / "storage")
    # 8 rows at batch 4, one epoch: 2 steps
    train_csv = _train_csv(tmp_path / "train.csv", [
        ("what is 2+2?", "4"), ("capital of France?", "Paris"),
        ("sky color?", "blue"), ("largest planet?", "Jupiter")] * 2)
    monkeypatch.setenv("STORAGE_PATH", storage)
    store = ObjectStore()
    training = LocalProcessBackend(str(tmp_path / "jobs"), device="cpu")
    serving = LocalServingBackend(str(tmp_path / "jobs"), device="cpu")
    mgr = build_manager(store, training, serving, storage_path=storage,
                        with_scoring=True)

    store.create(LLM(metadata=ObjectMeta(name="m"),
                     spec={"path": "preset:debug"}))
    store.create(Hyperparameter(
        metadata=ObjectMeta(name="hp"),
        spec={"parameters": {
            "scheduler": "constant", "optimizer": "adamw", "loRA_R": "4",
            "loRA_Alpha": "16", "loRA_Dropout": "0.0", "learningRate": "1e-2",
            "epochs": "1", "blockSize": "64", "batchSize": "4",
            "gradAccSteps": "1", "PEFT": "true",
        }},
    ))
    store.create(Dataset(
        metadata=ObjectMeta(name="ds"),
        spec={"datasetMetadata": {"datasetInfo": {
            "subsets": [{"splits": {"train": {"file": train_csv}}}],
            "features": [
                {"name": "instruction", "mapTo": "q"},
                {"name": "response", "mapTo": "a"},
            ],
        }}},
    ))
    store.create(FinetuneJob(metadata=ObjectMeta(name="e2e"), spec={
        "finetune": {
            "name": "e2e-finetune",
            "finetuneSpec": {
                "llm": "m", "dataset": "ds",
                "hyperparameter": {"hyperparameterRef": "hp"},
                "image": {"name": "local", "path": "preset:debug"},
                "node": 1,
            },
        },
    }))

    deadline = time.time() + 300
    state = ""
    try:
        while time.time() < deadline:
            mgr.drain_scheduled(horizon_s=120, max_wall_s=60)
            state = store.get(FinetuneJob, "e2e").status.get("state")
            if state in (FinetuneJob.STATE_SUCCESSFUL,
                         FinetuneJob.STATE_FAILED):
                break
            time.sleep(0.2)
    finally:
        serving.delete("e2e")
        training.delete("e2e-finetune")

    ft = store.try_get(Finetune, "e2e-finetune")
    job = store.get(FinetuneJob, "e2e")
    diag = ""
    if state != FinetuneJob.STATE_SUCCESSFUL:
        serve_log = tmp_path / "jobs" / "serve-e2e" / "log.txt"
        diag = (
            f"job={json.dumps(job.status, default=str)[:800]}\n"
            f"ft={json.dumps(ft.status if ft else {}, default=str)[:400]}\n"
            f"trainer log:\n{training.log_tail('e2e-finetune')}\n"
            f"server log:\n"
            f"{serve_log.read_text()[-2000:] if serve_log.exists() else ''}")
    assert state == FinetuneJob.STATE_SUCCESSFUL, diag

    # the port's processes ran: its module names in the launch lines
    with open(tmp_path / "jobs" / "e2e-finetune" / "cmd.txt") as f:
        cmd = f.read()
    assert "-m datatunerx_tpu_torch.tuning.train" in cmd
    assert cmd.endswith("--device cpu")
    assert "[done] 2 steps" in training.log_tail("e2e-finetune")
    # score recorded as a string; serving torn down after eval
    score = job.status["result"]["score"]
    assert isinstance(score, str) and float(score) >= 0.0
    assert serving.status("e2e") == "NotFound"
    # provenance chain complete: the port's checkpoint behind the CR
    ref = ft.status["llmCheckpoint"]["llmCheckpointRef"]
    ckpt = store.get(LLMCheckpoint, ref)
    assert os.path.exists(os.path.join(ckpt.spec["checkpoint"], "state.pt"))
    scoring = store.get(Scoring, "e2e")
    assert scoring.status["score"] == score
    assert len(scoring.status["details"]) == 5


def test_experiment_loop_sees_port_steps(tmp_path):
    """A port trainer job run by the reference ``SliceScheduler`` on the
    port's backend saves steps 1 and 2; the ``ContinuousScoringWatcher``
    scores both through ``checkpoint_steps``, and a preemption records
    step 2 through ``checkpoint_probe``."""
    storage = str(tmp_path / "storage")
    train_csv = _train_csv(tmp_path / "train.csv",
                           [(f"q {k}", f"a {k}") for k in range(8)])
    ckpt_dir = os.path.join(storage, "job-a", "checkpoints")
    args = ["--model_name_or_path", "preset:debug", "--train_path", train_csv,
            "--columns", json.dumps({"q": "instruction", "a": "response"}),
            "--storage_path", storage, "--uid", "job-a", "--output_dir",
            "result", "--template", "vanilla", "--block_size", "64",
            "--per_device_train_batch_size", "4", "--max_steps", "2",
            "--save_steps", "1", "--bf16", "false"]
    spec = {"args": args, "checkpoint_dir": ckpt_dir}
    backend = LocalProcessBackend(str(tmp_path / "jobs"), device="cpu")
    sched = SliceScheduler(SharedSlicePool([PoolSlice("s0")]), backend,
                           checkpoint_probe=checkpoint_probe)
    scored = []
    watcher = ContinuousScoringWatcher(
        sched, checkpoint_steps,
        lambda job, step: scored.append((job.name, step)) or float(step))
    sched.add_job("job-a", spec)
    sched.tick()
    job = sched.job("job-a")
    assert job.state == RUNNING
    deadline = time.time() + 120
    try:
        while job.state == RUNNING and time.time() < deadline:
            time.sleep(0.2)
            sched.tick()
    finally:
        backend.delete("job-a")
    assert job.state == SUCCEEDED, backend.log_tail("job-a")
    watcher.tick()
    assert scored == [("job-a", 1), ("job-a", 2)]
    assert watcher.board.leader().job == "job-a"

    # a preempted job records the port step its resume fast-forwards to
    fake = FakeTrainingBackend()
    sched2 = SliceScheduler(SharedSlicePool([PoolSlice("s0")]), fake,
                            checkpoint_probe=checkpoint_probe)
    sched2.add_job("job-b", {"args": args, "checkpoint_dir": ckpt_dir})
    sched2.tick()
    assert sched2.preempt("job-b") == 2
    assert sched2.job("job-b").state == PREEMPTED
    sched2.tick()
    assert fake.jobs["job-b"]["env"]["DTX_RESUME_FROM_STEP"] == "2"
    sched2.add_job("job-c", {"args": args})  # no checkpoint_dir: nothing
    assert checkpoint_probe(sched2.job("job-c")) is None


@pytest.mark.parametrize("spec", [{"replicas": 2}, {"gateway": True}])
def test_gateway_deployments_launch_and_multi_host_on_cuda_is_refused(
        tmp_path, spec):
    """More hosts than visible cards is refused on CUDA (one card a host,
    and this machine has none; multi-host training on the CPU runs in
    tests/test_torch_multihost.py); a gateway deployment is not refused: it
    launches the port's gateway over port replicas on the backend's device
    (deployed and scaled in tests/test_torch_gateway.py)."""
    serving = LocalServingBackend(str(tmp_path), device="cpu")
    argv = serving.argv(dict(spec, model_path="preset:debug"), 8000,
                        str(tmp_path))
    assert argv[1:3] == ["-m", "datatunerx_tpu_torch.gateway.server"]
    assert argv[argv.index("--replicas") + 1] == str(spec.get("replicas", 1))
    assert argv[argv.index("--device") + 1] == "cpu"
    assert serving.status("x") == "NotFound"
    training = LocalProcessBackend(str(tmp_path), device="cuda")
    with pytest.raises(RuntimeError, match=r"2 hosts on CUDA.*0 card\(s\)"):
        training.submit("y", {"args": [], "num_hosts": 2})
    assert training.status("y") == "NotFound"
