"""The port's ``ManifestBackend`` (``datatunerx_tpu_torch/operator/
backends.py``) against the JAX package's.

The port's JobSet and Deployment are the reference's after one stated map
of substitutions, and nothing else differs:

- the module each container runs: ``datatunerx_tpu.tuning.train`` and
  ``datatunerx_tpu.serving.server`` become the port's, each with
  ``--device cuda`` after its arguments;
- the device limit: ``google.com/tpu: "4"`` becomes ``nvidia.com/gpu: "1"``;
- the node selector: ``cloud.google.com/gke-tpu-accelerator`` becomes
  ``cloud.google.com/gke-accelerator`` (``nvidia-h100-80gb`` by default),
  and the TPU topology selector goes;
- the replicated job ``tpu-hosts`` is ``gpu-hosts`` (so the coordinator
  address names it too);
- a spec without an image: the reference falls back to its TPU trainer
  and serving images, the port to its one CUDA image,
  ``config.get_base_image()``, for both.

The status-file feedback, ``jobset_state``/``deployment_state`` and
``delete`` behave as the reference's; more than one host renders the
reference's N-pod JobSet under the same map (one GPU a pod, the
coordinator env).
"""

import copy
import json
import os

import pytest

from datatunerx_tpu.operator import backends as jb
from datatunerx_tpu_torch.operator import backends as tb
from datatunerx_tpu_torch.operator import config as tconfig

TRAIN_SPEC = {"args": ["--model_name_or_path", "preset:tinyllama-1.1b",
                       "--train_path", "/data/t.csv", "--max_steps", 5],
              "env": {"HF_HOME": "/cache", "DTX_X": 3},
              "labels": {"team": "nlp"},
              "image": "registry/trainer:1",
              "node_selector": {"pool": "h100-a"}}
SERVE_SPEC = {"model_path": "/models/m", "checkpoint_path": "/ckpt/7",
              "quantization": "int8", "slots": 8, "replicas": 3,
              "labels": {"team": "nlp"}, "node_selector": {"pool": "p"},
              "tolerations": [{"key": "nvidia.com/gpu",
                               "operator": "Exists"}]}


def _pod(jobset):
    return jobset["spec"]["replicatedJobs"][0]["template"]["spec"][
        "template"]["spec"]


def to_port_training(js, spec, accelerator="nvidia-h100-80gb"):
    """The reference's JobSet under the substitution map."""
    js = copy.deepcopy(js)
    rj = js["spec"]["replicatedJobs"][0]
    rj["name"] = "gpu-hosts"
    pod = _pod(js)
    sel = pod["nodeSelector"]
    del sel["cloud.google.com/gke-tpu-accelerator"]
    del sel["cloud.google.com/gke-tpu-topology"]
    pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": accelerator,
                           **sel}
    c = pod["containers"][0]
    assert c["command"] == ["python", "-m", "datatunerx_tpu.tuning.train"]
    c["command"] = ["python", "-m", "datatunerx_tpu_torch.tuning.train"]
    if not spec.get("image"):
        c["image"] = tconfig.get_base_image()
    c["args"] = c["args"] + ["--device", "cuda"]
    c["resources"] = {"limits": {"nvidia.com/gpu": "1"}}
    for e in c["env"]:
        if e["name"] == "DTX_COORDINATOR_ADDRESS":
            e["value"] = e["value"].replace("-tpu-hosts-", "-gpu-hosts-")
    return js


def to_port_serving(docs, spec, accelerator="nvidia-h100-80gb"):
    docs = copy.deepcopy(docs)
    pod = docs[0]["spec"]["template"]["spec"]
    sel = pod["nodeSelector"]
    del sel["cloud.google.com/gke-tpu-accelerator"]
    pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": accelerator,
                           **sel}
    c = pod["containers"][0]
    assert c["command"] == ["python", "-m", "datatunerx_tpu.serving.server"]
    c["command"] = ["python", "-m", "datatunerx_tpu_torch.serving.server"]
    if not spec.get("image"):
        c["image"] = tconfig.get_base_image()
    c["args"] = c["args"] + ["--device", "cuda"]
    c["resources"] = {"limits": {"nvidia.com/gpu": "1"}}
    return docs


@pytest.mark.parametrize("spec", [
    TRAIN_SPEC, {"args": ["--model_name_or_path", "m"]},
    dict(TRAIN_SPEC, num_hosts=1)], ids=["full", "bare", "one-host"])
def test_jobset_is_the_references_under_the_map(tmp_path, spec):
    ref = jb.ManifestBackend(str(tmp_path / "ref"))
    port = tb.ManifestBackend(str(tmp_path / "port"))
    want = to_port_training(ref.render_training("job-1", spec), spec)
    got = port.render_training("job-1", spec)
    assert got == want
    text = json.dumps(got)
    assert "datatunerx_tpu." not in text and "tpu" not in text.replace(
        "datatunerx_tpu_torch", "").replace("datatunerx-tpu", "")


@pytest.mark.parametrize("spec", [SERVE_SPEC, {"model_path": "/m"}],
                         ids=["full", "bare"])
def test_deployment_is_the_references_under_the_map(tmp_path, spec):
    ref = jb.ManifestBackend(str(tmp_path / "ref"))
    port = tb.ManifestBackend(str(tmp_path / "port"),
                              accelerator="nvidia-h100-mega-80gb")
    want = to_port_serving(ref.render_serving("app", spec), spec,
                           accelerator="nvidia-h100-mega-80gb")
    assert port.render_serving("app", spec) == want


def test_more_than_one_host_renders_the_references_jobset(tmp_path):
    ref = jb.ManifestBackend(str(tmp_path / "ref"))
    port = tb.ManifestBackend(str(tmp_path / "port"))
    spec = dict(TRAIN_SPEC, num_hosts=2)
    want = to_port_training(ref.render_training("big", spec), spec)
    port.submit("big", spec)
    got = port.render_training("big", spec)
    assert got == want
    rj = got["spec"]["replicatedJobs"][0]["template"]["spec"]
    assert rj["parallelism"] == rj["completions"] == 2
    env = {e["name"]: e for e in _pod(got)["containers"][0]["env"]}
    assert env["DTX_NUM_PROCESSES"]["value"] == "2"
    assert env["DTX_COORDINATOR_ADDRESS"]["value"] == (
        "big-gpu-hosts-0-0.big:8476")
    assert port.status("big") == "Pending"
    assert os.listdir(tmp_path / "port") == ["big-jobset.json"]


STATUSES = [
    None, "not json", {"state": "Running"}, {"state": "Succeeded"},
    {"replicatedJobsStatus": [{"active": 1}]},
    {"replicatedJobsStatus": [{"ready": 1}]},
    {"conditions": [{"type": "Completed", "status": "True"}]},
    {"conditions": [{"type": "Failed", "status": "True"}]},
    {"conditions": [{"type": "FailurePolicyComplete", "status": "True"}]},
    {"conditions": [{"type": "Completed", "status": "False"}],
     "replicatedJobsStatus": [{"active": 1}]},
    [1, 2]]


def _feedback(mod, out_dir):
    """submit → status through each status file → delete → status."""
    backend = mod.ManifestBackend(out_dir)
    seen = [backend.status("j")]
    backend.submit("j", TRAIN_SPEC)
    seen.append(sorted(os.listdir(out_dir)))
    path = os.path.join(out_dir, "j-status.json")
    for status in STATUSES:
        if status is None:
            if os.path.exists(path):
                os.remove(path)
        else:
            with open(path, "w") as f:
                f.write(status if isinstance(status, str)
                        else json.dumps(status))
        seen.append(backend.status("j"))
    backend.delete("j")
    seen += [backend.status("j"), sorted(os.listdir(out_dir))]
    backend.delete("j")  # idempotent
    return seen


def test_status_feedback_and_delete_are_the_references(tmp_path):
    want = _feedback(jb, str(tmp_path / "ref"))
    got = _feedback(tb, str(tmp_path / "port"))
    assert got == want
    assert got[1] == ["j-jobset.json"] and got[-1] == []


@pytest.mark.parametrize("status", [
    {}, {"availableReplicas": 1}, {"availableReplicas": 0},
    {"conditions": [{"type": "ReplicaFailure", "status": "True"}]},
    {"conditions": [{"type": "Progressing", "status": "False",
                     "reason": "ProgressDeadlineExceeded"}]},
    {"conditions": [{"type": "Progressing", "status": "True"}],
     "availableReplicas": 2}])
def test_state_maps_are_the_references(status):
    assert tb.deployment_state(status) == jb.deployment_state(status)
    assert tb.jobset_state(status) == jb.jobset_state(status)
