"""The port's Kube backends (``operator/kubebackends.py`` over its own
``kubeclient.py``) against ``tests/fake_apiserver.py``, mirroring
``tests/test_kube_backends.py``: the port's GPU JobSet and server
Deployment are what reach the apiserver, JobSet conditions and Deployment
availability map as the reference maps them, and the reference operator
takes a Finetune to Succeeded through the port's ``KubeTrainingBackend``
and the port's ``KubeObjectStore``. Each package's store reads only its
own client's ``ApiError``."""

import os
import time

import pytest

from datatunerx_tpu.operator import kubebackends as jkb
from datatunerx_tpu.operator.api import Finetune, ObjectMeta
from datatunerx_tpu.operator.backends import FakeServingBackend
from datatunerx_tpu.operator.manager import build_manager
from datatunerx_tpu_torch.operator import backends as tb
from datatunerx_tpu_torch.operator.kubebackends import (
    JOBSET_GROUP,
    JOBSET_PLURAL,
    JOBSET_VERSION,
    KubeServingBackend,
    KubeTrainingBackend,
)
from datatunerx_tpu_torch.operator.kubeclient import ApiError, KubeClient
from datatunerx_tpu_torch.operator.kubestore import KubeObjectStore
from datatunerx_tpu_torch.training.checkpoint import write_manifest
from tests.fake_apiserver import FakeKubeApiServer
from tests.test_operator import _seed_deps


@pytest.fixture()
def cluster(tmp_path):
    srv = FakeKubeApiServer().start()
    client = KubeClient(base_url=srv.url)
    yield srv, client, str(tmp_path)
    srv.stop()


def _set_status(client, group, version, plural, name, status, ns="default"):
    obj = client.get(group, version, plural, ns, name)
    obj["status"] = status
    client.replace(group, version, plural, ns, name, obj,
                   subresource="status")


def test_constants_and_client_surface_are_the_references():
    assert (JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL) == (
        jkb.JOBSET_GROUP, jkb.JOBSET_VERSION, jkb.JOBSET_PLURAL)
    from datatunerx_tpu.operator import kubeclient as jkc

    for name in ("get", "create", "replace", "delete", "list", "watch"):
        assert hasattr(KubeClient, name) == hasattr(jkc.KubeClient, name)
    assert issubclass(ApiError, Exception)


def test_training_backend_submits_the_gpu_jobset(cluster):
    srv, client, workdir = cluster
    backend = KubeTrainingBackend(client, out_dir=os.path.join(workdir, "m"))
    assert backend.status("t1") == "NotFound"
    spec = {"args": ["--model_name_or_path", "m"], "num_hosts": 2}
    backend.submit("t1", spec)
    backend.submit("t1", {"args": ["--model_name_or_path", "m"]})  # 409: ok
    assert backend.status("t1") == "Pending"
    js = client.get(JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL, "default",
                    "t1")
    want = tb.ManifestBackend(os.path.join(workdir, "r")).render_training(
        "t1", spec)
    assert js["spec"] == want["spec"]
    assert js["metadata"]["namespace"] == "default"
    rj = js["spec"]["replicatedJobs"][0]["template"]["spec"]
    pod = rj["template"]["spec"]
    c = pod["containers"][0]
    assert rj["parallelism"] == rj["completions"] == 2
    assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert c["command"] == ["python", "-m",
                            "datatunerx_tpu_torch.tuning.train"]
    assert c["args"][-2:] == ["--device", "cuda"]
    env = {e["name"]: e for e in c["env"]}
    assert env["DTX_NUM_PROCESSES"]["value"] == "2"
    assert env["DTX_COORDINATOR_ADDRESS"]["value"].endswith(":8476")
    for status, state in (
            ({"replicatedJobsStatus": [{"active": 2}]}, "Running"),
            ({"conditions": [{"type": "Failed", "status": "True"}]},
             "Failed"),
            ({"conditions": [{"type": "Completed", "status": "True"}]},
             "Succeeded")):
        _set_status(client, JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                    "t1", status)
        assert backend.status("t1") == state == tb.jobset_state(status)
    backend.delete("t1")
    assert backend.status("t1") == "NotFound"
    backend.delete("t1")  # idempotent


def test_serving_backend_deploys_the_port_server(cluster):
    srv, client, workdir = cluster
    backend = KubeServingBackend(client, out_dir=os.path.join(workdir, "s"))
    assert backend.status("s1") == "NotFound"
    backend.deploy("s1", {"llmPath": "/models/m", "checkpointPath": "/ckpt",
                          "slots": 4})
    backend.deploy("s1", {"llmPath": "/models/m"})  # 409: idempotent
    assert backend.status("s1") == "PENDING"
    assert backend.endpoint("s1") is None
    dep = client.get("apps", "v1", "deployments", "default", "s1")
    c = dep["spec"]["template"]["spec"]["containers"][0]
    assert c["command"] == ["python", "-m",
                            "datatunerx_tpu_torch.serving.server"]
    assert c["args"][c["args"].index("--slots") + 1] == "4"
    assert c["args"][-2:] == ["--device", "cuda"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    svc = client.get("", "v1", "services", "default", "s1")
    assert svc["spec"]["ports"][0]["port"] == 8000
    for status, state in (
            ({"availableReplicas": 1}, "HEALTHY"),
            ({"conditions": [{"type": "ReplicaFailure", "status": "True"}]},
             "FAILED"),
            ({"conditions": [{"type": "Progressing", "status": "False",
                              "reason": "ProgressDeadlineExceeded"}]},
             "FAILED")):
        _set_status(client, "apps", "v1", "deployments", "s1", status)
        assert backend.status("s1") == state == tb.deployment_state(status)
    _set_status(client, "apps", "v1", "deployments", "s1",
                {"availableReplicas": 1})
    assert backend.endpoint("s1") == "http://s1.default.svc:8000"
    backend.delete("s1")
    assert backend.status("s1") == "NotFound"
    backend.deploy("s2", {"llmPath": "/models/m"})
    dep = client.get("apps", "v1", "deployments", "default", "s2")
    assert "--slots" not in dep["spec"]["template"]["spec"]["containers"][
        0]["args"]


def test_reference_operator_takes_a_finetune_to_succeeded(cluster):
    """Pending → Running → Successful from the JobSet conditions the
    apiserver reports, with the port's GPU JobSet submitted and a manifest
    the port's trainer writes."""
    srv, client, workdir = cluster
    storage = os.path.join(workdir, "storage")
    # the CRs through the port's store over the port's client (it reads
    # that client's ApiError), as the workloads go through the port's
    # backend
    store = KubeObjectStore(client)
    training = KubeTrainingBackend(client, out_dir=os.path.join(workdir, "m"))
    mgr = build_manager(store, training, FakeServingBackend(),
                        storage_path=storage, with_scoring=False)
    _seed_deps(store)
    store.create(Finetune(metadata=ObjectMeta(name="mft"), spec={
        "llm": "llama2-7b", "dataset": "ds-a",
        "hyperparameter": {"hyperparameterRef": "hp-a"},
        "image": {"name": "img", "path": "/models/llama2-7b"}, "node": 2}))

    def wait_state(state, timeout=20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            mgr.run_until_idle()
            mgr.drain_scheduled()
            if store.get(Finetune, "mft").status.get("state") == state:
                return
            time.sleep(0.05)
        raise AssertionError(f"never reached {state}; at "
                             f"{store.get(Finetune, 'mft').status}")

    try:
        wait_state(Finetune.STATE_PENDING)
        js = client.get(JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                        "default", "mft")
        c = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"][
            "spec"]["containers"][0]
        assert c["command"][-1] == "datatunerx_tpu_torch.tuning.train"
        assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
        _set_status(client, JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                    "mft", {"replicatedJobsStatus": [{"active": 2}]})
        mgr.enqueue("Finetune", "default", "mft")
        wait_state(Finetune.STATE_RUNNING)
        uid = store.get(Finetune, "mft").metadata.uid
        write_manifest(storage, uid, "/storage/ckpt/9", metrics={"loss": 0.9})
        _set_status(client, JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                    "mft",
                    {"conditions": [{"type": "Completed", "status": "True"}]})
        mgr.enqueue("Finetune", "default", "mft")
        wait_state(Finetune.STATE_SUCCESSFUL)
        assert store.get(Finetune, "mft").status["llmCheckpoint"][
            "checkpointPath"] == "/storage/ckpt/9"
    finally:
        store.stop()


def test_each_store_reads_its_own_clients_errors(cluster):
    """The pairing each package keeps: the port's ``KubeObjectStore`` turns
    the port's ``ApiError`` 404 into NotFound (``try_get`` → None); the
    reference's store catches only the reference's ``ApiError``, so over
    the port's client the 404 escapes as the port's error."""
    from datatunerx_tpu.operator.kubestore import KubeObjectStore as JStore
    from datatunerx_tpu_torch.operator.store import NotFound

    srv, client, _ = cluster
    port = KubeObjectStore(client)
    assert port.try_get("LLM", "missing") is None
    with pytest.raises(NotFound):
        port.get("LLM", "missing")
    with pytest.raises(ApiError) as ei:
        JStore(client).try_get("LLM", "missing")
    assert ei.value.status == 404
