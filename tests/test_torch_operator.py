"""The port's control plane (``datatunerx_tpu_torch/operator`` and the
Scoring controller) against the JAX package's, on the CPU.

- ``tests/test_operator.py``'s scenarios (lifecycle, missing deps,
  failure, deletion, full pipeline, plugin scoring, failure propagation,
  fan-out and best version, pause/resume, all-failed, bounded retry with
  resume) run through both packages' ``build_manager`` over each package's
  Fake backends with the same CR sequence: every object's spec and status
  and the backends' workloads are equal after every sync, with uids,
  timestamps and resource versions masked;
- the webhooks give the same verdicts (and defaults) over one table of
  good and bad CRs;
- ``generate`` renders the same trainer args and serving specs;
- placement makes the same decisions but for the pinned card divergences
  (one card a host, the hold reason, the 80 GB budget);
- the health probe is healthy on ``device="cpu"`` and unhealthy on
  ``cuda`` without a card;
- ``--backend kube`` keeps the CRs in an apiserver
  (``tests/fake_apiserver.py``)."""

import importlib
import json
import random
import re

import pytest
import torch

PKGS = ("datatunerx_tpu", "datatunerx_tpu_torch")
KINDS = ("Dataset", "Finetune", "FinetuneExperiment", "FinetuneJob",
         "Hyperparameter", "LLM", "LLMCheckpoint", "ObjectMeta", "Scoring")
_ISO = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Side:
    """One package's store, fake backends and manager, recording a masked
    snapshot after every sync."""

    def __init__(self, pkg, tmp, with_scoring=False, **mgr_kw):
        self.pkg = pkg
        api = _mod(pkg, "operator.api")
        for k in KINDS:
            setattr(self, k, getattr(api, k))
        self.api = api
        be = _mod(pkg, "operator.backends")
        self.training = be.FakeTrainingBackend()
        self.serving = be.FakeServingBackend()
        self.store = _mod(pkg, "operator.store").ObjectStore()
        self.storage = str(tmp / pkg / "storage")
        self.write_manifest = _mod(pkg, "training.checkpoint").write_manifest
        self.mgr = _mod(pkg, "operator.manager").build_manager(
            self.store, self.training, self.serving,
            storage_path=self.storage, with_scoring=with_scoring, **mgr_kw)
        self.snaps = []

    def idle(self):
        self.mgr.run_until_idle()
        self.snap()

    def drain(self):
        self.mgr.drain_scheduled()
        self.snap()

    def enqueue(self, kind, name):
        self.mgr.enqueue(kind, "default", name)

    def manifest(self, kind, name, ckpt, metrics):
        obj = self.store.get(getattr(self, kind), name)
        self.write_manifest(self.storage, obj.metadata.uid, ckpt,
                            metrics=metrics)

    def snap(self):
        objs, uids = [], {}
        for kind in self.api.ALL_KINDS:
            for o in self.store.list(kind, namespace=None):
                d = o.to_dict()
                uids[d["metadata"]["uid"]] = f"<uid {kind.kind}/" \
                    f"{d['metadata']['name']}>"
                m = d["metadata"]
                m["deletion_timestamp"] = m["deletion_timestamp"] is not None
                for k in ("uid", "resource_version", "creation_timestamp"):
                    m.pop(k)
                objs.append(d)
        objs.sort(key=lambda d: (d["kind"], d["metadata"]["namespace"],
                                 d["metadata"]["name"]))
        state = {"objects": objs,
                 "training": {"jobs": self.training.jobs,
                              "states": self.training.states,
                              "deleted": self.training.deleted},
                 "serving": {"apps": self.serving.apps,
                             "states": self.serving.states,
                             "deleted": self.serving.deleted}}
        text = json.dumps(state, sort_keys=True, default=str)
        for uid, label in uids.items():
            text = text.replace(uid, label)
        text = _ISO.sub("<time>", text.replace(self.storage, "<storage>"))
        self.snaps.append(json.loads(text))


# ------------------------------------------------------------ scenarios

def _seed_deps(s, ns="default"):
    s.store.create(s.LLM(metadata=s.ObjectMeta(name="llama2-7b", namespace=ns),
                         spec={"path": "/models/llama2-7b"}))
    s.store.create(s.Hyperparameter(
        metadata=s.ObjectMeta(name="hp-a", namespace=ns),
        spec={"parameters": {
            "scheduler": "cosine", "optimizer": "adamw", "loRA_R": "8",
            "loRA_Alpha": "32", "loRA_Dropout": "0.1", "learningRate": "2e-4",
            "epochs": "1", "blockSize": "512", "batchSize": "2",
            "gradAccSteps": "1", "PEFT": "true", "FP16": "false",
        }}))
    s.store.create(s.Dataset(
        metadata=s.ObjectMeta(name="ds-a", namespace=ns),
        spec={"datasetMetadata": {"datasetInfo": {
            "subsets": [{"splits": {
                "train": {"file": "/data/train.csv"},
                "validate": {"file": "/data/val.csv"},
            }}],
            "features": [
                {"name": "instruction", "mapTo": "q"},
                {"name": "response", "mapTo": "a"},
            ],
        }}}))
    s.snap()


def _job_spec(suffix=""):
    return {"finetune": {
        "name": f"job{suffix}-finetune",
        "finetuneSpec": {
            "llm": "llama2-7b", "dataset": "ds-a",
            "hyperparameter": {"hyperparameterRef": "hp-a"},
            "image": {"name": "img", "path": "/models/llama2-7b"},
            "node": 1,
        }}}


def _ft(s, name, **extra):
    spec = {"llm": "llama2-7b", "dataset": "ds-a",
            "hyperparameter": {"hyperparameterRef": "hp-a"},
            "image": {"path": "/m"}}
    spec.update(extra)
    return s.Finetune(metadata=s.ObjectMeta(name=name), spec=spec)


def lifecycle(s):
    s.store.create(_ft(s, "run1", hyperparameter={
        "hyperparameterRef": "hp-a", "overrides": {"learningRate": "5e-4"}},
        image={"name": "img", "path": "/models/llama2-7b"}, node=2))
    s.idle()
    s.training.set_state("run1", "Running")
    s.enqueue("Finetune", "run1")
    s.idle()
    s.manifest("Finetune", "run1", "/storage/ckpt/42", {"loss": 1.5})
    s.training.set_state("run1", "Succeeded")
    s.enqueue("Finetune", "run1")
    s.idle()
    assert s.store.get(s.Finetune, "run1").status["state"] == \
        s.Finetune.STATE_SUCCESSFUL


def missing_deps(s):
    s.store.create(_ft(s, "run2", llm="nope"))
    s.idle()
    assert "run2" not in s.training.jobs


def failure(s):
    s.store.create(_ft(s, "run3"))
    s.idle()
    s.training.set_state("run3", "Failed")
    s.enqueue("Finetune", "run3")
    s.idle()
    assert s.store.get(s.Finetune, "run3").status["state"] == \
        s.Finetune.STATE_FAILED


def deletion(s):
    s.store.create(_ft(s, "run4"))
    s.idle()
    s.store.delete(s.Finetune, "run4")
    s.idle()
    assert "run4" in s.training.deleted


def _drive_job_to_serve(s, name, spec=None):
    spec = spec or _job_spec()
    spec["finetune"]["name"] = f"{name}-finetune"
    s.store.create(s.FinetuneJob(metadata=s.ObjectMeta(name=name), spec=spec))
    s.idle()
    s.drain()
    ft = f"{name}-finetune"
    s.training.set_state(ft, "Succeeded")
    s.manifest("Finetune", ft, "/storage/ckpt/7", {"loss": 1.0})
    s.enqueue("Finetune", ft)
    s.idle()
    s.drain()
    assert name in s.serving.apps


def full_pipeline(s):
    _drive_job_to_serve(s, "jobA")
    s.serving.set_state("jobA", "HEALTHY")
    s.enqueue("FinetuneJob", "jobA")
    s.idle()
    s.drain()
    sc = s.store.get(s.Scoring, "jobA")
    sc.status["score"] = "87.5"
    s.store.update(sc)
    s.idle()
    s.drain()
    job = s.store.get(s.FinetuneJob, "jobA")
    assert job.status["state"] == s.FinetuneJob.STATE_SUCCESSFUL
    assert "jobA" in s.serving.deleted


def plugin_scoring(s):
    spec = _job_spec("P")
    spec["scoringPluginConfig"] = {"name": "my-plugin",
                                   "parameters": '{"k": 1}'}
    _drive_job_to_serve(s, "jobP", spec)
    s.serving.set_state("jobP", "HEALTHY")
    s.enqueue("FinetuneJob", "jobP")
    s.idle()
    assert s.store.get(s.Scoring, "jobP").spec["plugin"]["loadPlugin"]


def failure_propagates(s):
    spec = _job_spec("F")
    spec["finetune"]["name"] = "jobF-finetune"
    spec["finetune"]["finetuneSpec"]["backoffLimit"] = 0
    s.store.create(s.FinetuneJob(metadata=s.ObjectMeta(name="jobF"),
                                 spec=spec))
    s.idle()
    s.drain()
    s.training.set_state("jobF-finetune", "Failed")
    s.enqueue("Finetune", "jobF-finetune")
    s.idle()
    s.drain()
    assert s.store.get(s.FinetuneJob, "jobF").status["state"] == \
        s.FinetuneJob.STATE_FAILED


def _experiment(s, names, fix_names=False):
    exp = s.FinetuneExperiment(metadata=s.ObjectMeta(name="exp1"), spec={
        "finetuneJobs": [{"name": n, "spec": _job_spec(n)} for n in names]})
    if fix_names:
        for e in exp.spec["finetuneJobs"]:
            e["spec"]["finetune"]["name"] = f"job{e['name']}-finetune"
    return exp


def _finish_job(s, name, score):
    ft = f"job{name}-finetune"
    s.training.set_state(ft, "Succeeded")
    s.manifest("Finetune", ft, f"/ckpt/{name}", {})
    s.enqueue("Finetune", ft)
    s.idle()
    s.drain()
    s.serving.set_state(name, "HEALTHY")
    s.enqueue("FinetuneJob", name)
    s.idle()
    sc = s.store.get(s.Scoring, name)
    sc.status["score"] = score
    s.store.update(sc)
    s.idle()
    s.drain()


def fanout_best_version(s):
    s.store.create(_experiment(s, ["expj1", "expj2"], fix_names=True))
    s.idle()
    s.drain()
    _finish_job(s, "expj1", "55.0")
    _finish_job(s, "expj2", "91.0")
    s.drain()
    exp = s.store.get(s.FinetuneExperiment, "exp1")
    assert exp.status["bestVersion"]["score"] == "91.0"


def pause_resume(s):
    s.store.create(_experiment(s, ["pj1"]))
    s.idle()
    s.drain()
    for pending in (True, False):
        exp = s.store.get(s.FinetuneExperiment, "exp1")
        exp.spec["pending"] = pending
        s.store.update(exp)
        s.idle()
        s.drain()
    assert s.store.try_get(s.FinetuneJob, "pj1") is not None


def all_failed(s):
    s.store.create(_experiment(s, ["fj1"]))
    s.idle()
    s.drain()
    s.training.set_state("jobfj1-finetune", "Failed")
    s.enqueue("Finetune", "jobfj1-finetune")
    s.idle()
    s.drain()
    assert s.store.get(s.FinetuneExperiment, "exp1").status["state"] == \
        s.FinetuneExperiment.STATE_FAILED


def bounded_retry(s):
    s.store.create(_ft(s, "run-retry", backoffLimit=2))
    s.idle()
    for _ in range(2):
        s.training.set_state("run-retry", "Failed")
        s.enqueue("Finetune", "run-retry")
        s.idle()
        s.drain()
    s.manifest("Finetune", "run-retry", "/ckpt/r", {})
    s.training.set_state("run-retry", "Succeeded")
    s.enqueue("Finetune", "run-retry")
    s.idle()
    s.store.create(_ft(s, "run-exhaust", backoffLimit=0))
    s.idle()
    s.training.set_state("run-exhaust", "Failed")
    s.enqueue("Finetune", "run-exhaust")
    s.idle()
    assert s.store.get(s.Finetune, "run-retry").status["retries"] == 2
    assert s.store.get(s.Finetune, "run-exhaust").status["state"] == \
        s.Finetune.STATE_FAILED


SCENARIOS = [lifecycle, missing_deps, failure, deletion, full_pipeline,
             plugin_scoring, failure_propagates, fanout_best_version,
             pause_resume, all_failed, bounded_retry]


def _run_both(tmp_path, scenario, seed_deps=True, **kw):
    sides = []
    for pkg in PKGS:
        random.seed(1234)  # rand_suffix names
        s = Side(pkg, tmp_path, **kw)
        if seed_deps:
            _seed_deps(s)
        scenario(s)
        sides.append(s)
    return sides


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_controllers_make_the_reference_decisions(tmp_path, scenario):
    ref, port = _run_both(tmp_path, scenario)
    assert len(port.snaps) == len(ref.snaps) > 1
    for i, (g, w) in enumerate(zip(port.snaps, ref.snaps)):
        assert g == w, f"{scenario.__name__}: sync {i} differs"


# ------------------------------------------------------------- webhooks

def _webhook_table(api):
    O = api.ObjectMeta
    full_hp = {"scheduler": "cosine", "optimizer": "adamw", "loRA_R": "8"}
    return [
        api.Hyperparameter(metadata=O(name="h0"), spec={}),
        api.Hyperparameter(metadata=O(name="h1"),
                           spec={"parameters": {"scheduler": "warp-speed"}}),
        api.Hyperparameter(metadata=O(name="h2"), spec={
            "parameters": {"int4": "true", "int8": "true"}}),
        api.Hyperparameter(metadata=O(name="h3"),
                           spec={"parameters": dict(full_hp)}),
        api.Hyperparameter(metadata=O(name="h4"), spec={
            "parameters": {"learningRate": "fast"}}),
        api.Hyperparameter(metadata=O(name="h5"), spec={
            "parameters": {"meshShape": "dp=2,tp=2"}}),
        api.Dataset(metadata=O(name="d0"), spec={}),
        api.Dataset(metadata=O(name="d1"), spec={"datasetMetadata": {
            "datasetInfo": {"subsets": [{"splits": {
                "train": {"file": "/t.csv"}}}]}}}),
        api.FinetuneJob(metadata=O(name="j0"), spec={
            "finetune": {"finetuneSpec": {"llm": "x"}}}),
        api.FinetuneJob(metadata=O(name="j1"), spec=_job_spec("1")),
        api.FinetuneJob(metadata=O(name="j2"), spec=dict(
            _job_spec("2"), serveConfig={"specTree": "4x3"})),
        api.FinetuneJob(metadata=O(name="j3"), spec=dict(
            _job_spec("3"), serveConfig={"specTree": "4x3",
                                         "specDraft": "take:1"})),
        api.FinetuneJob(metadata=O(name="j4"), spec=dict(
            _job_spec("4"), serveConfig={"tenants": {
                "a": {"tier": "pinned", "adapters": ["x"]}}})),
        api.FinetuneJob(metadata=O(name="j5"), spec=dict(
            _job_spec("5"), serveConfig={"tenants": {
                "a": {"tier": "platinum"}}})),
        api.FinetuneExperiment(metadata=O(name="e0"), spec={}),
        api.FinetuneExperiment(metadata=O(name="e1"), spec={
            "finetuneJobs": [{"name": "x", "spec": _job_spec("x")}]}),
        api.Scoring(metadata=O(name="s0"), spec={}),
        api.Scoring(metadata=O(name="s1"), spec={
            "inferenceService": "http://x/chat/completions"}),
        api.LLM(metadata=O(name="l0"), spec={}),
    ]


def test_webhooks_give_the_reference_verdicts():
    verdicts = []
    for pkg in PKGS:
        api = _mod(pkg, "operator.api")
        wh = _mod(pkg, "operator.webhooks")
        out = []
        for obj in _webhook_table(api):
            try:
                wh.admit(obj)
                out.append(("ok", obj.spec))
            except wh.AdmissionError as e:
                out.append(("denied", str(e)))
        verdicts.append(out)
        with pytest.raises(wh.AdmissionError):
            wh.AdmittingStore(_mod(pkg, "operator.store").ObjectStore()
                              ).create(api.Dataset(
                                  metadata=api.ObjectMeta(name="d"), spec={}))
    ref, port = verdicts
    assert port == ref
    assert {v for v, _ in port} == {"ok", "denied"}


# ------------------------------------------------------------- generate

def test_generate_renders_the_reference_args_and_specs():
    out = []
    for pkg in PKGS:
        api = _mod(pkg, "operator.api")
        gen = _mod(pkg, "operator.generate")
        ft = api.Finetune(metadata=api.ObjectMeta(name="qi", uid="u-1"),
                          spec={"llm": "m", "dataset": "d",
                                "hyperparameter": {"hyperparameterRef": "hp"},
                                "image": {"name": "img", "path": "/m"},
                                "node": 2})
        ds = {"datasetMetadata": {"datasetInfo": {
            "subsets": [{"splits": {"train": {"file": "/t.csv"},
                                    "validate": {"file": "/v.csv"}}}],
            "features": [{"name": "instruction", "mapTo": "q"}]}}}
        params = gen.merge_hyperparameters(
            {"int4": "true", "quantImpl": "pallas", "attention": "flash",
             "learningRate": "1e-4", "meshShape": "dp=2", "loRATarget":
             "q_proj,v_proj", "batchSize": "4", "rewardModel": "rm"},
            {"learningRate": "3e-4"})
        args = gen.build_trainer_args(ft, ds, params, uid="u-1",
                                      num_workers=2)
        spec = gen.generate_training_spec(ft, args, num_hosts=2)
        job = api.FinetuneJob(metadata=api.ObjectMeta(name="j", uid="u-2"),
                              spec=dict(_job_spec(), serveConfig={
                                  "slots": 4, "kvBlockSize": 16,
                                  "tenants": {"a": {"tier": "pinned"}}},
                                  scoringPluginConfig={
                                      "name": "p", "parameters": '{"k": 1}'}))
        random.seed(7)
        serving = gen.generate_serving_spec(
            job, {"llmPath": "/m", "checkpointPath": "/ckpt/1"})
        scorings = [gen.generate_builtin_scoring(job, "http://e/chat"),
                    gen.generate_plugin_scoring(job, "http://e/chat")]
        out.append(json.loads(json.dumps(
            {"args": args, "spec": spec, "serving": serving,
             "scorings": [s.to_dict() for s in scorings]}, default=str)))
    ref, port = out
    for s in (ref, port):  # uids of the generated CRs
        for sc in s["scorings"]:
            sc["metadata"].pop("uid")
            sc["metadata"].pop("creation_timestamp")
    assert port == ref
    assert "--quantization" in port["args"] and "--num_workers" in port["args"]


# ------------------------------------------------------------ placement

def test_placement_makes_the_reference_decisions_but_for_cards(
        tmp_path, monkeypatch):
    """Two one-node jobs over a pool of one slice: the second holds until
    the first ends, in both packages. The port's slice is 1 card (one
    process a card), the reference's 4 chips (one v5e host): the same
    decisions, with the port's hold reason and host count."""
    from datatunerx_tpu_torch.operator import finetune_controller as tfc

    pools = {"datatunerx_tpu": [{"name": "s0", "topology": "2x2",
                                 "chips": 4}],
             "datatunerx_tpu_torch": [{"name": "s0", "topology": "1x1",
                                       "chips": 1}]}
    sides = []
    for pkg in PKGS:
        monkeypatch.setenv("TPU_SLICE_POOL", json.dumps(pools[pkg]))
        pool = _mod(pkg, "operator.placement").pool_from_env()
        random.seed(1)
        s = Side(pkg, tmp_path, slice_pool=pool)
        _seed_deps(s)
        s.store.create(_ft(s, "a", node=1))
        s.store.create(_ft(s, "b", node=1))
        s.idle()
        held = s.store.get(s.Finetune, "b").status
        assert held["state"] == s.Finetune.STATE_PENDING
        assert "b" not in s.training.jobs
        s.manifest("Finetune", "a", "/ckpt/a", {})
        s.training.set_state("a", "Succeeded")
        s.enqueue("Finetune", "a")
        s.idle()
        s.enqueue("Finetune", "b")
        s.idle()
        assert "b" in s.training.jobs
        sides.append((s, pool))
    (ref, rpool), (port, tpool) = sides
    assert port.store.get(port.Finetune, "b").status["placement"]["chips"] == 1
    assert ref.snaps[-1]["objects"] != port.snaps[-1]["objects"]  # chips
    # equal once the slice's size and the hold reason are set aside
    for i, (g, w) in enumerate(zip(port.snaps, ref.snaps)):
        g, w = json.dumps(g), json.dumps(w)
        g = g.replace(tfc.PLACEMENT_PENDING, "<hold>").replace(
            '"topology": "1x1"', '"topology": "<t>"').replace(
            '"chips": 1', '"chips": "<n>"')
        w = w.replace("no free TPU slice", "<hold>").replace(
            '"topology": "2x2"', '"topology": "<t>"').replace(
            '"chips": 4', '"chips": "<n>"')
        assert g == w, f"placement sync {i}"
    assert tpool.free_count() == rpool.free_count() == 0
    assert tfc.CARDS_PER_HOST == 1


def test_admission_budget_is_the_card_budget(tmp_path, monkeypatch):
    """A 13B full finetune on one card is refused against the 80 GB card
    budget (``capacity.check_admission``'s ``h100-80gb``)."""
    from datatunerx_tpu_torch.operator import capacity

    seen = {}
    real = capacity.check_admission

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(capacity, "check_admission", spy)
    s = Side("datatunerx_tpu_torch", tmp_path)
    _seed_deps(s)
    hp = s.store.get(s.Hyperparameter, "hp-a")
    hp.spec["parameters"]["PEFT"] = "false"
    s.store.update(hp)
    s.store.create(_ft(s, "big", image={"path": "preset:llama2-13b"}))
    s.idle()
    st = s.store.get(s.Finetune, "big").status
    assert "generation" not in seen and seen["n_chips"] == 1
    assert st["state"] == s.Finetune.STATE_FAILED, st
    assert "h100-80gb" in st["admissionDenied"]


# --------------------------------------------------------- health, kube

def test_health_probe_runs_on_the_device_it_is_given():
    from datatunerx_tpu_torch.operator.health import (
        DeviceHealthProbe,
        probe_device_once,
    )

    assert probe_device_once(60, device="cpu") is None
    p = DeviceHealthProbe(interval_s=3600, device="cpu")
    assert p.check_now() and p.last_error is None
    if not torch.cuda.is_available():
        err = probe_device_once(60, device="cuda")
        assert err is not None and "no CUDA device" in err
        p = DeviceHealthProbe(interval_s=3600)  # the default is the card
        assert not p.check_now()


def test_kube_backend_builds_the_manager_over_an_apiserver(tmp_path):
    """``--backend kube``: the manager keeps the CRs in the apiserver, so
    an LLM created through its REST API is an object of the fake
    apiserver's."""
    import os
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from datatunerx_tpu_torch.operator.kubeclient import KubeClient
    from tests.fake_apiserver import FakeKubeApiServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    srv = FakeKubeApiServer().start()
    api_port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = open(tmp_path / "manager.log", "w")
    mgr = subprocess.Popen(
        [sys.executable, "-m", "datatunerx_tpu_torch.operator.manager",
         "--backend", "kube", "--kube-url", srv.url,
         "--webhook-bind-address", "disabled",
         "--workdir", str(tmp_path / "work"),
         "--metrics-bind-address", f"127.0.0.1:{api_port}",
         "--health-probe-bind-address", f"127.0.0.1:{free_port()}"],
        stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=root))
    log.close()
    try:
        deadline = time.monotonic() + 60
        while "running; api+metrics" not in (
                tmp_path / "manager.log").read_text():
            assert mgr.poll() is None, (tmp_path / "manager.log").read_text()
            assert time.monotonic() < deadline
            time.sleep(0.1)
        body = {"apiVersion": "core.datatunerx.io/v1beta1", "kind": "LLM",
                "metadata": {"name": "m", "namespace": "default"},
                "spec": {"path": "/models/m"}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{api_port}/apis/core.datatunerx.io/v1beta1/llm",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
        got = KubeClient(base_url=srv.url).get(
            "core.datatunerx.io", "v1beta1", "llms", "default", "m")
        assert got["spec"] == {"path": "/models/m"}
    finally:
        mgr.terminate()
        mgr.wait(30)
        srv.stop()


def test_fake_backends_match_the_reference():
    ref = _mod("datatunerx_tpu", "operator.backends")
    port = _mod("datatunerx_tpu_torch", "operator.backends")
    for name in ("FakeTrainingBackend", "FakeServingBackend"):
        r, p = getattr(ref, name)(), getattr(port, name)()
        for b in (r, p):
            if hasattr(b, "submit"):
                b.submit("x", {"a": 1})
            else:
                b.deploy("x", {"a": 1})
                b.set_state("x", "HEALTHY")
        assert p.status("x") == r.status("x")
        if hasattr(p, "endpoint"):
            assert p.endpoint("x") == r.endpoint("x")
        p.delete("x")
        r.delete("x")
        assert p.status("x") == r.status("x") == "NotFound"
        assert p.deleted == r.deleted == ["x"]
