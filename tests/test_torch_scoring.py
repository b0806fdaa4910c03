"""The port's scoring (``datatunerx_tpu_torch/scoring``: builtin, plugin,
dataset_scoring and the Scoring controller) against the JAX package's,
over the same stub endpoints on the CPU: ``tests/test_scoring.py``'s and
``tests/test_dataset_scoring.py``'s cases give equal scores, details,
retries and permanent failures in both packages."""

import importlib
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from datatunerx_tpu.utils import storage as jstorage

PKGS = ("datatunerx_tpu", "datatunerx_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Stub:
    """/chat/completions answers the probes ('say blue' → blue) and echoes
    'answer <i>' for a prompt ending in i; /perplexity a fixed NLL of 0.5
    a token."""

    def __init__(self):
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                req = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                outer.calls.append(self.path)
                if self.path == "/perplexity":
                    n = len(req["completion"].split())
                    body = {"nll_sum": 0.5 * n, "num_tokens": n}
                else:
                    prompt = req["messages"][0]["content"]
                    answer = {"say blue": "blue", "say cat": "cat"}.get(
                        prompt, f"answer {prompt.split()[-1]}")
                    body = {"choices": [{"message": {
                        "role": "assistant", "content": answer}}]}
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        self.calls = []
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}/chat/completions"

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture()
def stub():
    s = _Stub()
    yield s
    s.stop()


@pytest.fixture()
def eval_split():
    import fsspec

    rows = ["q,a"] + [f"question {i},answer {i}" for i in range(120)]
    jstorage.write_text("memory://ds/test.csv", "\n".join(rows))
    yield "memory://ds/test.csv"
    fs = fsspec.filesystem("memory")
    for p in list(fs.store):
        fs.store.pop(p, None)


def _dataset_spec(test_file):
    return {"datasetMetadata": {"datasetInfo": {
        "subsets": [{"splits": {"train": {"file": "/nope/train.csv"},
                                "test": {"file": test_file}}}],
        "features": [{"name": "instruction", "mapTo": "q"},
                     {"name": "response", "mapTo": "a"}]}}}


def _manager(pkg, tmp_path):
    store = _mod(pkg, "operator.store").ObjectStore()
    be = _mod(pkg, "operator.backends")
    mgr = _mod(pkg, "operator.manager").build_manager(
        store, be.FakeTrainingBackend(), be.FakeServingBackend(),
        storage_path=str(tmp_path / pkg), with_scoring=True)
    return store, mgr, _mod(pkg, "operator.api")


def _both(fn):
    ref, port = (fn(pkg) for pkg in PKGS)
    assert port == ref
    return port


def test_metrics_math_matches_the_reference():
    def run(pkg):
        m = _mod(pkg, "scoring.metrics")
        return (m.rouge_n("the cat sat", "the cat sat", 1),
                m.rouge_l("a b c d", "a x c d"),
                m.bleu4("same tokens here ok", "same tokens here ok"),
                m.generation_scores("paris", "Paris is the capital"))

    out = _both(run)
    assert out[0] == 1.0 and out[1] == pytest.approx(0.75)


def test_builtin_scoring_with_custom_probes(stub, tmp_path):
    def run(pkg):
        store, mgr, api = _manager(pkg, tmp_path)
        store.create(api.Scoring(metadata=api.ObjectMeta(name="sc1"), spec={
            "inferenceService": stub.url, "plugin": {"loadPlugin": False},
            "probes": [{"prompt": "say blue", "reference": "blue"},
                       {"prompt": "say cat", "reference": "cat"}]}))
        mgr.run_until_idle()
        st = store.get(api.Scoring, "sc1").status
        return st["score"], st["details"]

    score, details = _both(run)
    assert score == "100.0" and len(details) == 2


def test_builtin_default_probes_score_alike(stub, tmp_path):
    def run(pkg):
        b = _mod(pkg, "scoring.builtin")
        return b.score_endpoint(stub.url, timeout=10)

    _both(run)


def test_plugin_scoring(stub, tmp_path):
    def run(pkg):
        _mod(pkg, "scoring.plugin").register_plugin(
            "always-42", lambda url, params: 42.0)
        store, mgr, api = _manager(pkg, tmp_path)
        store.create(api.Scoring(metadata=api.ObjectMeta(name="sc2"), spec={
            "inferenceService": stub.url,
            "plugin": {"loadPlugin": True, "name": "always-42"}}))
        mgr.run_until_idle()
        return store.get(api.Scoring, "sc2").status["score"]

    assert _both(run) == "42.0"


def test_scoring_retries_on_unreachable_endpoint(tmp_path):
    def run(pkg):
        store, mgr, api = _manager(pkg, tmp_path)
        store.create(api.Scoring(metadata=api.ObjectMeta(name="sc3"), spec={
            "inferenceService": "http://127.0.0.1:1/chat/completions",
            "plugin": {"loadPlugin": False}}))
        mgr.run_until_idle()
        st = store.get(api.Scoring, "sc3").status
        return st.get("score"), "lastError" in st

    assert _both(run) == (None, True)


def test_split_and_column_extraction(eval_split):
    def run(pkg):
        ds = _mod(pkg, "scoring.dataset_scoring")
        spec = _dataset_spec(eval_split)
        return (ds.split_file_from_dataset_spec(spec),
                ds.columns_from_dataset_spec(spec),
                ds.load_eval_records(spec, max_examples=100),
                ds.split_file_from_dataset_spec({"datasetMetadata": {
                    "datasetInfo": {"subsets": [{"splits": {
                        "validate": {"file": "/v.csv"}}}]}}}),
                ds.split_file_from_dataset_spec({"datasetMetadata": {}}))

    split, cols, records, val, none = _both(run)
    assert split == eval_split and val == "/v.csv" and none is None
    assert len(records) == 100
    assert records[0] == {"prompt": "question 0", "reference": "answer 0"}


@pytest.mark.parametrize("metric,n", [("generation", 100),
                                      ("perplexity", 50)])
def test_dataset_scoring_over_split(eval_split, stub, metric, n):
    def run(pkg):
        ds = _mod(pkg, "scoring.dataset_scoring")
        return ds.score_dataset(stub.url, _dataset_spec(eval_split),
                                metric=metric, max_examples=n)

    result = _both(run)
    if metric == "generation":
        assert result["score"] == "100.0"
        assert result["details"]["examples"] == 100
    else:
        assert abs(float(result["score"]) - 100 * math.exp(-0.5)) < 0.01
        assert "/perplexity" in stub.calls


def test_controller_dataset_scoring_e2e(eval_split, stub):
    def run(pkg):
        api = _mod(pkg, "operator.api")
        store = _mod(pkg, "operator.store").ObjectStore()
        store.create(api.Dataset(metadata=api.ObjectMeta(name="ds-eval"),
                                 spec=_dataset_spec(eval_split)))
        store.create(api.Scoring(metadata=api.ObjectMeta(name="s-ds"), spec={
            "inferenceService": stub.url, "datasetRef": "ds-eval"}))
        ctl = _mod(pkg, "scoring.controller").ScoringController(timeout=10)
        res = ctl.reconcile(store, store.get(api.Scoring, "s-ds"))
        st = store.get(api.Scoring, "s-ds").status
        return res, st["score"], st["details"]

    res, score, details = _both(run)
    assert res is None and score == "100.0" and details["examples"] == 100


@pytest.mark.parametrize("case", ["missing-dataset", "bad-metric"])
def test_controller_retry_and_permanent_failure(case):
    spec = ({"inferenceService": "http://x/chat/completions",
             "datasetRef": "absent"} if case == "missing-dataset" else
            {"inferenceService": "http://x/chat/completions",
             "datasetRef": "d", "metric": "vibes"})

    def run(pkg):
        api = _mod(pkg, "operator.api")
        mod = _mod(pkg, "scoring.controller")
        store = _mod(pkg, "operator.store").ObjectStore()
        store.create(api.Scoring(metadata=api.ObjectMeta(name="s"),
                                 spec=dict(spec)))
        res = mod.ScoringController(timeout=1).reconcile(
            store, store.get(api.Scoring, "s"))
        return (None if res is None else res.requeue_after, mod.RETRY_S,
                store.get(api.Scoring, "s").status)

    requeue, retry_s, status = _both(run)
    if case == "missing-dataset":
        assert requeue == retry_s and "not found" in status["lastError"]
    else:
        assert requeue is None and "invalid scoring spec" in status["error"]
