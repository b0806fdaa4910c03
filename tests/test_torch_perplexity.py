"""Perplexity (``/perplexity``) in the port against the JAX package:
``prepare_nll_inputs`` equal, ``nll_impl`` on the same weights (the JAX
``preset:debug`` export, loaded by each package's own loader; bf16 forwards
in both, so ``nll_sum`` agrees to 1e-2 relative), the engines' ``perplexity``
(the port's dense and paged ``BatchedEngine`` and its ``InferenceEngine``
against the JAX engines), the server route's keys and error codes against
the JAX server's, and the reference's own scoring client
(``scoring/dataset_scoring.query_perplexity``) POSTing at a port server."""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.scoring.dataset_scoring import query_perplexity
from datatunerx_tpu.serving import engine as jengine
from datatunerx_tpu.serving import server as jserver
from datatunerx_tpu.serving.batched_engine import BatchedEngine as JBatched
from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.serving import engine as tengine
from datatunerx_tpu_torch.serving import server as tserver
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer

RTOL = 1e-2  # bf16 forwards round in different places in the two packages
KW = dict(template="vanilla", max_seq_len=256)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("debug_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _cases(tok):
    return {
        "short": (tok.encode("the quick brown"), tok.encode(" fox jumps")),
        "long_prompt": (tok.encode("context " * 60), tok.encode(" answer")),
        "long_completion": (tok.encode("q"), tok.encode("word " * 70)),
        "empty_prompt": ([], tok.encode("only a completion")),
    }


@pytest.mark.parametrize("max_seq_len", [64, 256])
@pytest.mark.parametrize("case", ["short", "long_prompt", "long_completion",
                                  "empty_prompt"])
def test_prepare_nll_inputs_equal(case, max_seq_len):
    _, _, tok = load_model_and_tokenizer("preset:debug")
    p, c = _cases(tok)[case]
    jt, jm, jn = jengine.prepare_nll_inputs(p, c, tok.eos_token_id,
                                            max_seq_len)
    tt, tm, tn = tengine.prepare_nll_inputs(p, c, tok.eos_token_id,
                                            max_seq_len)
    assert tn == jn
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tm.tolist() == np.asarray(jm).tolist()


@pytest.mark.parametrize("case", ["short", "long_prompt", "long_completion"])
def test_nll_impl_matches_reference(export_dir, case):
    jcfg, jparams, tok = jload(export_dir, dtype=jnp.bfloat16)
    tcfg, tparams, _ = load_model_and_tokenizer(export_dir,
                                                dtype=torch.bfloat16)
    p, c = _cases(tok)[case]
    jt, jm, _ = jengine.prepare_nll_inputs(p, c, tok.eos_token_id, 256)
    tt, tm, _ = tengine.prepare_nll_inputs(p, c, tok.eos_token_id, 256)
    js, jn = jengine.nll_impl(jparams, jcfg, jt, jm)
    with torch.inference_mode():
        ts, tn = tengine.nll_impl(tparams, tcfg, tt, tm)
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(float(ts), float(js), rtol=RTOL)
    want = jengine.nll_result(float(js), int(jn))
    got = tengine.nll_result(float(ts), int(tn))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=RTOL * 10)


@pytest.fixture(scope="module")
def jax_engines(export_dir):
    single = jengine.InferenceEngine(export_dir, **KW)
    batched = JBatched(export_dir, slots=2, **KW)
    yield single, batched
    batched.close()


@pytest.mark.parametrize("which", ["dense", "paged", "single"])
def test_engine_perplexity_matches_jax_engines(export_dir, jax_engines,
                                               which):
    jsingle, jbatched = jax_engines
    if which == "single":
        eng = tengine.InferenceEngine(export_dir, device="cpu", **KW)
        ref = jsingle
    else:
        eng = BatchedEngine(export_dir, slots=2, device="cpu",
                            kv_block_size=16 if which == "paged" else 0,
                            **KW)
        ref = jbatched
    try:
        for p, c in _cases(eng.tokenizer).values():
            want, got = ref.perplexity(p, c), eng.perplexity(p, c)
            assert got["num_tokens"] == want["num_tokens"]
            np.testing.assert_allclose(got["nll_sum"], want["nll_sum"],
                                       rtol=RTOL)
            np.testing.assert_allclose(got["mean_nll"], want["mean_nll"],
                                       rtol=RTOL)
        if which != "single":
            with pytest.raises(KeyError, match="unknown adapter"):
                eng.perplexity([1, 2], [3], adapter="nope")
    finally:
        if which != "single":
            eng.close()


def test_batched_perplexity_beside_decode():
    """A scoring call on the caller's thread while the scheduler decodes:
    both finish and the score equals the idle engine's."""
    eng = BatchedEngine("preset:debug", slots=2, device="cpu", **KW)
    try:
        tok = eng.tokenizer
        p, c = tok.encode("score me"), tok.encode(" please")
        idle = eng.perplexity(p, c)
        req = eng.submit(tok.encode("keep decoding"), max_new_tokens=40,
                         stop_ids={-1})
        busy = eng.perplexity(p, c)
        assert req.done.wait(300) and req.error is None
        assert req.tokens
        assert busy == idle
    finally:
        eng.close()


# ------------------------------------------------------------- the route

class _FakeEngine:
    """Just enough engine for both servers' /perplexity surface."""

    adapter_ids = {"": 0}

    def adapter_for(self, model):  # the port server's surface
        if model and model not in self.adapter_ids:
            raise KeyError(model)
        return model

    class tokenizer:
        @staticmethod
        def encode(text, add_special_tokens=False):
            return list(text.encode())

    def perplexity(self, prompt_ids, completion_ids, adapter=""):
        return jengine.nll_result(2.0 * len(completion_ids),
                                  len(completion_ids))


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, json.loads(data)


@pytest.mark.parametrize("body, code", [
    ({"prompt": "a", "completion": "bc"}, 200),
    ({"completion": "only"}, 200),
    ({"prompt": "a"}, 400),
    ({"prompt": "a", "completion": "b", "model": "nope"}, 400),
    ({"prompt": "a", "completion": "b", "model": ""}, 200),
])
def test_route_answers_like_the_jax_server(body, code):
    saved = (jserver.STATE.engine, tserver.STATE.engine, tserver.STATE.error)
    jserver.STATE.engine = _FakeEngine()
    tserver.STATE.engine, tserver.STATE.error = _FakeEngine(), None
    jsrv, tsrv = _serve(jserver.Handler), _serve(tserver.Handler)
    try:
        jc, jb = _post(jsrv.server_address[1], "/perplexity", body)
        tc, tb = _post(tsrv.server_address[1], "/perplexity", body)
        assert jc == tc == code
        assert tb == jb
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        (jserver.STATE.engine, tserver.STATE.engine,
         tserver.STATE.error) = saved


def test_route_matches_the_jax_server_on_the_export(export_dir, jax_engines):
    """Both servers over real engines serving the same export: the same
    keys, the same token count, ``mean_nll`` within 1e-2 relative."""
    saved = (jserver.STATE.engine, tserver.STATE.engine, tserver.STATE.error)
    jserver.STATE.engine = jax_engines[1]
    tserver.STATE.engine = BatchedEngine(export_dir, slots=2, device="cpu",
                                         kv_block_size=16, **KW)
    tserver.STATE.error = None
    jsrv, tsrv = _serve(jserver.Handler), _serve(tserver.Handler)
    try:
        body = {"prompt": "the quick brown fox", "completion": " jumps over"}
        jc, jb = _post(jsrv.server_address[1], "/perplexity", body)
        tc, tb = _post(tsrv.server_address[1], "/perplexity", body)
        assert jc == tc == 200
        assert set(tb) == set(jb)
        assert tb["num_tokens"] == jb["num_tokens"] > 0
        np.testing.assert_allclose(tb["mean_nll"], jb["mean_nll"],
                                   rtol=RTOL)
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        tserver.STATE.engine.close()
        (jserver.STATE.engine, tserver.STATE.engine,
         tserver.STATE.error) = saved


def test_route_answers_503_before_the_engine_loads():
    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    srv = _serve(tserver.Handler)
    try:
        code, body = _post(srv.server_address[1], "/perplexity",
                           {"prompt": "a", "completion": "b"})
        assert code == 503 and "error" in body
    finally:
        srv.shutdown()
        srv.server_close()
        tserver.STATE.engine, tserver.STATE.error = saved


@pytest.mark.parametrize("extra", [["--slots", "2"], ["--slots", "1"]],
                         ids=["batched", "single"])
def test_dataset_scoring_client_against_a_port_server(extra):
    """``query_perplexity`` (the reference's scoring client) against a
    port server on the CPU: the engine's own greedy continuation scores no
    worse than a mismatched completion of the same length
    (``tests/test_dataset_scoring.py::test_engine_perplexity_sanity``)."""
    import time

    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    args = tserver.parse_args(["--model_path", "preset:debug", "--template",
                               "vanilla", "--max_seq_len", "256",
                               "--device", "cpu", "--host", "127.0.0.1",
                               "--port", "0"] + extra)
    srv = tserver.start(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        deadline = time.time() + 120
        while tserver.STATE.engine is None:
            assert tserver.STATE.error is None, tserver.STATE.error
            assert time.time() < deadline
            time.sleep(0.05)
        eng = tserver.STATE.engine
        assert type(eng).__name__ == ("InferenceEngine" if extra[1] == "1"
                                      else "BatchedEngine")
        tok = eng.tokenizer
        greedy = eng.generate(tok.encode("the quick brown"),
                              max_new_tokens=6)
        assert greedy
        text = tok.decode(greedy)
        url = f"http://127.0.0.1:{srv.server_address[1]}/chat/completions"
        r1 = query_perplexity(url, "the quick brown", text)
        assert r1["num_tokens"] == len(tok.encode(text))
        assert 0 < r1["perplexity"] < float("inf")
        r2 = query_perplexity(url, "the quick brown", text[::-1])
        assert r1["mean_nll"] <= r2["mean_nll"] + 1e-6
        assert set(r1) == {"nll_sum", "num_tokens", "mean_nll", "perplexity"}
    finally:
        srv.shutdown()
        srv.server_close()
        if tserver.STATE.engine is not None:
            tserver.STATE.engine.close()
        tserver.STATE.engine, tserver.STATE.error = saved
