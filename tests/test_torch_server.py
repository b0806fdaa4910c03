"""The port's HTTP server on the CPU: ``/healthz`` gating, JSON and SSE
``/chat/completions`` against a real (debug-size) port engine, response keys
equal to the JAX server's, and the flags outside the slice refused."""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import pytest

from datatunerx_tpu.serving import server as jserver
from datatunerx_tpu_torch.serving import server as tserver

ARGS = ["--model_path", "preset:debug", "--template", "vanilla",
        "--max_seq_len", "256", "--slots", "2", "--kv_block_size", "16",
        "--device", "cpu", "--host", "127.0.0.1", "--port", "0"]


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


def _sse_events(data):
    out = []
    for line in data.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            out.append(json.loads(line[len("data: "):]))
    assert data.rstrip().endswith("data: [DONE]")
    return out


def _keys(obj):
    """Nested key structure of a JSON value (values dropped)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return None


CHAT = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6}


@pytest.fixture(scope="module")
def port_server():
    tserver.STATE.engine, tserver.STATE.error = None, None
    args = tserver.parse_args(ARGS)
    srv = tserver.start(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    if tserver.STATE.engine is not None:
        tserver.STATE.engine.close()
    tserver.STATE.engine = None


def _wait_healthy(port):
    import time

    deadline = time.time() + 120
    while time.time() < deadline:
        code, _ = _request(port, "GET", "/healthz")
        if code == 200:
            return
        assert code == 503
        time.sleep(0.05)
    raise AssertionError("engine never became healthy")


def test_healthz_gates_on_load_and_reports_failure():
    saved = (tserver.STATE.engine, tserver.STATE.error)
    srv = _serve(tserver.Handler)
    port = srv.server_address[1]
    try:
        tserver.STATE.engine, tserver.STATE.error = None, None
        assert _request(port, "GET", "/healthz")[0] == 503
        assert _request(port, "POST", "/chat/completions", CHAT)[0] == 503
        tserver.STATE.error = "boom"
        code, body = _request(port, "GET", "/healthz")
        assert code == 500 and json.loads(body)["error"] == "boom"
    finally:
        srv.shutdown()
        srv.server_close()
        tserver.STATE.engine, tserver.STATE.error = saved


def test_json_and_sse_chat(port_server):
    _wait_healthy(port_server)
    eng = tserver.STATE.engine
    assert eng.device.type == "cpu" and eng.decode_path == "gather"
    for path in ("/chat/completions", "/v1/chat/completions"):
        code, body = _request(port_server, "POST", path, CHAT)
        assert code == 200, body
        out = json.loads(body)
        assert out["object"] == "chat.completion"
        assert isinstance(out["choices"][0]["message"]["content"], str)
        assert out["usage"]["prompt_tokens"] > 0
    code, body = _request(port_server, "POST", "/chat/completions",
                          dict(CHAT, stream=True))
    assert code == 200
    events = _sse_events(body)
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    assert "usage" in events[-1]
    assert _request(port_server, "POST", "/chat/completions",
                    {"messages": []})[0] == 400
    assert _request(port_server, "GET", "/v1/models")[0] == 200
    assert eng.free_kv_blocks == eng.total_kv_blocks


class _FakeEngine:
    """Just enough engine for the JAX server's chat surface."""

    adapter_ids = {"": 0}
    trace_store = None
    tenants = None

    class tokenizer:
        @staticmethod
        def encode(text, add_special_tokens=False):
            return list(text.encode())

    def _encode_chat(self, messages):
        return [1, 2, 3], {2}

    def chat(self, messages, **kw):
        return "ok"

    def chat_stream(self, messages, **kw):
        yield "o"
        yield "k"


def test_response_keys_equal_the_jax_servers():
    """Both servers over the same stand-in engine (the surface alone):
    every response shape has the same nested keys."""
    saved = (jserver.STATE.engine, tserver.STATE.engine, tserver.STATE.error)
    jserver.STATE.engine = _FakeEngine()
    tserver.STATE.engine, tserver.STATE.error = _FakeEngine(), None
    jsrv, tsrv = _serve(jserver.Handler), _serve(tserver.Handler)
    try:
        jport, tport = jsrv.server_address[1], tsrv.server_address[1]
        for stream in (False, True):
            body = dict(CHAT, stream=stream)
            jc, jb = _request(jport, "POST", "/chat/completions", body)
            tc, tb = _request(tport, "POST", "/chat/completions", body)
            assert jc == tc == 200
            if stream:
                je, te = _sse_events(jb), _sse_events(tb)
                assert [_keys(e) for e in je] == [_keys(e) for e in te]
            else:
                assert _keys(json.loads(jb)) == _keys(json.loads(tb))
        for path in ("/healthz", "/v1/models"):
            jb = _request(jport, "GET", path)[1]
            tb = _request(tport, "GET", path)[1]
            assert _keys(json.loads(jb)) == _keys(json.loads(tb))
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        (jserver.STATE.engine, tserver.STATE.engine,
         tserver.STATE.error) = saved


@pytest.mark.parametrize("extra", [
    ["--adapters", "a=/x"], ["--prefix_cache", "4"], ["--kv_quant", "int8"],
    ["--kv_overcommit", "on"], ["--spec_draft_config", "take:1"],
    ["--quantization", "int8"], ["--tenants_config", "{}"],
    ["--checkpoint_path", "/x"], ["--slots", "1"], ["--kv_block_size", "0"],
])
def test_flags_outside_the_slice_are_refused(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        tserver.parse_args(ARGS + extra)
    assert exc.value.code == 2
    assert "ROADMAP Queue 1" in capsys.readouterr().err


def test_defaults_run_on_cuda():
    args = tserver.parse_args(["--model_path", "preset:tinyllama-1.1b",
                               "--kv_block_size", "16"])
    assert args.device == "cuda"
    assert (args.slots, args.max_seq_len, args.decode_chunk,
            args.prefill_chunk) == (4, 1024, 8, 256)
    assert args.paged_kernel == args.sampling_epilogue == "auto"
