"""The port's HTTP server on the CPU: ``/healthz`` gating, JSON and SSE
``/chat/completions`` against a real (debug-size) port engine, response keys
equal to the JAX server's, and the flags outside the slice refused. The
session and fleet admin routes answer with the JAX server's codes and body
keys over the same stand-in engines, move real sessions and prefix entries
between two port servers in one process, and serve the reference
gateway's ``HTTPReplica``."""

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

    def adapter_for(self, model):  # the port server's surface
        if model and model not in self.adapter_ids:
            raise KeyError(model)
        return model
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


# every flag of the JAX server is ported now: --trace_log and --slo_config,
# once refused, parse as the JAX server parses them, a role or not (what
# they do is held in tests/test_torch_obs.py)
@pytest.mark.parametrize("extra", [
    ["--trace_log", "x", "--role", "prefill"],
    ["--trace_log", "x"], ["--slo_config", "x"],
    ["--slo_config", "x", "--role", "decode"],
])
def test_flags_outside_the_slice_are_refused(extra, capsys):
    args = tserver.parse_args(ARGS + extra)
    for flag, value in zip(extra[::2], extra[1::2]):
        assert getattr(args, flag[2:]) == value
    assert capsys.readouterr().err == ""


def _serve_one(extra, check):
    """Start the server with ARGS + extra, wait for the engine, answer one
    chat, hand the engine to ``check`` and shut everything down."""
    saved = (tserver.STATE.engine, tserver.STATE.error)
    tserver.STATE.engine, tserver.STATE.error = None, None
    srv = tserver.start(tserver.parse_args(ARGS + extra))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        _wait_healthy(port)
        code, body = _request(port, "POST", "/chat/completions", CHAT)
        assert code == 200, body
        assert isinstance(
            json.loads(body)["choices"][0]["message"]["content"], str)
        check(tserver.STATE.engine)
    finally:
        srv.shutdown()
        srv.server_close()
        if tserver.STATE.engine is not None:
            tserver.STATE.engine.close()
        tserver.STATE.engine, tserver.STATE.error = saved


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_server_accepts_kv_quant_int8(layout):
    import torch

    def check(eng):
        assert eng.kv_quant == "int8"
        assert eng._cache["k"].dtype == torch.int8
        assert eng._cache["k_scale"].dtype == torch.float32
        assert eng.decode_path == ("gather" if layout == "paged" else "dense")

    block = ["--kv_block_size", "0"] if layout == "dense" else []
    _serve_one(block + ["--kv_quant", "int8"], check)


def test_server_default_block_size_is_the_dense_cache():
    """``--kv_block_size`` defaults to 0 in both servers, and the port's
    answers it with the dense engine."""
    args = tserver.parse_args(["--model_path", "preset:debug"])
    assert args.kv_block_size == 0 and args.kv_quant == ""
    import inspect

    assert inspect.signature(jserver.load_engine_async).parameters[
        "kv_block_size"].default == 0

    def check(eng):
        assert eng.decode_path == "dense"
        assert eng.total_kv_blocks is None and eng.free_kv_blocks is None
        assert "block_tables" not in eng._cache
        assert any(e[0] == "admit" and e[3] == "dense"
                   for e in eng.sched_trace)

    _serve_one(["--kv_block_size", "0"], check)


def test_paged_kernel_on_needs_the_paged_cache(capsys):
    with pytest.raises(SystemExit) as exc:
        tserver.parse_args(ARGS + ["--kv_block_size", "0",
                                   "--paged_kernel", "on"])
    assert exc.value.code == 2
    assert "requires the paged KV cache" in capsys.readouterr().err


def test_defaults_run_on_cuda():
    args = tserver.parse_args(["--model_path", "preset:tinyllama-1.1b",
                               "--kv_block_size", "16"])
    assert args.device == "cuda"
    assert (args.slots, args.max_seq_len, args.decode_chunk,
            args.prefill_chunk) == (4, 1024, 8, 256)
    assert args.paged_kernel == args.sampling_epilogue == "auto"


# ------------------------------------------- session and fleet admin routes
ADMIN_ROUTES = {
    "/admin/sessions/export": ("export_sessions", {"prefill": True}),
    "/admin/sessions/import": ("import_session", {"stream": False}),
    "/admin/sessions/hold": ("hold_parked", {"max_sessions": 2}),
    "/admin/sessions/drop": ("drop_parked", {"trace_ids": ["t"]}),
    "/admin/sessions/release": ("release_parked", {"trace_ids": ["t"]}),
    "/admin/prefix/export": ("export_prefix_entries", {"exclude": ["f"]}),
    "/admin/prefix/import": ("import_prefix_entry", {"kind": "x"}),
}


class _FakeMigEngine:
    """The session/fleet surface of an engine, answering canned documents
    or failing as ``mode`` says: "ok", "refuse" (ValueError), "timeout"
    or "fault"."""

    class tokenizer:
        @staticmethod
        def decode(ids, skip_special_tokens=True):
            return "".join(chr(97 + i % 26) for i in ids)

    def __init__(self, mode):
        self.mode = mode
        self.calls = []

    def _answer(self, name, doc):
        self.calls.append(name)
        if self.mode == "refuse":
            raise ValueError(f"{name} refused")
        if self.mode == "timeout":
            raise TimeoutError(f"{name} timed out")
        if self.mode == "fault":
            raise RuntimeError(f"{name} failed")
        return doc

    def export_sessions(self, slots=None, wire_quant=None,
                        include_prefill=False):
        return self._answer("export_sessions",
                            {"sessions": [], "skipped": []})

    def import_session(self, payload):
        import threading as th

        class Req:
            tokens = [1, 2, 3]
            error = None
            done = th.Event()
        Req.done.set()
        return self._answer("import_session", {
            "session": "t", "slot": 0, "tokens": 1, "cursor": 5,
            "remaining": 2, "adapter": "", "text_so_far": "b",
            "_request": Req})

    def resume_stream(self, req):
        yield "c"
        yield "d"

    def hold_parked(self, max_sessions=4, hold_s=10.0):
        return self._answer("hold_parked", {"sessions": [], "parked": 0})

    def drop_parked(self, trace_ids):
        return self._answer("drop_parked", {"dropped": len(trace_ids)})

    def release_parked(self, trace_ids):
        return self._answer("release_parked", {"released": 0})

    def export_prefix_entries(self, exclude=None, max_entries=4,
                              wire_quant=None):
        return self._answer("export_prefix_entries", {"entries": []})

    def import_prefix_entry(self, payload):
        return self._answer("import_prefix_entry", {"imported": True})


@pytest.mark.parametrize("mode", ["ok", "refuse", "timeout", "fault",
                                  "surfaceless", "unloaded"])
def test_admin_routes_answer_as_the_jax_server(mode):
    """Each of the seven routes over the same stand-in engine in both
    servers: the same status code and the same body keys (200, 409 on a
    refusal, 503 on a timeout or with no model, 500 on a fault, 501 for an
    engine without the surface); the SSE import's events too."""
    engines = {"ok": lambda: _FakeMigEngine("ok"),
               "refuse": lambda: _FakeMigEngine("refuse"),
               "timeout": lambda: _FakeMigEngine("timeout"),
               "fault": lambda: _FakeMigEngine("fault"),
               "surfaceless": _FakeEngine, "unloaded": lambda: None}
    want_code = {"ok": 200, "refuse": 409, "timeout": 503, "fault": 500,
                 "surfaceless": 501, "unloaded": 503}[mode]
    saved = (jserver.STATE.engine, tserver.STATE.engine)
    jserver.STATE.engine = engines[mode]()
    tserver.STATE.engine = engines[mode]()
    jsrv, tsrv = _serve(jserver.Handler), _serve(tserver.Handler)
    try:
        jport, tport = jsrv.server_address[1], tsrv.server_address[1]
        for path, (_, body) in ADMIN_ROUTES.items():
            jc, jb = _request(jport, "POST", path, dict(body))
            tc, tb = _request(tport, "POST", path, dict(body))
            want = want_code
            if mode == "refuse" and path == "/admin/sessions/export":
                want = 500  # the export route has no refusal code
            assert (jc, tc) == (want, want), (path, jc, tc, jb, tb)
            assert _keys(json.loads(jb)) == _keys(json.loads(tb)), path
        if mode == "ok":
            jc, jb = _request(jport, "POST", "/admin/sessions/import", {})
            tc, tb = _request(tport, "POST", "/admin/sessions/import", {})
            assert jc == tc == 200
            je, te = _sse_events(jb), _sse_events(tb)
            assert je == te
            assert [list(e) for e in te] == [["imported"], ["delta"],
                                            ["delta"]]
            assert _request(tport, "POST", "/admin/sessions/hold",
                            None)[0] == 200  # an empty body is {}
            assert _request(tport, "POST", "/admin/sessions/hold",
                            {"max_sessions": "many"})[0] == 400
            assert _request(tport, "POST", "/admin/prefix/export",
                            [1, 2])[0] == 400
    finally:
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        jserver.STATE.engine, tserver.STATE.engine = saved


def test_admin_routes_on_the_single_request_engine_answer_501():
    """``--slots 1`` serves the single-request engine, which has no
    session surface: every admin route answers 501."""
    from datatunerx_tpu_torch.serving.engine import InferenceEngine

    state = tserver.ServingState()
    state.engine = InferenceEngine(MODEL_DEBUG, template="vanilla",
                                   max_seq_len=256, device="cpu")
    handler = type("H", (tserver.Handler,), {"state": state})
    srv = _serve(handler)
    try:
        for path, (_, body) in ADMIN_ROUTES.items():
            code, out = _request(srv.server_address[1], "POST", path, body)
            assert code == 501, (path, code, out)
    finally:
        srv.shutdown()
        srv.server_close()


MODEL_DEBUG = "preset:debug"


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_role_is_accepted_and_kept(role):
    args = tserver.parse_args(ARGS + ["--role", role])
    assert args.role == role
    state = tserver.ServingState()
    srv = tserver.start(args, state=state)
    try:
        assert state.role == role and tserver.STATE.role == "mixed"
        assert srv.RequestHandlerClass.state is state
    finally:
        srv.server_close()
        deadline = __import__("time").time() + 120
        while state.engine is None and state.error is None \
                and __import__("time").time() < deadline:
            __import__("time").sleep(0.05)
        if state.engine is not None:
            state.engine.close()


def _start_port_server(extra=()):
    """A port server on its own ServingState (two can share a process);
    returns (srv, port, state) once healthy."""
    state = tserver.ServingState()
    srv = tserver.start(tserver.parse_args(ARGS + list(extra)), state=state)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _wait_healthy(srv.server_address[1])
    return srv, srv.server_address[1], state


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_metrics_fleet_gauges_match_the_jax_server(role):
    """``GET /metrics``: each fleet gauge's sample is the JAX server's line
    for the same engine and role, and the reference gateway's
    ``HTTPReplica`` reads the role, the slots, the free blocks and the
    parked sessions from it."""
    from datatunerx_tpu.gateway.replica_pool import HTTPReplica

    srv, port, state = _start_port_server(["--role", role])
    saved = (jserver.STATE.engine, jserver.STATE.role)
    try:
        eng = state.engine
        code, body = _request(port, "GET", "/metrics")
        assert code == 200
        # the fleet gauges among the whole exposition (its other families
        # are held against the JAX server in tests/test_torch_obs.py)
        fleet = ("dtx_serving_slots_busy", "dtx_serving_slots_capacity",
                 "dtx_serving_kv_blocks_free", "dtx_serving_kv_blocks_capacity",
                 "dtx_serving_kv_block_size", "dtx_serving_sessions_parked",
                 "dtx_serving_role")
        samples = [ln for ln in body.splitlines()
                   if ln.split("{")[0].split(" ")[0] in fleet]
        assert len(samples) == 7, samples
        assert f'dtx_serving_role{{role="{role}"}} 1' in samples
        jserver.STATE.engine, jserver.STATE.role = eng, role
        jlines = set(jserver.metrics_text(with_exemplars=False).splitlines())
        assert [ln for ln in samples if ln not in jlines] == []
        st = HTTPReplica("port", f"http://127.0.0.1:{port}").stats()
        assert st["role"] == role
        assert (st["slots_busy"], st["slots_total"]) == (0, eng.slots)
        assert st["kv_blocks_free"] == eng.free_kv_blocks > 0
        assert st["kv_blocks_total"] == eng.total_kv_blocks
        assert (st["kv_block_size"], st["sessions_parked"]) == (16, 0)
    finally:
        jserver.STATE.engine, jserver.STATE.role = saved
        srv.shutdown()
        srv.server_close()
        state.engine.close()


def test_sessions_and_prefixes_move_between_two_port_servers():
    """Two port servers in one process: a live session exported over HTTP
    from the source and imported over HTTP into the destination (SSE
    receipt and deltas, and ``"stream": false``), continues the undisturbed
    text; a prefix entry moves and admits with no prefill chunk; refusals
    answer 409."""
    import time

    from tests.test_torch_migration import throttled

    src_srv, sport, sst = _start_port_server(["--prefix_cache", "4",
                                              "--role", "prefill"])
    dst_srv, dport, dst = _start_port_server(["--prefix_cache", "4"])
    try:
        src, eng = sst.engine, dst.engine
        assert sst.role == "prefill" and dst.role == "mixed"
        prompt = src.tokenizer.encode("over the wire we go")
        want = src.generate(prompt, max_new_tokens=20)
        want_text = src.tokenizer.decode(want, skip_special_tokens=True)
        for stream in (True, False):
            restore = throttled(src)
            try:
                req = src.submit(prompt, max_new_tokens=20)
                while len(req.tokens) < 3:
                    time.sleep(0.005)
                code, body = _request(sport, "POST",
                                      "/admin/sessions/export", {})
            finally:
                restore()
            assert code == 200, body
            doc = json.loads(body)
            assert len(doc["sessions"]) == 1 and doc["skipped"] == []
            assert req.done.wait(30) and "session migrated" in req.error
            payload = dict(doc["sessions"][0], stream=stream)
            code, body = _request(dport, "POST", "/admin/sessions/import",
                                  payload)
            assert code == 200, body
            if stream:
                events = _sse_events(body)
                meta = events[0]["imported"]
                text = meta["text_so_far"] + "".join(
                    e["delta"] for e in events[1:])
            else:
                meta = json.loads(body)["imported"]
                assert meta["error"] is None
                text = meta["text"]
            assert meta["session"] == payload["trace_id"]
            assert text == want_text, (stream, text, want_text)
        # a refusal: a payload of another model
        bad = dict(doc["sessions"][0])
        bad["model_sig"] = dict(bad["model_sig"], layers=999)
        code, body = _request(dport, "POST", "/admin/sessions/import", bad)
        assert code == 409 and "incompatible model" in body
        # the prefix tier's engine half over HTTP
        shared = src.tokenizer.encode("shared system preamble " * 10)
        r = src.submit(shared, max_new_tokens=4)
        assert r.done.wait(120) and r.error is None
        code, body = _request(sport, "POST", "/admin/prefix/export",
                              {"max_entries": 8})
        entries = json.loads(body)["entries"]
        assert code == 200 and entries
        fps = [e["fingerprint"] for e in entries]
        code, body = _request(sport, "POST", "/admin/prefix/export",
                              {"exclude": fps})
        assert json.loads(body) == {"entries": []}
        for e in entries:
            code, body = _request(dport, "POST", "/admin/prefix/import", e)
            assert code == 200 and json.loads(body)["imported"], body
        mark = len(eng.sched_trace)
        r2 = eng.submit(shared, max_new_tokens=4)
        assert r2.done.wait(120) and r2.tokens == r.tokens
        assert not any(e[0] == "prefill"
                       for e in list(eng.sched_trace)[mark:])
        code, body = _request(dport, "POST", "/admin/prefix/import",
                              dict(entries[0], kind="dtx-kv-session"))
        assert code == 409
        # the spill routes on an engine with nothing parked
        assert json.loads(_request(sport, "POST", "/admin/sessions/hold",
                                   {"max_sessions": 2})[1]) == {
            "sessions": [], "parked": 0}
        assert json.loads(_request(sport, "POST", "/admin/sessions/drop",
                                   {"trace_ids": ["x"]})[1]) == {
            "dropped": 0}
        assert json.loads(_request(sport, "POST", "/admin/sessions/release",
                                   {"trace_ids": ["x"]})[1]) == {
            "released": 0}
        assert _request(sport, "POST", "/admin/sessions/export",
                        {"slots": [0]})[0] == 200
        assert src.free_kv_blocks + sum(
            len(e.get("blocks") or []) for e in src._prefix._d.values()
        ) == src.total_kv_blocks
    finally:
        for srv, st in ((src_srv, sst), (dst_srv, dst)):
            srv.shutdown()
            srv.server_close()
            if st.engine is not None:
                st.engine.close()


def test_http_replica_drives_a_port_server():
    """The reference gateway's ``HTTPReplica`` against a port server:
    ``import_session`` streams the continuation, ``export_sessions`` brings
    a live session back out, and the spill and prefix calls answer."""
    import time

    from datatunerx_tpu.gateway.replica_pool import HTTPReplica
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
    from tests.test_torch_migration import (
        PAGED,
        export_mid_decode,
        import_and_wait,
        throttled,
    )

    srv, port, state = _start_port_server(["--prefix_cache", "4"])
    other = BatchedEngine(MODEL_DEBUG, **PAGED)
    try:
        eng = state.engine
        replica = HTTPReplica("r-http", f"http://127.0.0.1:{port}")
        prompt = other.tokenizer.encode("over the wire we go")
        want_text = other.tokenizer.decode(
            other.generate(prompt, max_new_tokens=20),
            skip_special_tokens=True)
        payload = export_mid_decode(other, prompt, max_new_tokens=20)
        meta, stream = replica.import_session(payload)
        assert meta["session"] == payload["trace_id"]
        assert str(meta.get("text_so_far") or "") + "".join(
            stream) == want_text
        restore = throttled(eng)
        try:
            req = eng.submit(prompt, max_new_tokens=20)
            while len(req.tokens) < 3:
                time.sleep(0.005)
            doc = replica.export_sessions()
        finally:
            restore()
        assert doc is not None and len(doc["sessions"]) == 1
        handle, _ = import_and_wait(other, doc["sessions"][0])
        assert other.tokenizer.decode(
            handle.tokens, skip_special_tokens=True) == want_text
        assert replica.hold_parked() == {"sessions": [], "parked": 0}
        assert replica.drop_parked(["x"]) == {"dropped": 0}
        assert replica.release_parked(["x"]) == {"released": 0}
        entries = replica.export_prefix_entries()["entries"]
        assert entries and all(e["kind"] == "dtx-kv-prefix"
                               for e in entries)
        assert replica.import_prefix_entry(entries[0]) == {
            "imported": False, "reason": "present"}
    finally:
        srv.shutdown()
        srv.server_close()
        if state.engine is not None:
            state.engine.close()
        other.close()
