"""The port's observability plane (``datatunerx_tpu_torch/obs``, the
engine's spans and histograms, the server's ``/metrics``, ``/debug/trace``,
``/debug/slo`` and ``/debug/profile``) held against the JAX package on the
CPU.

- Exposition: the same counter, gauge and histogram operations (labels with
  quotes, backslashes and newlines; exemplars) give byte-equal
  ``Registry.expose()`` in both packages, and the helpers equal outputs.
- Server text: both servers' ``metrics_text()`` over one duck-typed engine
  are byte-equal once ``dtx_build_info`` and the uptime line are dropped,
  and the text parses (``tests/test_prometheus_exposition``) and lints
  clean (``scripts/metrics_lint.py``).
- Spans: ``build_request_span``, ``TraceStore`` eviction and its JSONL log,
  and ``Tracer`` nesting and orphan reaping give equal dicts (a shared fake
  clock).
- Engine: the port's ``BatchedEngine(device="cpu")`` and the JAX engine on
  one ``preset:debug`` export give the same span events (names and
  details, in order) for dense, chunked and COW admissions; tracing off is
  token-exact and observes the same histogram counts.
- Gateway: the reference gateway's ``HTTPReplica`` reads the spec and
  adapter families off a port server and merges its span into
  ``GET /debug/trace/<id>``.
- ``/debug/profile``: single-flight (409), confined (400), and its Chrome
  trace holds ``dtx_engine_decode`` ranges recorded on the engine's thread.

Every comparison is exact (bytes or dict equality); no tolerance applies.
"""

import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from datatunerx_tpu.obs import metrics as jm
from datatunerx_tpu.obs import trace as jt
from datatunerx_tpu.serving import server as jserver
from datatunerx_tpu_torch.obs import metrics as tm
from datatunerx_tpu_torch.obs import trace as tt
from datatunerx_tpu_torch.serving import server as tserver
from tests.test_prometheus_exposition import parse_exposition

MODEL = "preset:debug"


def _metrics_lint():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "metrics_lint.py")
    spec = importlib.util.spec_from_file_location("metrics_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A fake ``time``: ``time()``, ``perf_counter()`` and ``monotonic()``
    advance by fixed steps per call, so both packages see one sequence."""

    def __init__(self):
        self.t = 1_000.0

    def tick(self):
        self.t += 0.25
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()

    def install():
        c.t = 1_000.0
        for name in ("time", "perf_counter", "monotonic"):
            monkeypatch.setattr(time, name, c.tick)
    install()
    return install


# ------------------------------------------------------------- exposition
NASTY = ['plain', 'with"quote', "back\\slash", "new\nline", 'all"\\\n']


def _drive_registry(mod):
    reg = mod.Registry()
    c = reg.counter("t_requests_total", "Requests with \\ and \" in help.")
    for i, v in enumerate(NASTY):
        c.inc({"path": v, "code": str(200 + i)})
        c.inc({"path": v, "code": str(200 + i)}, by=2.5)
    g = reg.gauge("t_depth", "Queue depth.")
    g.set(3)
    g.set(0.125, {"q": 'a"b'})
    g.set(7, {"q": "c\nd"})
    reg.gauge("t_bare").set(1e-7)
    h = reg.histogram("t_latency_ms", "Latency.", buckets=jm.MS_BUCKETS)
    for i, v in enumerate((0.5, 3.0, 3.5, 80.0, 99999.0, 250.0, 1.0)):
        h.observe(v, trace_id=f'dtx-{i}"\\' if i % 2 else None)
    h2 = reg.histogram("t_tokens", buckets=(0, 1, 2, 4))
    for v in (0, 1, 1, 3, 9):
        h2.observe(v)
    mod.serving_latency_histograms(reg)[0].observe(12.5, trace_id="dtx-t")
    mod.adapter_load_histogram(reg).observe(40.0)
    mod.spec_accept_len_histogram(reg).observe(2)
    mod.set_build_info(reg, "serving")
    c.replace([({"path": "x"}, 4.0), (None, 1.0)])
    return reg


@pytest.mark.parametrize("exemplars", [True, False])
def test_registry_expose_is_byte_equal(clock, exemplars):
    clock()
    want = _drive_registry(jm).expose(with_exemplars=exemplars)
    clock()
    got = _drive_registry(tm).expose(with_exemplars=exemplars)
    assert got == want
    assert ("trace_id=" in got) == exemplars
    parse_exposition(_drive_registry(tm).expose(with_exemplars=False))


def test_exposition_helpers_equal():
    for v in NASTY:
        assert tm.escape_label_value(v) == jm.escape_label_value(v)
        for labels in (None, {}, {"b": v, "a": "1"}):
            assert (tm.format_sample("m", labels, 2)
                    == jm.format_sample("m", labels, 2))
    lines = ['m{l="a # b"} 1 # {trace_id="x"} 1 2', "m 1", 'm{l="\\""} 2',
             'm{l="x"} 3 # tail', "# HELP m x"]
    for ln in lines:
        assert tm.annotation_start(ln) == jm.annotation_start(ln)
    for path in ("/metrics", "/metrics?exemplars=1", "/metrics?exemplars=0",
                 "/metrics?no_exemplars=1", "/metrics?exemplars=1&x=2", ""):
        assert tm.exemplars_requested(path) == jm.exemplars_requested(path)
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0.0, 0.5, 0.95, 1.0):
        assert tm.sample_percentile(vals, q) == jm.sample_percentile(vals, q)
        assert tm.sample_percentile([], q) == jm.sample_percentile([], q)
    for mod in (tm, jm):
        h = mod.Histogram("x", buckets=(0.1, 0.5, 1.0, float("inf")))
        for v in (0.05,) * 90 + (0.4,) * 9 + (2.0,):
            h.observe(v)
        assert [h.percentile(q) for q in (0.5, 0.95, 1.0)] == [0.1, 0.5, 1.0]
    assert tm.LATENCY_BUCKETS == jm.LATENCY_BUCKETS
    assert tm.MS_BUCKETS == jm.MS_BUCKETS


# ------------------------------------------------------------ server text
class _Prefix:
    evictions = 2

    def __len__(self):
        return 5


class _HostTierRegistry:
    def host_tier_stats(self):
        return {"host_hits": 4, "orbax_loads": 2, "evictions": 1,
                "bytes": 123456, "entries": 3}


class _DuckEngine:
    """The attributes both servers' ``metrics_text`` read, all populated."""

    slots = 4
    total_kv_blocks = 64
    free_kv_blocks = 40
    kv_blocks_reserved = 24
    block_size = 16
    kv_overcommit_ratio = 1.25
    parked_sessions = 2
    _epilogue_impl = "kernel"

    def __init__(self):
        self._slot_req = [object(), None, object(), None]
        self.prefill_stats = {"full": 3, "reuse": 2, "extend": 1}
        self._prefix = _Prefix()
        self.preempt_stats = {"exported": 2, "resumed": 1,
                              "requeued_prefill": 1}
        self.sampling_stats = {"fused_steps": 7, "legacy_steps": 1}
        self.session_stats = {"export": {"ok": 2, "error": 1},
                              "import": {"ok": 1, "ok_prefill": 1}}
        self.adapter_registry = _HostTierRegistry()

    def adapter_occupancy(self):
        return {"slots": 4, "free": 1,
                "resident_adapters": ["a", 'q"uote'],
                "registered_adapters": ["a", 'q"uote', "c\\d"],
                "loads": 3, "evictions": 1, "hits": 9, "misses": 3,
                "requests": {"": 2, "a": 5, 'q"uote': 1}}

    def spec_info(self):
        return {"active": True, "k": 3, "accept_rate": 0.625,
                "adapter_accept_rate": {"": 0.5, "a": 0.75},
                "slot_accept_rate": {0: 0.5, 2: 0.75},
                "proposed": 40, "accepted": 25, "spec_steps": 10,
                "plain_steps": 2, "tree_steps": 4,
                "tree": {"widths": [2, 1], "depth": 2,
                         "slot_path_len": {0: 1.5}}}

    def tenant_usage(self):
        return {"t1": {"requests": 3, "tokens_in": 30, "tokens_out": 12,
                       "kv_blocks": 4, "adapters_resident": 1,
                       "tier": "pinned"},
                "": {"requests": 1, "tokens_in": 5, "tokens_out": 2}}


class _BareEngine:
    """Slots only: every optional family stays empty or zero."""

    slots = 2

    def __init__(self):
        self._slot_req = [None, None]


def _text(server, state, engine, exemplars):
    state.engine = engine
    # the engine's own observes, through the registry it shares
    ttft, tpot, chunk = server.serving_latency_histograms(state.registry)
    for i, v in enumerate((3.0, 45.0, 700.0)):
        ttft.observe(v, trace_id=f"dtx-{i}")
        tpot.observe(v / 10)
        chunk.observe(v / 3)
    if server is jserver:
        return jserver.metrics_text(with_exemplars=exemplars)
    return tserver.metrics_text(with_exemplars=exemplars, state=state)


def _drop_identity(text):
    return "\n".join(ln for ln in text.splitlines()
                     if "dtx_build_info" not in ln
                     and "dtx_serving_uptime_seconds" not in ln)


@pytest.mark.parametrize("exemplars", [False, True])
@pytest.mark.parametrize("engine", [_DuckEngine, _BareEngine, None],
                         ids=["full", "bare", "loading"])
def test_metrics_text_is_the_jax_servers(monkeypatch, clock, engine,
                                         exemplars):
    jstate = jserver.ServingState()
    monkeypatch.setattr(jserver, "STATE", jstate)
    tstate = tserver.ServingState()
    make = engine or (lambda: None)
    clock()
    want = _text(jserver, jstate, make(), exemplars)
    clock()
    got = _text(tserver, tstate, make(), exemplars)
    assert _drop_identity(got) == _drop_identity(want)
    assert got.count("dtx_build_info{") == 1
    if not exemplars:
        parse_exposition(got)
        assert _metrics_lint().lint_exposition(got, "serving") == []
    if engine is _DuckEngine:
        samples, _ = parse_exposition(_text(tserver, tstate, make(), False))
        assert samples[("dtx_serving_spec_enabled", ())] == 1
        assert samples[("dtx_serving_adapter_resident",
                        (("adapter", "a"),))] == 1
        assert samples[("dtx_serving_sampling_epilogue", ())] == 2


# ------------------------------------------------------------------ spans
TIMELINE = [(1000.5, "admit", {"slot": 0, "plen": 64, "mode": "chunked"}),
            (1000.75, "prefill", {"slot": 0, "tokens": 64}),
            (1001.0, "activate", {"slot": 0})]


@pytest.mark.parametrize("case", [
    dict(first=1001.25, last=1002.0, n=4),
    dict(first=1001.25, last=1001.25, n=1),
    dict(first=None, last=None, n=0, error="boom"),
    dict(first=1001.25, last=1003.0, n=8, timeline=[]),
])
def test_build_request_span_equal(case):
    kw = dict(attrs={"adapter": "a", "prompt_len": 9},
              error=case.get("error"))
    tl = case.get("timeline", TIMELINE)
    args = ("dtx-1", 1000.0, tl, case["first"], case["last"], case["n"],
            1.7e12 + 0.12345)
    assert (tt.build_request_span(*args, **kw)
            == jt.build_request_span(*args, **kw))


def _drive_store(mod, path):
    store = mod.TraceStore(capacity=3, jsonl_path=path, max_spans_per_trace=2)
    for i in range(6):
        for j in range(3):
            store.add({"trace_id": f"t{i % 4}", "name": f"s{j}", "i": i})
    store.add({"trace_id": "", "name": "dropped"})
    return ([store.get(t) for t in ("t0", "t1", "t2", "t3", "nope")],
            store.ids(), store.evictions, len(store))


def test_trace_store_eviction_and_log_equal(tmp_path):
    want = _drive_store(jt, str(tmp_path / "j.jsonl"))
    got = _drive_store(tt, str(tmp_path / "t.jsonl"))
    assert got == want
    assert ((tmp_path / "t.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())


def _drive_tracer(mod):
    store = mod.TraceStore(capacity=8)
    tracer = mod.Tracer(store, orphan_age_s=10.0)
    with tracer.span("gateway.request", trace_id="t-a", route="chat") as sp:
        sp.event("routed", replica="r0")
        with tracer.span("gateway.attempt", attempt=1) as inner:
            inner.set(status=200)
        try:
            with tracer.span("gateway.retry"):
                raise RuntimeError("replica died")
        except RuntimeError:
            pass
    orphan = tracer.start("engine.stream", trace_id="t-b", parent="x")
    orphan.event("tok")
    reaped_young = tracer.reap_orphans()
    reaped = tracer.reap_orphans(max_age_s=0.0)
    tracer.finish(orphan)  # already recorded as orphaned: not twice
    return (store.get("t-a"), store.get("t-b"), reaped_young, reaped,
            tracer.open_count(), tracer.current())


def test_tracer_nesting_and_reaping_equal(clock):
    clock()
    want = _drive_tracer(jt)
    clock()
    got = _drive_tracer(tt)
    assert got == want
    spans = got[0]["spans"]
    assert [s["name"] for s in spans] == ["gateway.attempt", "gateway.retry",
                                          "gateway.request"]
    assert spans[0]["parent"] == "gateway.request"
    assert spans[1]["status"] == "error"
    assert got[1]["spans"][0]["status"] == "orphaned"
    # an empty store is falsy but still the one the tracer records into
    store = tt.TraceStore()
    assert tt.Tracer(store).store is store


# ----------------------------------------------------------------- engine
ENGINE_BASE = dict(template="vanilla", max_seq_len=256, slots=2,
                   decode_chunk=4)
LAYOUTS = {
    "dense": dict(prefix_cache=4),
    "chunked": dict(kv_block_size=16),
    "cache": dict(kv_block_size=16, prefix_cache=4),
    "cow": dict(kv_block_size=16, kv_overcommit="on", prefix_cache=4),
}


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    import jax

    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer(MODEL)
    d = tmp_path_factory.mktemp("obs_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _spans(eng):
    """Each prompt in turn (so both schedulers admit alike): a cold prompt,
    an exact repeat and a strict extension; the spans' events without
    their offsets."""
    tok = eng.tokenizer
    p = tok.encode("a shared preamble for every request")
    out = []
    for i, ids in enumerate((p, p, p + tok.encode(" and a question"))):
        r = eng.submit(ids, max_new_tokens=6, trace_id=f"t{i}")
        assert r.done.wait(300) and r.error is None, r.error
        doc = eng.trace_store.get(f"t{i}")
        (span,) = doc["spans"]
        out.append([{k: v for k, v in e.items() if k != "t_ms"}
                    for e in span["events"]])
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_spans_match_the_jax_engine(export_dir, layout):
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    kw = dict(ENGINE_BASE, **LAYOUTS[layout])
    runs = []
    for make in (lambda: JEngine(export_dir, **kw),
                 lambda: BatchedEngine(export_dir, device="cpu", **kw)):
        eng = make()
        try:
            runs.append(_spans(eng))
        finally:
            eng.close()
    want, got = runs
    assert got == want
    modes = [e["mode"] for events in got for e in events
             if e["name"] == "admit"]
    # the dense layout marks its prefix-cache hits "dense" too (the
    # reference's events, which the port's equal)
    assert modes == {"dense": ["dense"] * 3,
                     "chunked": ["chunked"] * 3,
                     "cache": ["chunked", "cache", "cache"],
                     "cow": ["chunked", "cow", "cow_extend"]}[layout]
    for events in got:
        assert {"admit", "first_token", "finish"} <= {e["name"]
                                                      for e in events}


def _count(reg, name):
    return reg.get(name).count


def test_tracing_off_is_token_exact():
    """The same greedy and sampled prompts through a port engine with
    tracing on and one with it off: equal streams, equal histogram counts,
    exemplars and spans only while tracing."""
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    runs = []
    for tracing in (True, False):
        eng = BatchedEngine(MODEL, device="cpu", kv_block_size=16,
                            tracing=tracing, **ENGINE_BASE)
        try:
            tok = eng.tokenizer
            reqs = [eng.submit(tok.encode(p), max_new_tokens=8,
                               temperature=t, seed=3, trace_id=f"x{i}")
                    for i, (p, t) in enumerate((("hello there", 0.0),
                                                ("a longer prompt here", 0.0),
                                                ("sample me", 0.8)))]
            for r in reqs:
                assert r.done.wait(300) and r.error is None, r.error
            reg = eng.registry
            runs.append(dict(
                tokens=[r.tokens for r in reqs],
                counts=[_count(reg, n) for n in (
                    "dtx_serving_ttft_ms", "dtx_serving_tpot_ms",
                    "dtx_serving_prefill_chunk_ms")],
                exemplars=reg.get("dtx_serving_ttft_ms").exemplars(),
                traces=eng.trace_store.ids(),
                sched=[e for e in eng.sched_trace]))
        finally:
            eng.close()
    on, off = runs
    assert on["tokens"] == off["tokens"]
    assert on["counts"] == off["counts"] and on["counts"][0] == 3
    assert on["sched"] == off["sched"]
    assert sorted(on["traces"]) == ["x0", "x1", "x2"] and off["traces"] == []
    assert on["exemplars"] and off["exemplars"] == {}


# ---------------------------------------------------------------- gateway
def _post(url, path, body, headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(extra, state=None):
    state = state or tserver.ServingState()
    args = tserver.parse_args([
        "--model_path", MODEL, "--template", "vanilla", "--max_seq_len",
        "256", "--slots", "2", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--slo_sample_s", "0", *extra])
    srv = tserver.start(args, state=state)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    deadline = time.monotonic() + 300
    while state.engine is None and state.error is None:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert state.error is None, state.error
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", state


def test_gateway_scrapes_and_merges_a_port_replica(tmp_path):
    """The reference gateway fronts a port server (a take:1 draft, a pool
    of two adapters) through ``HTTPReplica``: the scrape fills the spec and
    adapter signals, and ``GET /debug/trace/<id>`` merges the replica's
    span with the gateway's own."""
    from datatunerx_tpu.gateway.replica_pool import HTTPReplica, ReplicaPool
    from datatunerx_tpu.gateway.server import Gateway, serve
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep

    paths = make_adapter_sweep(str(tmp_path / "ad"), MODEL, 2)
    srv, url, state = _serve(["--kv_block_size", "16", "--spec_draft_config",
                              "take:1", "--spec_mode", "on", "--spec_k", "2",
                              "--adapter_pool", "2"])
    gw = Gateway(ReplicaPool([HTTPReplica("port", url)]),
                 model_name="preset:test")
    gsrv = serve(gw, port=0, host="127.0.0.1")
    threading.Thread(target=gsrv.serve_forever, daemon=True).start()
    gurl = f"http://127.0.0.1:{gsrv.server_port}"
    try:
        names = sorted(paths)
        assert _post(url, "/admin/adapters",
                     {"name": names[0], "checkpoint": paths[names[0]]})[0] \
            == 200
        assert _post(url, "/admin/adapters",
                     {"name": names[1], "checkpoint": paths[names[1]],
                      "load": False})[0] == 200
        code, _ = _post(gurl, "/chat/completions", {
            "messages": [{"role": "user", "content": "hi there"}],
            "max_tokens": 8}, {"X-DTX-Trace-Id": "t-gw"})
        assert code == 200
        st = HTTPReplica("probe", url).stats()
        assert st["spec_enabled"] is True
        assert st["spec_accept_rate"] is not None
        assert st["resident_adapters"] == {names[0]}
        assert st["adapters"] == set(names)
        code, body = _get(gurl, "/debug/trace/t-gw")
        assert code == 200
        spans = {s["name"]: s for s in json.loads(body)["spans"]}
        assert {"gateway.request", "engine.request"} <= set(spans)
        assert spans["engine.request"]["attrs"]["n_tokens"] >= 1
        assert _get(url, "/debug/trace/nope")[0] == 404
        samples, _ = parse_exposition(_get(url, "/metrics")[1])
        spec = state.engine.spec_info()
        assert samples[("dtx_serving_spec_accept_len_count", ())] \
            == spec["row_steps"]
    finally:
        gsrv.shutdown()
        gw.close()
        srv.shutdown()
        srv.server_close()
        state.engine.close()


def test_server_flags_take_effect(tmp_path):
    """``--trace_ring`` bounds the ring, ``--trace_log`` appends one JSON
    line a span, ``--slo_config`` (inline JSON) is what ``/debug/slo``
    judges, and ``/metrics?exemplars=1`` names the trace ids the plain wire
    leaves out."""
    log = tmp_path / "spans.jsonl"
    slo = json.dumps([{"name": "ttft", "objective": 0.9, "sli": {
        "kind": "latency", "metric": "dtx_serving_ttft_ms",
        "threshold_ms": 60000}}])
    srv, url, state = _serve(["--kv_block_size", "16", "--trace_ring", "2",
                              "--trace_log", str(log), "--slo_config", slo])
    try:
        for i in range(3):
            code, _ = _post(url, "/chat/completions", {
                "messages": [{"role": "user", "content": f"hi {i}"}],
                "max_tokens": 4}, {"X-DTX-Trace-Id": f"f{i}"})
            assert code == 200
        assert state.engine.trace_store.ids() == ["f1", "f2"]
        assert _get(url, "/debug/trace/f0")[0] == 404
        lines = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert [ln["trace_id"] for ln in lines] == ["f0", "f1", "f2"]
        code, body = _get(url, "/debug/slo")
        rep = json.loads(body)
        assert code == 200 and [s["name"] for s in rep["slos"]] == ["ttft"]
        assert rep["slos"][0]["windows"][0]["total"] == 3
        plain = _get(url, "/metrics")[1]
        rich = _get(url, "/metrics?exemplars=1")[1]
        assert "trace_id=" not in plain and 'trace_id="f2"' in rich
        samples, _ = parse_exposition(plain)
        assert samples[("dtx_serving_ttft_ms_count", ())] == 3
        assert samples[("dtx_slo_objective", (("slo", "ttft"),))] == 0.9
    finally:
        srv.shutdown()
        srv.server_close()
        state.engine.close()


# ---------------------------------------------------------------- profile
def test_debug_profile_is_single_flight_confined_and_sees_the_engine(
        tmp_path, monkeypatch):
    from datatunerx_tpu_torch.obs.profiling import process_profiler

    monkeypatch.setenv("DTX_PROFILE_DIR", str(tmp_path))
    srv, url, state = _serve(["--kv_block_size", "16"])
    try:
        assert _post(url, "/debug/profile", {"seconds": "x"})[0] == 400
        assert _post(url, "/debug/profile",
                     {"seconds": 1, "dir": "../escape"})[0] == 400
        code, body = _post(url, "/debug/profile",
                           {"seconds": 2.5, "dir": "cap"})
        assert code == 202 and body["seconds"] == 2.5
        assert body["profiling"] == str(tmp_path / "cap")
        assert _post(url, "/debug/profile", {"seconds": 1})[0] == 409
        code, _ = _post(url, "/chat/completions", {
            "messages": [{"role": "user", "content": "profile me"}],
            "max_tokens": 6})
        assert code == 200
        done = process_profiler().wait(60)
        assert done.get("error") is None, done
        with open(done["trace"]) as f:
            events = json.load(f)["traceEvents"]
        engine_tid = state.engine._thread.native_id
        ranges = [e for e in events if e.get("name") == "dtx_engine_decode"]
        assert ranges and all(e["tid"] == engine_tid for e in ranges)
        assert any(e.get("name") == "dtx_engine_prefill_chunk"
                   for e in events)
        assert process_profiler().status() is None
    finally:
        srv.shutdown()
        srv.server_close()
        state.engine.close()
