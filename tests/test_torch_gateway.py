"""The port's gateway (``datatunerx_tpu_torch/gateway``) held to the JAX
package's (``datatunerx_tpu/gateway``) on the CPU.

- Same decisions: the reference tests' routing, breaker, failover,
  admission, autoscale, tenancy, HTTP and promotion scenarios run on both
  packages over the reference tests' ``FakeEngine``; every routing choice,
  shed reason, hint, breaker state and status code is equal, and so are the
  gateway ``/metrics`` bytes after the same scenario (a ticking clock in
  place of the host's; ``dtx_build_info`` and the uptime line dropped),
  with and without a tenant directory.
- Same streams: the port gateway over port ``BatchedEngine``s and the
  reference gateway over JAX engines, on one ``export_merged_model`` export
  of ``preset:debug`` (final norm x 64, ``tests/test_torch_migration.py``),
  give the same greedy chats, text and token ids.
- Drain splice: a mid-stream ``drain`` moves the session; the spliced
  stream is the reference gateway's on the same scenario, its token ids are
  the undisturbed run's (no duplicate, none missing), and the text follows
  the streams' shared U+FFFD hold-back (ROADMAP Queue 3), pinned here.
- The fleet plane (prefix tier, prefill→decode handoff) through the port
  gateway over port engines.
- Spawn mode: the port's ``LocalServingBackend`` deploys a port gateway
  over two port servers on the CPU, scales it 2 → 1, and ``delete`` leaves
  no server process behind.
"""

import importlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from tests.test_gateway import MSGS, FakeEngine
from tests.test_torch_migration import (  # noqa: F401 — fixture
    held,
    peaked_export,
    wait_until,
)

PACKAGES = {"ref": "datatunerx_tpu", "port": "datatunerx_tpu_torch"}
MODULES = {
    "gateway.admission": ("AdmissionController", "Overloaded",
                          "estimate_prompt_tokens"),
    "gateway.autoscale": ("autoscale_hint", "parse_hint"),
    "gateway.replica_pool": ("CircuitBreaker", "InProcessReplica",
                             "NoReplicaAvailable", "ReplicaPool"),
    "gateway.router": ("session_key",),
    "gateway.server": ("Gateway", "serve", "make_handler"),
    "experiment.metrics": ("ExperimentMetrics",),
}


def gw_pkg(which):
    root = PACKAGES[which]
    ns = SimpleNamespace(root=root)
    for mod, names in MODULES.items():
        m = importlib.import_module(f"{root}.{mod}")
        for n in names:
            obj = getattr(m, n)
            assert getattr(obj, "__module__", root).startswith(root + "."), n
            setattr(ns, n, obj)
    return ns


def make_gateway(g, engines, policy="least_busy", **kw):
    pool = g.ReplicaPool([g.InProcessReplica(e.name, e) for e in engines])
    return g.Gateway(pool, policy=policy, **kw)


def q(i):
    return {"messages": [{"role": "user", "content": f"q{i}"}]}


# ------------------------------------------------------------- scenarios
# Each runs on one package and returns what it decided; the test runs it on
# both and compares. The reference tests' own expectations are asserted too.

def sc_routing(g):
    out = {}
    busy, idle = FakeEngine("r0"), FakeEngine("r1")
    busy._slot_req[0] = busy._slot_req[1] = object()
    gw = make_gateway(g, [busy, idle])
    for i in range(4):
        gw.chat(q(i))
    out["least_busy"] = [busy.calls, idle.calls]
    assert out["least_busy"] == [0, 4]

    engines = [FakeEngine(f"r{i}") for i in range(3)]
    gw = make_gateway(g, engines, policy="round_robin")
    for i in range(6):
        gw.chat(q(i))
    out["round_robin"] = [e.calls for e in engines]
    assert out["round_robin"] == [2, 2, 2]

    engines = [FakeEngine("r0"), FakeEngine("r1")]
    gw = make_gateway(g, engines, policy="round_robin")
    convo = [{"role": "system", "content": "you are helpful"},
             {"role": "user", "content": "turn 1"}]
    gw.chat({"messages": convo})
    for turn in range(2, 6):
        gw.chat({"messages": convo + [
            {"role": "user", "content": f"turn {turn}"}]})
    out["affinity"] = [e.calls for e in engines]
    assert sorted(out["affinity"]) == [0, 5]
    out["session_key"] = g.session_key(convo)

    plain, tuned = FakeEngine("r0"), FakeEngine("r1",
                                                adapters=("billing-bot",))
    gw = make_gateway(g, [plain, tuned])
    for i in range(3):
        gw.chat(dict(q(i), model="billing-bot"))
    out["adapter"] = [plain.calls, tuned.calls]
    assert out["adapter"] == [0, 3]

    engines = [FakeEngine("r0"), FakeEngine("r1")]
    gw = make_gateway(g, engines, policy="round_robin")
    assert gw.pool.drain("r0")
    for i in range(4):
        gw.chat(q(i))
    out["draining"] = [e.calls for e in engines]
    assert out["draining"] == [0, 4]
    return out


def sc_failover(g):
    out = {}
    dead, alive = FakeEngine("r0"), FakeEngine("r1", reply="from r1")
    dead.dead = True
    alive._slot_req[0] = object()
    gw = make_gateway(g, [dead, alive])
    out["nonstream"] = [gw.chat({"messages": MSGS}),
                        gw.pool.get("r0").breaker._failures]

    dying = FakeEngine("r0", reply="hello world", die_after_deltas=2)
    backup = FakeEngine("r1", reply="hello world")
    backup._slot_req[0] = object()
    gw = make_gateway(g, [dying, backup])
    deltas = list(gw.chat_stream({"messages": MSGS}))
    out["midstream"] = [deltas, dying.calls, backup.calls,
                        gw.registry.counter(
                            "dtx_gateway_failovers_total").get()]
    assert "".join(deltas) == "hello world"

    e0, e1 = FakeEngine("r0"), FakeEngine("r1")
    e0.dead = e1.dead = True
    gw = make_gateway(g, [e0, e1])
    with pytest.raises(g.NoReplicaAvailable) as ei:
        gw.chat({"messages": MSGS})
    out["all_dead"] = str(ei.value)
    return out


def sc_breaker(g):
    states = []
    b = g.CircuitBreaker(failure_threshold=2, cooldown_s=0.05)
    states.append(b.state)
    b.record_failure()
    states.append(b.state)
    b.record_failure()
    states.append((b.state, b.allow()))
    time.sleep(0.06)
    states.append((b.state, b.allow()))
    b.record_failure()
    states.append(b.state)
    time.sleep(0.06)
    b.record_success()
    states.append(b.state)
    assert states == ["closed", "closed", ("open", False),
                      ("half_open", True), "open", "closed"]

    flaky, steady = FakeEngine("r0"), FakeEngine("r1")
    flaky.dead = True
    gw = make_gateway(g, [flaky, steady])
    gw.pool.get("r0").breaker.cooldown_s = 60
    for i in range(5):
        gw.chat(q(i))
    opened = gw.pool.get("r0").breaker.state
    flaky.calls = 0
    gw.chat({"messages": [{"role": "user", "content": "after open"}]})
    assert opened == "open" and flaky.calls == 0
    return {"lifecycle": states, "gateway": [opened, flaky.calls,
                                             steady.calls]}


def sc_admission(g):
    out = {}
    adm = g.AdmissionController(max_queue=100, token_budget=40)
    msgs = [{"role": "user", "content": "x" * 60}]
    t1, t2 = adm.try_admit(msgs), adm.try_admit(msgs)
    with pytest.raises(g.Overloaded) as ei:
        adm.try_admit(msgs)
    out["budget"] = [str(ei.value), ei.value.retry_after_s, adm.shed_count,
                     t1.tokens]
    t1.release()
    t2.release()
    adm.try_admit(msgs).release()

    adm = g.AdmissionController(max_queue=2, token_budget=10_000)
    tickets = [adm.try_admit(MSGS) for _ in range(2)]
    with pytest.raises(g.Overloaded) as ei:
        adm.try_admit(MSGS)
    out["queue"] = [str(ei.value), ei.value.retry_after_s]
    for t in tickets:
        t.release()

    est = g.estimate_prompt_tokens
    big = [{"role": "user", "content": "x" * 400}]
    out["estimates"] = [est(big), est(big, chars_per_token=2.0),
                        est(MSGS, count_tokens=lambda t: 7)]
    assert out["estimates"][:2] == [104, 204]

    ac = g.AdmissionController(max_queue=16, token_budget=100)
    small = {"name": "small", "share": 1.0, "share_total": 4.0,
             "kv_block_quota": 0}
    large = {"name": "big", "share": 3.0, "share_total": 4.0,
             "kv_block_quota": 0}
    x = [{"role": "user", "content": "x"}]
    s1 = ac.try_admit(x, tokens=50, tenant=small)
    with pytest.raises(g.Overloaded) as ei:
        ac.try_admit(x, tokens=40, tenant=small)
    out["fair_share"] = str(ei.value)
    assert "tenant small over fair share (50+40>25 tokens, share 1/4)" \
        in out["fair_share"]
    s2 = ac.try_admit(x, tokens=40, tenant=large)
    out["usage"] = ac.tenant_usage()
    s2.release()
    s1.release()

    ac = g.AdmissionController(max_queue=16, token_budget=4096)
    bulk = {"name": "bulkco", "share": 1.0, "share_total": 1.0,
            "kv_block_quota": 9}
    b1 = ac.try_admit(x, tokens=16, tenant=bulk)
    with pytest.raises(g.Overloaded) as ei:
        ac.try_admit(x, tokens=16, tenant=bulk)
    out["quota"] = str(ei.value)
    assert "tenant bulkco KV block quota exhausted (5+5>9 blocks)" \
        in out["quota"]
    b1.release()
    return out


def sc_autoscale(g):
    hint = g.autoscale_hint
    out = {"hints": [
        hint(replicas=2, available_replicas=2, queue_depth=20,
             queued_tokens=5000, shed_count=0, p95_latency_s=1.0),
        hint(replicas=1, available_replicas=1, queue_depth=3,
             queued_tokens=900, shed_count=7, p95_latency_s=0.5),
        hint(replicas=3, available_replicas=3, queue_depth=0,
             queued_tokens=0, shed_count=0, p95_latency_s=0.1),
        hint(replicas=2, available_replicas=2, queue_depth=2,
             queued_tokens=100, shed_count=50, shed_recent=0,
             p95_latency_s=0.5)]}
    assert [h["desiredReplicas"] for h in out["hints"]] == [3, 2, 2, 2]
    out["parse"] = [g.parse_hint(out["hints"][2]),
                    g.parse_hint({"replicas": "x"})]

    slow = FakeEngine("r0", delay=0.2)
    gw = make_gateway(g, [slow], admission=g.AdmissionController(
        max_queue=1, token_budget=10**6))
    hints = []
    for _ in range(2):
        t = threading.Thread(target=lambda: gw.chat({"messages": MSGS}))
        t.start()
        wait_until(lambda: gw.admission.depth == 1, "never admitted")
        if not hints:
            with pytest.raises(g.Overloaded):
                gw.admission.try_admit(MSGS)
        h = gw.autoscale()
        hints.append([h["shedCount"], h["desiredReplicas"], h["reason"],
                      h["replicas"], h["availableReplicas"]])
        t.join()
    assert hints[0][:2] == [1, 2] and "shedding" not in hints[1][2]
    out["gateway"] = hints
    return out


def _req(url, path, body=None, method=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    rq = urllib.request.Request(
        url + path, data=data, method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(rq, timeout=30) as r:
            raw = r.read()
            return r.status, raw, dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _served(g, gw):
    srv = g.serve(gw, port=0, host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def _sse_text(raw):
    text = ""
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            text += json.loads(line[6:])["choices"][0]["delta"].get(
                "content") or ""
    return text


def sc_http(g):
    out = {}
    dying = FakeEngine("r0", reply="hello world", die_after_deltas=2)
    backup = FakeEngine("r1", reply="hello world")
    backup._slot_req[0] = object()
    gw = make_gateway(g, [dying, backup])
    srv, url = _served(g, gw)
    try:
        code, raw, hdr = _req(url, "/v1/chat/completions",
                              {"messages": MSGS},
                              headers={"X-DTX-Trace-Id": "trace-abc123"})
        body = json.loads(raw)
        out["chat"] = [code, hdr["X-DTX-Trace-Id"],
                       body["choices"][0]["message"]["content"],
                       sorted(body)]
        dying.dead, dying.die_after_deltas = False, 2
        backup._slot_req[0] = object()
        gw.pool.get("r0").breaker.record_success()
        code, raw, _ = _req(url, "/chat/completions",
                            {"messages": [{"role": "user",
                                           "content": "stream me"}],
                             "stream": True})
        out["sse"] = [code, _sse_text(raw)]
        code, raw, _ = _req(url, "/healthz")
        out["healthz"] = [code, json.loads(raw)["status"]]
        code, raw, _ = _req(url, "/autoscale")
        out["autoscale"] = [code, g.parse_hint(json.loads(raw))["replicas"]]
        out["drain"] = [_req(url, "/admin/drain", {"replica": "r1"})[:2],
                        _req(url, "/admin/drain", {"replica": "ghost"})[0],
                        _req(url, "/admin/scale", {"replicas": 3})[0],
                        _req(url, "/chat/completions", {"messages": []})[0],
                        _req(url, "/nope", {})[0]]
        code, raw, _ = _req(url, "/autoscale")
        out["after_drain"] = json.loads(raw)["availableReplicas"]
    finally:
        srv.shutdown()
        gw.close()
    assert out["drain"][1:] == [404, 501, 400, 404]

    slow = FakeEngine("r0", reply="slow answer", delay=0.3)
    gw = make_gateway(g, [slow], admission=g.AdmissionController(
        max_queue=1, token_budget=10**6))
    srv, url = _served(g, gw)
    try:
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            "inflight", _req(url, "/chat/completions", {"messages": MSGS})))
        t.start()
        wait_until(lambda: gw.admission.depth == 1, "never admitted")
        code, raw, hdr = _req(url, "/chat/completions",
                              {"messages": [{"role": "user",
                                             "content": "x"}]})
        t.join(timeout=30)
        out["overload"] = [code, hdr.get("Retry-After"), json.loads(raw),
                           res["inflight"][0]]
        assert code == 429
    finally:
        srv.shutdown()
        gw.close()
    return out


TENANTS = {"gold": {"tier": "pinned", "share": 3},
           "batch": {"tier": "bulk", "share": 1, "kv_block_quota": 1}}


def sc_tenancy(g):
    out = {}
    gw = make_gateway(g, [FakeEngine("r0"), FakeEngine("r1")],
                      tenants=TENANTS)
    srv, url = _served(g, gw)
    try:
        out["row"] = gw._admission_tenant(gw.tenants.get("gold"))
        assert gw.chat({"messages": MSGS, "max_tokens": 4},
                       tenant="gold") == "hello world"
        with pytest.raises(g.Overloaded) as ei:
            gw.chat({"messages": MSGS, "max_tokens": 4}, tenant="batch")
        out["quota"] = str(ei.value)
        assert "tenant batch KV block quota exhausted" in out["quota"]
        code, raw, _ = _req(url, "/chat/completions",
                            {"messages": MSGS, "max_tokens": 4},
                            headers={"X-DTX-Tenant": "batch"})
        out["http_quota"] = [code, json.loads(raw)]
        code, raw, _ = _req(url, "/admin/tenants")
        doc = json.loads(raw)
        out["tenants"] = [code, doc]
        gen0 = doc["generation"]
        steps = [
            {"name": "extra", "tier": "bulk", "share": 1,
             "kv_block_quota": 16},
            {"name": "bad", "tier": "gold"},
            {"name": "extra", "remove": True},
            {"name": "extra", "remove": True}]
        for body in steps:
            code, raw, _ = _req(url, "/admin/tenants", body)
            out.setdefault("admin", []).append([code, json.loads(raw)])
        assert [c for c, _ in out["admin"]] == [200, 400, 200, 404]
        assert out["admin"][0][1]["generation"] > gen0
    finally:
        srv.shutdown()
        gw.close()
    gw = make_gateway(g, [FakeEngine("r0")])
    srv, url = _served(g, gw)
    try:
        code, raw, _ = _req(url, "/admin/tenants")
        out["off"] = [code, json.loads(raw),
                      "dtx_gateway_tenant_" in gw.metrics_text()]
    finally:
        srv.shutdown()
        gw.close()
    return out


def _pump(gw, n):
    for i in range(n):
        gw.chat(q(i))


def sc_promotion(g):
    out = {}
    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    gw = make_gateway(g, fleet, model_name="rb")
    em = g.ExperimentMetrics(experiment="rb")
    bad = FakeEngine("canary")
    bad.dead = True
    gw.pool.add(g.InProcessReplica("canary", bad))
    promo = gw.start_promotion(
        "canary", config={"schedule": [0.5, 1.0], "min_requests": 3,
                          "step_s": 60.0}, metrics=em, background=False)
    seq = [promo.tick(), gw.pool.get("canary").weight]
    _pump(gw, 12)
    seq += [promo.tick(), gw.pool.get("canary").weight,
            [gw.pool.get(e.name).weight for e in fleet], promo.reason]
    assert seq[2] == "rolled_back"
    out["rollback"] = seq
    out["rollback_metrics"] = em.expose()
    gw.close()

    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    gw = make_gateway(g, fleet, model_name="ok")
    gw.pool.add(g.InProcessReplica("canary", FakeEngine("canary")))
    promo = gw.start_promotion(
        "canary", config={"schedule": [0.5, 1.0], "min_requests": 2,
                          "step_s": 60.0}, background=False)
    seq = [promo.tick()]
    for _ in range(20):
        _pump(gw, 4)
        seq.append([promo.tick(), promo.stage,
                    gw.pool.get("canary").weight])
        if promo.state in ("completed", "rolled_back"):
            break
    assert promo.state == "completed"
    out["complete"] = seq
    st = promo.status()
    out["status"] = {k: st[k] for k in ("state", "canary", "schedule",
                                        "weight")}
    gw.close()

    fleet = [FakeEngine("fleet-0"), FakeEngine("fleet-1")]
    gw = make_gateway(g, fleet, model_name="m")
    gw.pool.add(g.InProcessReplica("canary", FakeEngine("canary")))
    srv, url = _served(g, gw)
    try:
        codes = [_req(url, "/admin/promote")[0],
                 _req(url, "/admin/promote", {"replica": "ghost"})[0],
                 _req(url, "/admin/promote",
                      {"replica": "canary", "schedule": [0.5, 0.25]})[0]]
        code, raw, _ = _req(url, "/admin/promote",
                            {"replica": "canary", "schedule": [0.5, 1.0],
                             "min_requests": 2, "step_s": 30.0})
        codes += [code, _req(url, "/admin/promote",
                             {"replica": "canary"})[0]]
        trace_id = json.loads(raw)["trace_id"]
        state = ""
        deadline = time.monotonic() + 30
        while state not in ("completed", "rolled_back") and \
                time.monotonic() < deadline:
            _req(url, "/chat/completions", {"messages": MSGS})
            state = json.loads(_req(url, "/admin/promote")[1])["state"]
        code, raw, _ = _req(url, f"/debug/trace/{trace_id}")
        names = sorted(s["name"] for s in json.loads(raw)["spans"])
        out["http"] = [codes, state, code, names]
        assert codes == [404, 400, 400, 202, 409] and state == "completed"
    finally:
        srv.shutdown()
        gw.close()
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_routing, sc_failover, sc_breaker, sc_admission, sc_autoscale,
    sc_http, sc_tenancy, sc_promotion)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_decisions(name):
    want = SCENARIOS[name](gw_pkg("ref"))
    got = SCENARIOS[name](gw_pkg("port"))
    assert got == want


# ----------------------------------------------------------- /metrics bytes

class _Clock:
    def __init__(self):
        self.t = 1_000.0

    def tick(self):
        self.t += 0.001
        return self.t


def _metrics_after_scenario(g, monkeypatch, tenants):
    clock = _Clock()
    for name in ("time", "perf_counter", "monotonic"):
        monkeypatch.setattr(time, name, clock.tick)
    flaky, steady = FakeEngine("r0"), FakeEngine("r1", adapters=("ad",))
    flaky.dead = True
    gw = make_gateway(g, [flaky, steady], model_name="m",
                      admission=g.AdmissionController(max_queue=8,
                                                      token_budget=64),
                      tenants=TENANTS if tenants else None)
    try:
        gw.pool.get("r0").breaker.cooldown_s = 600
        for i in range(4):
            gw.chat(q(i), tenant="gold" if tenants else "")
        list(gw.chat_stream(dict(q(9), model="ad")))
        with pytest.raises(g.Overloaded):
            gw.chat({"messages": [{"role": "user", "content": "x" * 400}]},
                    tenant="batch" if tenants else "")
        gw.autoscale()
        return "\n".join(ln for ln in gw.metrics_text().splitlines()
                         if "dtx_build_info" not in ln
                         and "dtx_gateway_uptime_seconds" not in ln)
    finally:
        gw.close()
        monkeypatch.undo()


@pytest.mark.parametrize("tenants", [False, True],
                         ids=["tenantless", "tenants"])
def test_metrics_bytes_equal(monkeypatch, tenants):
    want = _metrics_after_scenario(gw_pkg("ref"), monkeypatch, tenants)
    got = _metrics_after_scenario(gw_pkg("port"), monkeypatch, tenants)
    assert got == want
    for family in ("dtx_gateway_requests_total", "dtx_gateway_shed_total",
                   "dtx_gateway_replica_circuit_state",
                   "dtx_gateway_request_latency_seconds_bucket"):
        assert family in got
    assert ("dtx_gateway_tenant_requests_total" in got) is tenants


# ------------------------------------------------------ over real engines

REQ = {"messages": [{"role": "user",
                     "content": "tell me a long story about foxes"}],
       "max_tokens": 40, "temperature": 0.0}
CHATS = ["the quick brown fox", "a b c d e f", "hello gateway",
         "tell me a long story about foxes"]
NEW = 24


def record(eng):
    """Every Request ``eng.submit`` makes and every session it imports."""
    seen, real_submit, real_import = [], eng.submit, eng.import_session

    def submit(*a, **kw):
        req = real_submit(*a, **kw)
        seen.append(req)
        return req

    def import_session(payload, *a, **kw):
        meta = real_import(payload, *a, **kw)
        seen.append(meta["_request"])
        return meta

    eng.submit, eng.import_session = submit, import_session
    return seen


def stream_text(tok, tokens, base=0):
    """The text a stream carries past its first ``base`` tokens, by the
    engines' rule: a delta each time the decoded text grows and does not end
    inside a character (U+FFFD), so a trailing U+FFFD is never sent."""
    acc = list(tokens[:base])
    sent = tok.decode(acc, skip_special_tokens=True) if acc else ""
    out = []
    for t in tokens[base:]:
        acc.append(t)
        text = tok.decode(acc, skip_special_tokens=True)
        if len(text) > len(sent) and not text.endswith("\ufffd"):
            out.append(text[len(sent):])
            sent = text
    return "".join(out)


def spliced_text(tok, tail, full):
    """What a client's stream holds after a splice at ``tail``: the
    gateway sends the import's ``text_so_far`` (the tail's whole text,
    U+FFFD included) and then the continuation's stream past the tail."""
    return (tok.decode(tail, skip_special_tokens=True)
            + stream_text(tok, full, len(tail)))


@pytest.fixture(scope="module")
def engine_pairs(peaked_export):
    """Two JAX and two port engines on the same peaked export."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JE
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    kw = dict(template="vanilla", max_seq_len=256, slots=2, decode_chunk=4,
              kv_block_size=16, prefill_chunk=64)
    pairs = {"ref": [JE(peaked_export, **kw) for _ in range(2)],
             "port": [BatchedEngine(peaked_export, device="cpu", **kw)
                      for _ in range(2)]}
    yield pairs
    for engines in pairs.values():
        for e in engines:
            e.close()


def _gateway_over(which, engines):
    g = gw_pkg(which)
    pool = g.ReplicaPool([g.InProcessReplica(f"replica-{i}", e)
                          for i, e in enumerate(engines)])
    return g.Gateway(pool, model_name="peaked")


def _chats(which, engines):
    """(prompt ids, token ids, text) of each greedy chat through the
    ``which`` package's gateway, non-streamed and streamed in turn."""
    seen = [record(e) for e in engines]
    gw = _gateway_over(which, engines)
    try:
        out = []
        for content in CHATS:
            body = {"messages": [{"role": "user", "content": content}],
                    "max_tokens": NEW, "temperature": 0.0}
            for call in (gw.chat,
                         lambda b: "".join(gw.chat_stream(b))):
                text = call(dict(body))
                [req] = [r for s in seen for r in s]
                for s in seen:
                    s.clear()
                out.append((req.prompt_ids, list(req.tokens), text))
        return out
    finally:
        for e in engines:
            del e.submit, e.import_session
        gw.slo.stop()  # gw.close() would close the shared engines


def _near_tie(export_dir, prompt, prefix) -> bool:
    """The JAX package's bf16 logits for the step after ``prefix`` put the
    top two within 2 bf16 ulps (``tests/test_torch_engine.py``'s rule)."""
    import jax.numpy as jnp
    import numpy as np

    from datatunerx_tpu.models.llama import forward as jforward
    from datatunerx_tpu.utils.decoding import prepare_prompt
    from datatunerx_tpu.utils.model_loader import (
        load_model_and_tokenizer as jload,
    )

    cfg, params, tok = jload(export_dir, dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, NEW)
    seq = ids + list(prefix)
    pos = positions + list(range(n, n + len(prefix)))
    msk = mask + [1] * len(prefix)
    logits, _ = jforward(params, jnp.asarray([seq]), cfg,
                         positions=jnp.asarray([pos]),
                         attention_mask=jnp.asarray([msk]),
                         compute_dtype=jnp.bfloat16)
    top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1][:2]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
    return (top[0] - top[1]) <= 2 * ulp


def test_greedy_chats_equal_the_reference_gateway(engine_pairs,
                                                  peaked_export):
    """Token ids equal, or parted at a bf16 near-tie of the JAX package's
    logits (the engines' rule: the two frameworks round bf16 matmuls in
    different places); the text is equal wherever the ids are."""
    want = _chats("ref", engine_pairs["ref"])
    got = _chats("port", engine_pairs["port"])
    assert len(got) == len(want) == 2 * len(CHATS)
    equal = 0
    for (p_ids, g_ids, g_text), (w_p, w_ids, w_text) in zip(got, want):
        assert p_ids == w_p and len(g_ids) == len(w_ids) == NEW
        div = next((i for i in range(NEW) if g_ids[i] != w_ids[i]), None)
        if div is None:
            assert g_text == w_text
            equal += 1
        else:
            assert _near_tie(peaked_export, w_p, w_ids[:div]), div
    # a chat and its streamed twin make the same ids in each package
    for pkg in (got, want):
        assert all(pkg[i][1] == pkg[i + 1][1] for i in range(0, len(pkg), 2))
    assert equal >= len(got) // 2


def _drain_splice(which, engines):
    """One mid-stream drain through the ``which`` package's gateway: the
    stream's replica is held (a gate) once it has 5 tokens out, drained,
    then released."""
    seen = [record(e) for e in engines]
    gw = _gateway_over(which, engines)
    try:
        undisturbed = gw.chat(dict(REQ))
        plain_stream = "".join(gw.chat_stream(dict(REQ)))
        want_ids = [list(r.tokens) for s in seen for r in s]
        assert len(want_ids) == 2 and want_ids[0] == want_ids[1]
        for s in seen:
            s.clear()
        releases = [held(e, lambda e=e: any(
            r is not None and len(r.tokens) >= 5 for r in e._slot_req))
            for e in engines]
        collected = {}

        def consume():
            collected["text"] = "".join(
                gw.chat_stream(dict(REQ), trace_id=f"dtx-drain-{which}"))

        th = threading.Thread(target=consume)
        try:
            th.start()
            wait_until(lambda: any(
                r is not None and len(r.tokens) >= 5
                for e in engines for r in e._slot_req),
                "the stream never reached 5 tokens")
            src = next(i for i, e in enumerate(engines) if any(
                r is not None and len(r.tokens) >= 5 for r in e._slot_req))
            assert gw.drain(f"replica-{src}")
            handoff = dict(gw.last_handoff)
            emptied = all(r is None for r in engines[src]._slot_req)
        finally:
            for release in releases:
                release()
        th.join(timeout=120)
        assert not th.is_alive(), "the spliced stream never finished"
        stats = gw.handoff_stats()
        moved = [list(r.tokens) for r in seen[src]]
        imported = [list(r.tokens) for r in seen[1 - src]]
        return {"undisturbed": undisturbed, "plain_stream": plain_stream,
                "spliced": collected["text"], "handoff": handoff,
                "emptied": emptied, "stats": stats, "want_ids": want_ids[0],
                "moved": moved, "imported": imported,
                "tokenizer": engines[0].tokenizer}
    finally:
        for e in engines:
            del e.submit, e.import_session
        gw.slo.stop()  # gw.close() would close the shared engines


def test_drain_splice_equals_the_reference_gateway(engine_pairs):
    want = _drain_splice("ref", engine_pairs["ref"])
    got = _drain_splice("port", engine_pairs["port"])
    for run in (want, got):
        assert run["handoff"]["imported"] == 1, run["handoff"]
        assert run["emptied"]
        assert run["stats"].get("imported") == 1
        assert run["stats"].get("splice_ok") == 1 and not run["stats"].get(
            "cold")
        # token ids: the source stopped at the export, the destination's
        # session carries on from its tail to the undisturbed run's end
        [tail], [full] = run["moved"], run["imported"]
        assert 5 <= len(tail) < len(full)
        assert full == run["want_ids"] and full[:len(tail)] == tail
        # the shared hold-back (ROADMAP Queue 3): a stream never sends a
        # trailing U+FFFD, the non-streamed chat renders it, and a splice
        # sends the tail's whole text first
        tok = run["tokenizer"]
        assert run["undisturbed"] == tok.decode(full,
                                                skip_special_tokens=True)
        assert run["plain_stream"] == stream_text(tok, full)
        assert run["spliced"] == spliced_text(tok, tail, full)
    for key in ("undisturbed", "plain_stream", "spliced", "want_ids",
                "moved", "imported"):
        assert got[key] == want[key], key


def test_fleet_plane_through_the_port_gateway():
    """The port gateway's fleet plane over two port engines: a long prompt
    prefers the prefill replica, the plane's tick hands its decoding session
    to the decode replica and the client's stream carries on there; the
    prefix tier then serves the same prompt on the decode replica with zero
    prefill chunks, and the same tokens."""
    from datatunerx_tpu_torch.gateway.replica_pool import (
        InProcessReplica,
        ReplicaPool,
    )
    from datatunerx_tpu_torch.gateway.server import Gateway
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
    from tests.test_torch_fleet import prefill_tokens
    from tests.test_torch_migration import PAGED

    kw = dict(PAGED, prefix_cache=4)
    a, b = BatchedEngine("preset:debug", **kw), BatchedEngine(
        "preset:debug", **kw)
    pool = ReplicaPool([InProcessReplica("P", a, role="prefill"),
                        InProcessReplica("D", b, role="decode")])
    gw = Gateway(pool, model_name="preset:debug", prefill_threshold=16,
                 fleet_prefix_bytes=64 << 20, fleet_handoff=True)
    try:
        content = "fleet plane probe " * 6
        body = {"messages": [{"role": "user", "content": content}],
                "max_tokens": 24, "temperature": 0.0}
        prompt, _ = a._encode_chat(body["messages"])
        want = a.generate(prompt, max_new_tokens=24)
        moved, imported = record(a), record(b)
        release = held(a, lambda: any(
            r is not None and len(r.tokens) >= 3 for r in a._slot_req))
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "text", "".join(gw.chat_stream(dict(body), trace_id="fl-1"))))
        try:
            th.start()
            wait_until(lambda: any(r is not None and len(r.tokens) >= 3
                                   for r in a._slot_req),
                       "the prefill replica never decoded")
            tick = gw.fleet.tick()
        finally:
            release()
        th.join(timeout=120)
        assert tick["handoff"]["moved"] == 1, tick
        [tail] = [r.tokens for r in moved]
        [full] = [r.tokens for r in imported]
        assert full == want and full[:len(tail)] == tail
        assert out["text"] == spliced_text(a.tokenizer, tail, full)
        assert any(e[0] == "import" for e in b.sched_trace)
        stats = gw.fleet.stats()
        assert stats["handoff"]["ok"] == 1
        # the prefix tier: what P prefilled is on D; a request there
        # prefills nothing of it
        ticks = [tick, gw.fleet.tick()]
        assert sum(t["prefix"]["pulled"] for t in ticks) >= 1
        assert sum(t["prefix"]["pushed"] for t in ticks) >= 1
        mark = len(b.sched_trace)
        assert b.generate(prompt, max_new_tokens=24) == want
        assert prefill_tokens(b, mark) == 0
        assert "dtx_fleet_handoff_total" in gw.metrics_text()
    finally:
        gw.close()
        a.close()
        b.close()


# -------------------------------------------------------------- spawn mode

def _server_pids(root):
    """Pids of port server processes whose working directory is under
    ``root``."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            cwd = os.readlink(f"/proc/{pid}/cwd")
        except OSError:
            continue
        if b"datatunerx_tpu_torch.serving.server" in cmd and \
                cwd.startswith(str(root)):
            pids.append(int(pid))
    return pids


def test_local_backend_spawns_scales_and_reaps_port_replicas(tmp_path):
    from datatunerx_tpu_torch.serving.local_backend import (
        LocalServingBackend,
    )

    backend = LocalServingBackend(str(tmp_path), device="cpu")
    spec = {"model_path": "preset:debug", "replicas": 2, "slots": 2,
            "kv_block_size": 16}
    argv = backend.argv(spec, 1234, str(tmp_path))
    assert argv[1:3] == ["-m", "datatunerx_tpu_torch.gateway.server"]
    assert argv[argv.index("--device") + 1] == "cpu"
    backend.deploy("gw", spec)
    try:
        deadline = time.monotonic() + 180
        while backend.status("gw") != "HEALTHY":
            assert backend.status("gw") != "FAILED", (
                tmp_path / "serve-gw" / "log.txt").read_text()
            assert time.monotonic() < deadline, "never HEALTHY"
            time.sleep(0.2)
        assert len(_server_pids(tmp_path)) == 2
        url = backend.endpoint("gw")
        code, raw, _ = _req(url, "/chat/completions",
                            {"messages": MSGS, "max_tokens": 4})
        assert code == 200
        assert "content" in json.loads(raw)["choices"][0]["message"]
        assert backend.scale_hint("gw")["replicas"] == 2
        assert backend.scale("gw", 1)
        wait_until(lambda: (backend.scale_hint("gw") or {}).get(
            "replicas") == 1, "scale did not reach 1 replica", timeout=60)
        wait_until(lambda: len(_server_pids(tmp_path)) == 1,
                   "the scaled-down replica was not reaped", timeout=60)
    finally:
        backend.delete("gw")
    assert backend.status("gw") == "NotFound"
    wait_until(lambda: not _server_pids(tmp_path),
               "delete left port server processes behind", timeout=15)
