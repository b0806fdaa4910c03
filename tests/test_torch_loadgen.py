"""The port's load generator (``datatunerx_tpu_torch/loadgen/``) against the
reference's, on the CPU.

- The 13 scenarios of ``tests/test_loadgen.py`` run on both packages
  through one parametrised body (``pkg``): workload shape, trace
  round-trip, chaos, the runner, the SLO epilogue, ``--selftest``
  (``_FakeEngine`` replicas under each package's ``Gateway``) and the
  tightened objective's failure;
- workloads from one seed are equal event for event, and a trace written
  by either package is read back by the other;
- ``--selftest`` over each package's gateway gives the same SLO verdicts,
  the ``--tighten`` failure included;
- ``dtx-torch replay`` dispatches before argparse, ``DTX_SAN`` is refused
  with a message naming the unported sanitizers, and the port's report
  carries the reference's keys plus its p90s and no-content count.
"""

import importlib
import io
import json
import time

import pytest

from tests.torch_twin import PKGS, Twin

M = Twin(
    ChaosInjector="loadgen.chaos:ChaosInjector",
    load_chaos="loadgen.chaos:load_chaos",
    LocalClient="loadgen.replay:LocalClient",
    ReplayRunner="loadgen.replay:ReplayRunner",
    apply_tighten="loadgen.replay:apply_tighten",
    build_selftest_fleet="loadgen.replay:build_selftest_fleet",
    replay_main="loadgen.replay:main",
    slo_epilogue="loadgen.replay:slo_epilogue",
    WorkloadModel="loadgen.workload:WorkloadModel",
    read_trace="loadgen.workload:read_trace",
    summarize="loadgen.workload:summarize",
    write_trace="loadgen.workload:write_trace",
    SLOEvaluator="obs.slo:SLOEvaluator",
    default_slos="obs.slo:default_slos",
)


@pytest.fixture(params=PKGS)
def pkg(request):
    return M.use(request.param)


# ------------------------------------------------------------------ workload

def test_workload_deterministic_and_heavy_tailed(pkg):
    a = M.WorkloadModel(requests=60, sessions=5, seed=3,
                        adapters=["t-a", "t-b", "t-c"]).generate()
    b = M.WorkloadModel(requests=60, sessions=5, seed=3,
                        adapters=["t-a", "t-b", "t-c"]).generate()
    assert a == b  # same seed, same trace — replayable by construction
    c = M.WorkloadModel(requests=60, sessions=5, seed=4,
                        adapters=["t-a", "t-b", "t-c"]).generate()
    assert a != c
    sizes = sorted(sum(len(m["content"]) for m in e["messages"]) for e in a)
    assert sizes[-1] > 3 * sizes[len(sizes) // 2]  # a real tail
    assert all(e["t"] <= n["t"] for e, n in zip(a, a[1:]))
    models = [e["model"] for e in a]
    assert "" in models  # base traffic interleaved
    assert {"t-a", "t-b", "t-c"} <= set(m for m in models if m)


def test_workload_sessions_reuse_prefixes(pkg):
    events = M.WorkloadModel(requests=40, sessions=3, seed=0).generate()
    by_session: dict = {}
    for e in events:
        by_session.setdefault(e["session"], []).append(e)
    multi = [evs for evs in by_session.values() if len(evs) > 1]
    assert multi
    for evs in multi:
        system = evs[0]["messages"][0]
        for e in evs[1:]:
            # every turn reopens with the SAME system prompt — the reused
            # prefix a prefix cache / affinity router keys on
            assert e["messages"][0] == system
            assert e["turn"] > evs[0]["turn"] or e is evs[0]


def test_trace_roundtrip_and_validation(pkg, tmp_path):
    model = M.WorkloadModel(requests=12, sessions=2, seed=1,
                            adapters=["t-a"])
    events = model.generate()
    path = tmp_path / "trace.jsonl"
    M.write_trace(str(path), events, model.meta())
    meta, back = M.read_trace(str(path))
    assert back == events
    assert meta["requests"] == 12
    assert M.summarize(back)["requests"] == 12
    with pytest.raises(ValueError, match="kind"):
        M.read_trace(io.StringIO('{"kind": "nope", "version": 1}\n'))
    with pytest.raises(ValueError, match="version"):
        M.read_trace(io.StringIO('{"kind": "dtx-load-trace", "version": 9}\n'))
    with pytest.raises(ValueError, match="bad event"):
        M.read_trace(io.StringIO(
              '{"kind": "dtx-load-trace", "version": 1}\n{"t": "x"}\n'))


# --------------------------------------------------------------------- chaos

def test_chaos_fires_in_order_and_skips_unknown_ops(pkg):
    fired = []
    inj = M.ChaosInjector(
        [{"t": 0.02, "op": "beta"}, {"t": 0.0, "op": "alpha"},
         {"t": 0.01, "op": "mystery"}],
        {"alpha": lambda op: fired.append("alpha") or {"ok": 1},
         "beta": lambda op: fired.append("beta") or {"ok": 1}})
    inj.run(speed=1.0)
    assert fired == ["alpha", "beta"]
    log = inj.report()
    assert [e["op"] for e in log] == ["alpha", "mystery", "beta"]
    skipped = next(e for e in log if e["op"] == "mystery")
    assert skipped["ok"] is None and "skipped" in skipped["detail"]


def test_chaos_action_failure_is_logged_not_raised(pkg):
    def boom(op):
        raise RuntimeError("refused")

    inj = M.ChaosInjector([{"t": 0.0, "op": "drain"}], {"drain": boom})
    inj.run()
    assert inj.report()[0]["ok"] is False
    assert "refused" in inj.report()[0]["detail"]


def test_load_chaos_inline_and_validation(pkg):
    ops = M.load_chaos('[{"t": 1.0, "op": "drain", "replica": "r1"}]')
    assert ops[0]["op"] == "drain"
    with pytest.raises(ValueError, match="needs t and op"):
        M.load_chaos('[{"op": "drain"}]')


# -------------------------------------------------------------------- runner

class _StubClient:
    def __init__(self):
        self.calls = []

    def send(self, event, trace_id):
        self.calls.append(event)
        fail = bool(event.get("fail"))
        return {"code": 502 if fail else 200, "error": None,
                "chars": 4, "ttft_ms": 20.0 if not fail else None,
                "latency_ms": 35.0}


def test_replay_runner_reports_and_records(pkg):
    client = _StubClient()
    runner = M.ReplayRunner(client, max_inflight=4)
    events = [{"t": 0.0, "messages": [{"role": "user", "content": "a"}]},
              {"t": 0.01, "messages": [{"role": "user", "content": "b"}],
               "fail": True},
              {"t": 0.02, "messages": [{"role": "user", "content": "c"}]}]
    report = runner.run(events, speed=100.0)
    assert report["requests"] == 3 and report["errors"] == 1
    assert report["codes"] == {"200": 2, "502": 1}
    assert report["ttft_ms_p50"] == 20.0
    assert report["ttft_ms_p99"] == 20.0
    text = runner.registry.expose()
    assert 'dtx_loadgen_requests_total{code="200"} 2' in text
    assert 'dtx_loadgen_requests_total{code="502"} 1' in text
    # exemplars link every histogram bucket back to a replay trace id
    assert '# {trace_id="dtx-load-' in text


def test_epilogue_passes_and_fails_by_objective(pkg):
    client = _StubClient()
    runner = M.ReplayRunner(client)
    evaluator = M.SLOEvaluator(runner.registry, M.default_slos("loadgen"))
    # the tightened twin judges the SAME run (all ttfts are 20ms, so a
    # 1ms threshold must violate); both baselines predate the traffic,
    # exactly like the CLI building its evaluator before runner.run
    tight = M.apply_tighten(M.default_slos("loadgen"),
                            ["loadgen-fast-ttft=0.99@1"])
    ev2 = M.SLOEvaluator(runner.registry, tight)
    t0 = time.monotonic()
    runner.run([{"t": 0.0,
                 "messages": [{"role": "user", "content": "x"}]}] * 5,
               speed=1e6)
    lines = []
    verdict = M.slo_epilogue(evaluator, since_t=t0 - 1,
                             out=lines.append)
    assert verdict["pass"] is True
    assert any("PASS" in ln for ln in lines)
    verdict2 = M.slo_epilogue(ev2, since_t=t0 - 1, out=lines.append)
    assert verdict2["pass"] is False
    assert "loadgen-fast-ttft" in verdict2["violations"][0]
    assert "0.99" in verdict2["violations"][0]


def test_apply_tighten_validates(pkg):
    with pytest.raises(ValueError, match="no such SLO"):
        M.apply_tighten(M.default_slos("loadgen"), ["nope=0.5"])
    with pytest.raises(ValueError, match="NAME=OBJECTIVE"):
        M.apply_tighten(M.default_slos("loadgen"), ["bare"])
    # objective 1.0 must be a clean validation error, not a
    # ZeroDivisionError later in the epilogue
    with pytest.raises(ValueError, match="error budget"):
        M.apply_tighten(M.default_slos("loadgen"), ["loadgen-availability=1.0"])


# ------------------------------------------------------- closed-loop proof

def test_replay_with_kill_and_adapter_evict_holds_availability_slo(pkg):
    """Acceptance: mid-stream replica kill + adapter eviction; the
    availability SLO stays green because gateway failover absorbs the
    faults, and the verdict comes from the same SLOEvaluator class the
    gateway's /debug/slo serves."""
    gw, engines = M.build_selftest_fleet(["tenant-a", "tenant-b"])
    try:
        model = M.WorkloadModel(requests=40, sessions=4, rps=120.0, seed=11,
                                adapters=["tenant-a", "tenant-b"])
        events = model.generate()
        mid = events[len(events) // 2]["t"]
        chaos = M.ChaosInjector(
            [{"t": mid, "op": "kill", "replica": "replica-1"},
             {"t": mid, "op": "adapter_unload", "adapter": "tenant-b"}],
            {"kill": lambda op: [setattr(e, "fail", True)
                                 for e in engines
                                 if e.name == op["replica"]] and {"ok": 1},
             "adapter_unload": lambda op: {
                 "unloaded": [e.unload_adapter(op["adapter"])
                              for e in engines]}})
        runner = M.ReplayRunner(M.LocalClient(gw), max_inflight=8)
        evaluator = M.SLOEvaluator(runner.registry, M.default_slos("loadgen"))
        t0 = time.monotonic()
        report = runner.run(events, chaos=chaos)
        assert report["requests"] == 40
        killed = [e for e in report["chaos"] if e["op"] == "kill"]
        assert killed and killed[0]["ok"] is True
        # the kill may surface as a handful of failovers, never as an
        # availability breach: the SLO tolerates 1% server-side errors
        verdict = M.slo_epilogue(evaluator, since_t=t0 - 1,
                                 out=lambda s: None)
        avail = next(v for v in verdict["verdicts"]
                     if v["name"] == "loadgen-availability")
        assert avail["compliant"] is True, verdict
        # same code path the gateway serves at /debug/slo
        assert isinstance(evaluator, type(gw.slo))
        assert gw.slo_report()["plane"] == "gateway"
    finally:
        gw.close()


def test_replay_cli_selftest_pass_and_tightened_detection(pkg, tmp_path, capsys):
    """The CI smoke contract, driven through the real CLI entry: healthy
    selftest exits 0 (with the drain chaos op fired); a deliberately
    tightened objective exits 1 and NAMES the objective."""
    report_path = tmp_path / "report.json"
    rc = M.replay_main(["--selftest", "--requests", "16", "--rps", "80",
                        "--report_json", str(report_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SLO verdict: PASS" in out
    assert "drain" in out  # the injected chaos op is visible in the log
    report = json.loads(report_path.read_text())
    assert report["slo"]["pass"] is True
    assert report["requests"] == 16

    rc = M.replay_main(["--selftest", "--requests", "12", "--rps", "80",
                        "--tighten", "loadgen-fast-ttft=0.999@0.001"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "SLO loadgen-fast-ttft violated" in out
    assert "0.999" in out


def test_replay_cli_record_then_replay_trace(pkg, tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    rc = M.replay_main(["--record", str(trace), "--requests", "8",
                        "--rps", "100", "--seed", "5"])
    assert rc == 0 and trace.exists()
    rc = M.replay_main(["--selftest", "--trace", str(trace)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "trace " in out and "SLO verdict: PASS" in out


def test_chaos_ops_past_replay_end_logged_as_skipped(pkg):
    """An op scheduled after the traffic ends must appear in the report as
    skipped — a clean verdict next to a half-run schedule would lie."""
    fired = []
    inj = M.ChaosInjector(
        [{"t": 0.0, "op": "drain"}, {"t": 60.0, "op": "kill", "replica": "r0"}],
        {"drain": lambda op: fired.append("drain") or {"ok": 1},
         "kill": lambda op: fired.append("kill")})
    inj.start(speed=1.0)
    time.sleep(0.1)
    inj.stop()
    assert fired == ["drain"]
    log = inj.report()
    assert [e["op"] for e in log] == ["drain", "kill"]
    missed = log[1]
    assert missed["ok"] is None and "replay ended" in missed["detail"]
    assert missed["args"] == {"replica": "r0"}


# ------------------------------------------------------- across packages

def _both(name):
    return [getattr(_mod(p, mod), attr) for p in PKGS
            for mod, attr in [M.names[name].split(":")]]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("kw", [
    dict(requests=60, sessions=5, seed=3, adapters=["t-a", "t-b", "t-c"]),
    dict(requests=40, sessions=6, rps=25.0, seed=0),
    dict(requests=32, sessions=3, seed=9, adapters=["x"], base_every=0,
         temperature=0.0),
    dict(requests=24, sessions=4, seed=5,
         tenants={"plat": {"adapters": ["tenant-a"], "weight": 1.0},
                  "batch": {"adapters": ["tenant-b"], "weight": 4.0}}),
])
def test_workloads_from_one_seed_are_equal(kw):
    ref, port = (cls(**kw) for cls in _both("WorkloadModel"))
    a, b = ref.generate(), port.generate()
    assert len(a) == len(b) == kw["requests"]
    for ea, eb in zip(a, b):
        assert ea == eb
    assert ref.meta() == port.meta()


@pytest.mark.parametrize("writer", PKGS)
def test_a_trace_crosses_between_the_packages(tmp_path, writer):
    reader = next(p for p in PKGS if p != writer)
    model = _mod(writer, "loadgen.workload").WorkloadModel(
        requests=16, sessions=3, seed=2, adapters=["t-a", "t-b"])
    events = model.generate()
    path = str(tmp_path / "trace.jsonl")
    _mod(writer, "loadgen.workload").write_trace(path, events, model.meta())
    meta, back = _mod(reader, "loadgen.workload").read_trace(path)
    assert back == events and meta == _mod(
        writer, "loadgen.workload").read_trace(path)[0]
    summary = [_mod(p, "loadgen.workload").summarize(back) for p in PKGS]
    assert summary[0] == summary[1]


def _verdicts(report):
    return ([(v["name"], v["compliant"], v["total"], v["no_data"])
             for v in report["slo"]["verdicts"]],
            report["slo"]["pass"],
            [v.split(":")[0] for v in report["slo"]["violations"]])


def test_selftest_gives_the_same_slo_verdicts(tmp_path, capsys):
    """The CI smoke over each package's gateway: a healthy run passes and
    a tightened objective fails, with the same verdicts on both."""
    got = {}
    for pkg_ in PKGS:
        main = _mod(pkg_, "loadgen.replay").main
        for label, extra, want_rc in (
                ("ok", [], 0),
                ("tight", ["--tighten", "loadgen-fast-ttft=0.999@0.001"],
                 1)):
            path = tmp_path / f"{pkg_}-{label}.json"
            rc = main(["--selftest", "--requests", "12", "--rps", "80",
                       "--report_json", str(path), *extra])
            out = capsys.readouterr().out
            assert rc == want_rc, out
            got[pkg_, label] = json.loads(path.read_text())
    for label in ("ok", "tight"):
        ref, port = (got[p, label] for p in PKGS)
        assert _verdicts(ref) == _verdicts(port)
        assert ref["requests"] == port["requests"] == 12
        assert ref["codes"] == port["codes"]
    assert _verdicts(got[PKGS[1], "tight"])[2] == [
        "SLO loadgen-fast-ttft violated"]


def test_the_port_report_adds_its_p90s_and_no_content_count():
    reports = []
    for pkg_ in PKGS:
        runner = _mod(pkg_, "loadgen.replay").ReplayRunner(_StubClient())
        reports.append(runner.run(
            [{"t": 0.0, "messages": [{"role": "user", "content": "a"}]},
             {"t": 0.0, "messages": [{"role": "user", "content": "b"}],
              "fail": True}], speed=100.0))
    ref, port = reports
    assert set(port) - set(ref) == {"ttft_ms_p90", "latency_ms_p90",
                                    "no_content"}
    assert {k: port[k] for k in ref if "latency" not in k
            and k not in ("duration_s", "rps_achieved")} == {
        k: ref[k] for k in ref if "latency" not in k
        and k not in ("duration_s", "rps_achieved")}
    assert port["ttft_ms_p90"] == 20.0 and port["no_content"] == 1


def test_dtx_san_installs_and_sweeps_the_ports_sanitizers(monkeypatch,
                                                          capsys, tmp_path):
    """``DTX_SAN=lock,thread`` wraps a replay in the port's sanitizers, as
    the reference's replay does: installed before the fleet is built,
    swept at the end (lock-order cycles, threads the fleet left behind),
    reported under the baseline contract, and taken out again so the
    process gets its ``threading.Lock`` back."""
    import threading

    from datatunerx_tpu_torch.analysis.sanitizers import runtime
    from datatunerx_tpu_torch.analysis.sanitizers.lockorder import (
        LOCK_SANITIZER,
    )
    from datatunerx_tpu_torch.cli import main as cli_main
    from datatunerx_tpu_torch.loadgen import replay

    seen = {}
    real_main = replay._replay_main

    def spy(argv):
        seen["active"] = runtime.active_classes()
        seen["lock"] = threading.Lock
        return real_main(argv)

    monkeypatch.setattr(replay, "_replay_main", spy)
    monkeypatch.setattr(runtime, "COLLECTOR", runtime.Collector())
    # under ``dtx-torch san`` the plugin has installed them already: the
    # replay must then leave them as it found them
    active_before = runtime.active_classes()
    enabled_before = LOCK_SANITIZER.enabled
    lock_before = threading.Lock
    raw = tmp_path / "san.json"
    monkeypatch.setenv("DTX_SAN", "lock,thread")
    monkeypatch.setenv("DTX_SAN_REPORT", str(raw))
    for run in (lambda: replay.main(["--selftest", "--requests", "4"]),
                lambda: cli_main(["replay", "--selftest", "--requests",
                                  "4"])):
        assert run() == 0
        assert {"lock", "thread"} <= set(seen["active"])
        assert seen["lock"] is not lock_before or enabled_before
        out = capsys.readouterr().out
        assert "SLO verdict: PASS" in out
        assert "[replay] dtxsan: 0 findings" in out
        doc = json.loads(raw.read_text())
        assert doc["kind"] == "dtxsan-raw" and doc["findings"] == []
        assert {"lock", "thread"} <= set(doc["classes"])
        assert runtime.active_classes() == active_before
        assert threading.Lock is lock_before
        assert LOCK_SANITIZER.enabled == enabled_before
    monkeypatch.setenv("DTX_SAN", "0")  # the reference's "off" values
    monkeypatch.delenv("DTX_SAN_REPORT")
    raw.unlink()
    assert replay.main(["--record", "/dev/null", "--requests", "2"]) == 0
    assert "dtxsan" not in capsys.readouterr().out and not raw.exists()


def test_cli_dispatches_replay_before_argparse(tmp_path, capsys):
    from datatunerx_tpu_torch.cli import main as cli_main

    trace = tmp_path / "t.jsonl"
    rc = cli_main(["--server", "http://x:1", "replay", "--record",
                   str(trace), "--requests", "5", "--seed", "7"])
    assert rc == 0 and trace.exists()
    meta, events = _mod(PKGS[0], "loadgen.workload").read_trace(str(trace))
    assert len(events) == 5 and meta["seed"] == 7
    assert "trace recorded" in capsys.readouterr().out


def test_chip_smoke_replay_phase_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 17 at ``preset:debug`` with ``--device
    cpu``: ``dtx-torch replay`` as a subprocess against a port server,
    then its recorded trace through two port gateways over it (block-priced
    admission, whose 429s are counted; a static budget of the trace's
    estimate, every request 200), each run's 200s counted by the server's
    ``/metrics``."""
    import importlib.util
    import os

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_replay",
        os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.loadgen_phase(
        torch, str(tmp_path), [], "cpu", model="preset:debug",
        flags=("--kv_block_size", "16", "--slots", "4", "--max_seq_len",
               "256", "--device", "cpu"))
    assert set(out) == {"direct", "gateway-blocks", "gateway"}
