"""The port's SLO plane (``datatunerx_tpu_torch/obs/slo.py``) held against
the JAX package's: the same registry operations, samples and explicit
``now`` give equal ``evaluate()`` results (windowed compliance, multi-window
burn rate, counter-reset clamping), equal ``verdicts()``, ``report()`` and
restated ``dtx_slo_*`` gauges (byte-equal exposition); parsing, defaults and
``violations`` agree, errors included; and the background sampler starts
and stops. Every comparison is exact; no tolerance applies."""

import json
import time

import pytest

from datatunerx_tpu.obs import metrics as jm
from datatunerx_tpu.obs import slo as js
from datatunerx_tpu_torch.obs import metrics as tm
from datatunerx_tpu_torch.obs import slo as ts

SPECS = [
    {"name": "ttft-p95", "objective": 0.95, "windows_s": [300, 60],
     "sli": {"kind": "latency", "metric": "dtx_serving_ttft_ms",
             "threshold_ms": 240}},
    {"name": "avail", "objective": 0.99, "description": "non-5xx",
     "sli": {"kind": "error_ratio", "metric": "dtx_serving_requests_total",
             "bad": {"code": "^5"}}},
    {"name": "chat-avail", "objective": 0.9,
     "sli": {"kind": "error_ratio", "metric": "dtx_serving_requests_total",
             "bad": {"code": "^5"}, "match": {"route": "chat"}}},
    {"name": "absent", "objective": 0.5,
     "sli": {"kind": "latency", "metric": "dtx_nothing_ms",
             "threshold": 10}},
]

# (time, ttft observations, request-count increments by (code, route));
# at t=400 the counter restarts lower (a swapped engine): the deltas clamp
SCRIPT = [
    (10.0, [20.0, 300.0, 90.0], [("200", "chat", 5), ("503", "chat", 1)]),
    (70.0, [1000.0] * 4, [("200", "perplexity", 3), ("500", "chat", 2)]),
    (200.0, [10.0] * 12, [("200", "chat", 20)]),
    (400.0, [260.0, 5.0], "reset"),
    (460.0, [15.0], [("200", "chat", 4), ("502", "perplexity", 1)]),
]


def _run(mod_m, mod_s, monkeypatch):
    clock = iter(x / 4 for x in range(10_000))
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    reg = mod_m.Registry()
    hist = mod_m.serving_latency_histograms(reg)[0]
    reqs = reg.counter("dtx_serving_requests_total", "Requests.")
    ev = mod_s.SLOEvaluator(reg, mod_s.parse_slos(SPECS))
    out = []
    for t, obs, incs in SCRIPT:
        for v in obs:
            hist.observe(v)
        if incs == "reset":
            reqs.replace([({"code": "200", "route": "chat"}, 1.0)])
        else:
            for code, route, n in incs:
                reqs.inc({"code": code, "route": route}, by=n)
        ev.sample(now=t)
        res = ev.evaluate(now=t + 5.0)
        ev.restate_gauges(res)
        out.append((res, reg.expose()))
    out.append(ev.verdicts())
    out.append(ev.verdicts(since_t=200.0))
    out.append(ev.report(plane="serving"))
    ev.restate_gauges()
    out.append(reg.expose())
    return out


def test_evaluations_reports_and_gauges_equal(monkeypatch):
    want = _run(jm, js, monkeypatch)
    got = _run(tm, ts, monkeypatch)
    assert got == want
    # the script reached what it is meant to: a breach, a clamp, no data
    by_name = {d["name"]: d for d in got[1][0]}
    assert by_name["ttft-p95"]["compliant"] is False
    assert by_name["absent"]["no_data"] is True
    assert all(w["total"] >= 0 for d in got[3][0] for w in d["windows"])
    assert "dtx_slo_burn_rate{" in got[-1]


def test_parsing_and_defaults_equal(tmp_path):
    for plane in ("serving", "gateway", "training"):
        try:
            want = js.default_slos(plane)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                ts.default_slos(plane)
            continue
        assert [vars(s) for s in ts.default_slos(plane)] == \
            [vars(s) for s in want]
    path = tmp_path / "slos.json"
    path.write_text(json.dumps({"slos": SPECS}))
    for src in (str(path), json.dumps(SPECS), " " + json.dumps(SPECS)):
        assert [vars(s) for s in ts.load_slos(src)] == \
            [vars(s) for s in js.load_slos(src)]
    bad = [
        [], {"slos": []}, [{"name": "x y", "objective": 0.9}],
        [{"name": "x", "objective": 1.0, "sli": {}}],
        [{"name": "x", "objective": "a"}],
        [{"name": "x", "objective": 0.9, "sli": {"kind": "latency",
                                                 "metric": "m"}}],
        [{"name": "x", "objective": 0.9, "sli": {"kind": "error_ratio",
                                                 "metric": "m"}}],
        [{"name": "x", "objective": 0.9, "sli": {"kind": "other",
                                                 "metric": "m"}}],
        [{"name": "x", "objective": 0.9, "windows_s": [-1],
          "sli": {"kind": "latency", "metric": "m", "threshold": 1}}],
        SPECS[:1] * 2,
    ]
    for doc in bad:
        with pytest.raises(ValueError) as jerr:
            js.parse_slos(doc)
        with pytest.raises(ValueError) as terr:
            ts.parse_slos(doc)
        assert str(terr.value) == str(jerr.value)


def test_violations_and_window_formula_equal():
    verdicts = [
        {"name": "a", "compliant": False, "compliance": 0.5,
         "objective": 0.9, "window_s": 60.0, "good": 5, "total": 10,
         "burn_rate": 5.0, "no_data": False},
        {"name": "b", "compliant": True, "compliance": 1.0,
         "objective": 0.9, "window_s": 60.0, "good": 3, "total": 3,
         "burn_rate": 0.0, "no_data": False},
        {"name": "c", "compliant": True, "compliance": None,
         "objective": 0.9, "window_s": 60.0, "good": 0, "total": 0,
         "burn_rate": None, "no_data": True},
    ]
    assert ts.violations(verdicts) == js.violations(verdicts)
    for good, total, obj in ((0, 0, 0.9), (9, 10, 0.9), (1, 3, 0.5),
                             (99, 100, 0.999)):
        assert (ts.evaluate_window(good, total, obj)
                == js.evaluate_window(good, total, obj))


def test_background_sampler_starts_and_stops():
    reg = tm.Registry()
    ev = ts.SLOEvaluator(reg, ts.default_slos("serving"))
    n0 = len(ev._samples)
    ev.start(0.02)
    sampler = ev._thread
    ev.start(0.02)  # idempotent: one thread
    assert ev._thread is sampler and sampler.name == "dtx-slo-sampler"
    assert sampler.is_alive()
    deadline = time.monotonic() + 10
    while len(ev._samples) < n0 + 3:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    ev.stop()
    assert ev._thread is None and not sampler.is_alive()
