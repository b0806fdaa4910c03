"""Replay a workload trace at a gateway and judge the run with SLOs.

The runner fires trace events at their recorded offsets (speed-scalable),
streams every response to measure client-side TTFT, records outcomes into
a private obs Registry (``dtx_loadgen_requests_total{code}``,
``dtx_loadgen_ttft_ms`` / ``dtx_loadgen_latency_ms`` histograms with
trace-id exemplars), and ends with an SLO epilogue: the same
``obs/slo.py`` evaluator the gateway's ``GET /debug/slo`` serves judges
the replay's own registry, and the process exits nonzero NAMING any
violated objective. A chaos injector (loadgen/chaos.py) runs alongside,
so the verdict is "the SLOs held *through* the faults", not "on a quiet
fleet".

Two clients:

  HTTPClient   — a real gateway URL (SSE streaming, trace-id header).
  LocalClient  — an in-process ``Gateway`` object: the test/CI/bench path
                 (``--selftest``), where chaos can also
                 reach surfaces that have no wire form (replica kill,
                 slice-pool shrink) via injected actions.

The port's copy of ``datatunerx_tpu/loadgen/replay.py``. ``DTX_SAN`` is
refused: the runtime sanitizers are the reference's ``analysis/``, which
the port does not carry.

CLI (``dtx-torch replay`` / ``python -m datatunerx_tpu_torch.loadgen.replay``):

  dtx-torch replay --url http://gw:8000 --requests 200 --rps 50 \\
      --chaos chaos.json --slo slos.json --report_json out.json
  dtx-torch replay --record trace.jsonl --requests 500   # generate only
  dtx-torch replay --url ... --trace trace.jsonl     # replay a recording
  dtx-torch replay --selftest                        # 2-replica in-process
                                                     # fleet + drain chaos
  dtx-torch replay --selftest --tighten loadgen-fast-ttft=0.999@0.001
                                                     # prove detection: the
                                                     # tightened objective
                                                     # must exit nonzero
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import List, Optional

from datatunerx_tpu_torch.obs.metrics import (
    MS_BUCKETS,
    Registry,
    sample_percentile,
)
from datatunerx_tpu_torch.obs.slo import (
    SLO,
    SLOEvaluator,
    default_slos,
    load_slos,
    violations,
)
from datatunerx_tpu_torch.loadgen.chaos import ChaosInjector, load_chaos
from datatunerx_tpu_torch.loadgen.workload import (
    WorkloadModel,
    read_trace,
    summarize,
    write_trace,
)


# ------------------------------------------------------------------- clients

class HTTPClient:
    """Streams POST /chat/completions against a gateway/serving URL."""

    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def send(self, event: dict, trace_id: str) -> dict:
        payload = {"messages": event["messages"],
                   "max_tokens": event.get("max_tokens", 32),
                   "temperature": event.get("temperature", 0.0),
                   "stream": True}
        if event.get("model"):
            payload["model"] = event["model"]
        headers = {"Content-Type": "application/json",
                   "X-DTX-Trace-Id": trace_id,
                   "X-DTX-Session-Id": event.get("session") or ""}
        if event.get("tenant"):
            headers["X-DTX-Tenant"] = event["tenant"]
        req = urllib.request.Request(
            self.base_url + "/chat/completions",
            data=json.dumps(payload).encode(),
            headers=headers,
            method="POST")
        t0 = time.perf_counter()
        ttft = None
        chars = 0
        code = 200
        error = None
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                for raw in r:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        break
                    evt = json.loads(data)
                    if "error" in evt:
                        code, error = 500, str(evt["error"].get("message"))
                        break
                    delta = evt["choices"][0]["delta"].get("content")
                    if delta:
                        if ttft is None:
                            ttft = time.perf_counter() - t0
                        chars += len(delta)
        except urllib.error.HTTPError as e:
            code, error = e.code, str(e.reason)
        except Exception as e:  # noqa: BLE001 — a dead gateway IS the data
            code, error = 503, str(e)
        return {"code": code, "error": error, "chars": chars,
                "ttft_ms": None if ttft is None else ttft * 1e3,
                "latency_ms": (time.perf_counter() - t0) * 1e3}


class LocalClient:
    """Drives an in-process ``gateway.server.Gateway`` — same outcome
    classification the HTTP handler would produce, without sockets."""

    def __init__(self, gateway):
        self.gateway = gateway

    def send(self, event: dict, trace_id: str) -> dict:
        from datatunerx_tpu_torch.gateway.admission import Overloaded
        from datatunerx_tpu_torch.gateway.replica_pool import (
            NoReplicaAvailable,
            ReplicaError,
        )

        req = {"messages": event["messages"],
               "max_tokens": event.get("max_tokens", 32),
               "temperature": event.get("temperature", 0.0)}
        if event.get("model"):
            req["model"] = event["model"]
        t0 = time.perf_counter()
        ttft = None
        chars = 0
        code = 200
        error = None
        try:
            for delta in self.gateway.chat_stream(
                    req, trace_id=trace_id,
                    session_id=event.get("session"),
                    tenant=event.get("tenant") or ""):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                chars += len(delta)
        except Overloaded as e:
            code, error = 429, str(e.reason)
        except ValueError as e:
            code, error = 400, str(e)
        except NoReplicaAvailable as e:
            code, error = 503, str(e)
        except ReplicaError as e:
            code, error = 502, str(e)
        except Exception as e:  # noqa: BLE001
            code, error = 500, str(e)
        return {"code": code, "error": error, "chars": chars,
                "ttft_ms": None if ttft is None else ttft * 1e3,
                "latency_ms": (time.perf_counter() - t0) * 1e3}


# -------------------------------------------------------------------- runner

class ReplayRunner:
    """Fires events at their trace offsets, bounded-concurrency, and
    aggregates outcomes into ``registry`` + a summary report."""

    def __init__(self, client, registry: Optional[Registry] = None,
                 max_inflight: int = 32):
        self.client = client
        self.registry = registry if registry is not None else Registry()
        self.max_inflight = max(1, max_inflight)
        self._requests = self.registry.counter(
            "dtx_loadgen_requests_total",
            "Replayed requests by terminal code as the client saw them.")
        self._ttft = self.registry.histogram(
            "dtx_loadgen_ttft_ms",
            "Client-observed time to first streamed delta.",
            buckets=MS_BUCKETS)
        self._latency = self.registry.histogram(
            "dtx_loadgen_latency_ms",
            "Client-observed end-to-end request latency.",
            buckets=MS_BUCKETS)
        self._lock = threading.Lock()
        self.results: List[dict] = []

    def _one(self, event: dict, sem: threading.Semaphore):
        trace_id = f"dtx-load-{uuid.uuid4().hex[:12]}"
        try:
            out = self.client.send(event, trace_id)
            out["trace_id"] = trace_id
            out["session"] = event.get("session")
            if event.get("tenant"):
                out["tenant"] = event["tenant"]
            self._requests.inc({"code": str(out["code"])})
            if out["ttft_ms"] is not None:
                self._ttft.observe(out["ttft_ms"], trace_id=trace_id)
            self._latency.observe(out["latency_ms"], trace_id=trace_id)
            with self._lock:
                self.results.append(out)
        finally:
            sem.release()

    def run(self, events: List[dict], speed: float = 1.0,
            chaos: Optional[ChaosInjector] = None,
            join_timeout_s: float = 600.0) -> dict:
        speed = max(speed, 1e-9)
        sem = threading.Semaphore(self.max_inflight)
        threads: List[threading.Thread] = []
        if chaos is not None:
            chaos.start(speed)
        t0 = time.monotonic()
        for ev in events:
            delay = ev["t"] / speed - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            sem.acquire()  # backpressure: at most max_inflight in the air
            th = threading.Thread(target=self._one, args=(ev, sem),
                                  daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=join_timeout_s)
        if chaos is not None:
            chaos.stop()
        duration = time.monotonic() - t0
        return self._report(duration, chaos)

    def _report(self, duration_s: float,
                chaos: Optional[ChaosInjector]) -> dict:
        with self._lock:
            results = list(self.results)
        ttfts = [r["ttft_ms"] for r in results if r["ttft_ms"] is not None]
        lats = [r["latency_ms"] for r in results]
        codes: dict = {}
        for r in results:
            codes[str(r["code"])] = codes.get(str(r["code"]), 0) + 1
        errors = sum(1 for r in results if r["code"] >= 500)
        rep = {
            "requests": len(results),
            "errors": errors,
            "codes": codes,
            "duration_s": round(duration_s, 3),
            "rps_achieved": round(len(results) / duration_s, 2)
            if duration_s > 0 else 0.0,
            "ttft_ms_p50": round(sample_percentile(ttfts, 0.5), 2),
            "ttft_ms_p95": round(sample_percentile(ttfts, 0.95), 2),
            "ttft_ms_p99": round(sample_percentile(ttfts, 0.99), 2),
            "latency_ms_p50": round(sample_percentile(lats, 0.5), 2),
            "latency_ms_p95": round(sample_percentile(lats, 0.95), 2),
            "latency_ms_p99": round(sample_percentile(lats, 0.99), 2),
            # the port's additions: the p90s, and the requests whose stream
            # carried no content (no first-token time to measure)
            "ttft_ms_p90": round(sample_percentile(ttfts, 0.9), 2),
            "latency_ms_p90": round(sample_percentile(lats, 0.9), 2),
            "no_content": len(results) - len(ttfts),
        }
        by_tenant: dict = {}
        for r in results:
            if r.get("tenant"):
                by_tenant.setdefault(r["tenant"], []).append(r)
        if by_tenant:
            # per-tenant QoS breakdown — the isolation evidence: a pinned
            # tenant's tail must hold while a bulk tenant gets shed
            rep["tenants"] = {}
            for name in sorted(by_tenant):
                rs = by_tenant[name]
                tt = [r["ttft_ms"] for r in rs if r["ttft_ms"] is not None]
                lat = [r["latency_ms"] for r in rs
                       if r.get("latency_ms") is not None]
                rep["tenants"][name] = {
                    "requests": len(rs),
                    "ok": sum(1 for r in rs if r["code"] < 400),
                    "shed": sum(1 for r in rs if r["code"] == 429),
                    "errors": sum(1 for r in rs if r["code"] >= 500),
                    "ttft_ms_p95": round(sample_percentile(tt, 0.95), 2),
                    # empty completions (tiny models sampling EOS first)
                    # leave ttft None; latency is always measured, so
                    # consumers can fall back to it
                    "latency_ms_p95": round(sample_percentile(lat, 0.95), 2),
                }
        if chaos is not None:
            rep["chaos"] = chaos.report()
        return rep


# ------------------------------------------------------------- SLO epilogue

def slo_epilogue(evaluator: SLOEvaluator, since_t: float,
                 out=print) -> dict:
    """Judge the run and SAY SO: one line per objective, violations named.
    Returns {"pass": bool, "violations": [...], "verdicts": [...]} — the
    CLI exits 1 when ``pass`` is False."""
    verdicts = evaluator.verdicts(since_t=since_t)
    broken = violations(verdicts)
    for v in verdicts:
        if v["no_data"]:
            out(f"[slo] {v['name']}: no events — vacuously compliant")
            continue
        rel = ">=" if v["compliant"] else "<"
        out(f"[slo] {v['name']}: compliance {v['compliance']:.4f} {rel} "
            f"objective {v['objective']:g} over {v['total']} events "
            f"({'OK' if v['compliant'] else 'VIOLATED'})")
    for line in broken:
        out(f"[slo] {line}")
    out(f"[replay] SLO verdict: "
        + ("PASS" if not broken else f"FAIL ({len(broken)} violated)"))
    return {"pass": not broken, "violations": broken, "verdicts": verdicts}


# ----------------------------------------------------------- selftest fleet

class _FakeEngine:
    """A serving-engine stand-in for the self-test fleet: streams a few
    deltas with a small per-token delay, supports adapter names, an
    injectable mid-stream fault, AND the KV-migration surface
    (export_sessions / import_session / resume_stream with the real
    engines' duck-typed contract) — enough for routing, failover, drain
    handoff and adapter-evict chaos without loading a model."""

    def __init__(self, name: str, delay_s: float = 0.002,
                 adapters: Optional[List[str]] = None,
                 prefill_steps: int = 0):
        from datatunerx_tpu_torch.obs.trace import TraceStore

        self.name = name
        self.delay_s = delay_s
        # chunked-prefill stand-in: each session burns this many silent
        # steps (no deltas) before its first token — a drain that lands
        # inside them exercises the mid-prefill export/import tail path
        self.prefill_steps = max(0, int(prefill_steps))
        self.mid_prefill_imports = 0
        self.fail = False
        self.adapter_ids = {"": 0}
        for i, a in enumerate(adapters or []):
            self.adapter_ids[a] = i + 1
        self.resident_adapters = {a for a in self.adapter_ids if a}
        self.slots = 4
        self._slot_req = [None] * 4
        # a real (tiny) trace store so InProcessReplica forwards trace ids
        # — the handoff buffer is keyed by them
        self.trace_store = TraceStore(capacity=64)
        self._lock = threading.Lock()
        self._live: dict = {}

    def unload_adapter(self, name: str) -> bool:
        present = name in self.resident_adapters
        self.resident_adapters.discard(name)
        return present

    def chat_stream(self, messages, max_new_tokens: int = 16,
                    trace_id: str = "", **kw):
        if self.fail:
            raise RuntimeError(f"{self.name}: injected fault")
        n = max(1, min(int(max_new_tokens), 8))
        sess = {"trace_id": trace_id, "total": n, "emitted": 0,
                "migrate": False, "adapter": kw.get("adapter", ""),
                "prefill_done": 0, "prefill_total": self.prefill_steps}
        if trace_id:
            with self._lock:
                self._live[trace_id] = sess
        try:
            while sess["prefill_done"] < sess["prefill_total"]:
                time.sleep(self.delay_s)
                if sess["migrate"]:
                    raise RuntimeError(
                        f"session migrated off {self.name}")
                sess["prefill_done"] += 1
            for i in range(n):
                time.sleep(self.delay_s)
                if self.fail and i > 0:
                    raise RuntimeError(f"{self.name}: killed mid-stream")
                if sess["migrate"]:
                    # same marker literal the real engine dies with
                    # (gateway/replica_pool.MIGRATED_MARKER)
                    raise RuntimeError(
                        f"session migrated off {self.name}")
                sess["emitted"] += 1
                yield "tok "
        finally:
            if trace_id:
                with self._lock:
                    self._live.pop(trace_id, None)

    def chat(self, messages, **kw):
        return "".join(self.chat_stream(messages, **kw))

    # ------------------------------------------ KV migration (fake twin)
    def export_sessions(self, slots=None, wire_quant=None,
                        include_prefill: bool = False) -> dict:
        with self._lock:
            live = list(self._live.values())
        sessions = []
        skipped = []
        for sess in live:
            mid_prefill = sess["prefill_done"] < sess["prefill_total"]
            if mid_prefill and not include_prefill:
                # real-engine contract: mid-prefill sessions only ship
                # when the caller asks for tails (the drain path)
                skipped.append(sess["trace_id"])
                continue
            sess["migrate"] = True  # the stream dies with the marker
            sessions.append({"fake": True, "trace_id": sess["trace_id"],
                             "emitted": int(sess["emitted"]),
                             "total": int(sess["total"]),
                             "adapter": sess["adapter"],
                             "prefill_done": int(sess["prefill_done"]),
                             "prefill_total": int(sess["prefill_total"])})
        return {"sessions": sessions, "skipped": skipped}

    def import_session(self, payload: dict) -> dict:
        if not payload.get("fake"):
            raise ValueError("foreign session payload")
        adapter = payload.get("adapter") or ""
        if adapter and adapter not in self.adapter_ids:
            raise ValueError(f"unknown adapter {adapter!r}")
        emitted = int(payload["emitted"])
        pf_done = int(payload.get("prefill_done") or 0)
        pf_total = int(payload.get("prefill_total") or 0)
        if pf_done < pf_total:
            self.mid_prefill_imports += 1
        handle = {"remaining": max(0, int(payload["total"]) - emitted),
                  # resume the prompt where the source stopped — the done
                  # part is NOT redone (the zero-re-prefill contract)
                  "prefill_remaining": max(0, pf_total - pf_done)}
        return {"session": payload.get("trace_id"), "tokens": emitted,
                "text_so_far": "tok " * emitted, "_request": handle}

    def resume_stream(self, handle: dict):
        for _ in range(handle.get("prefill_remaining", 0)):
            time.sleep(self.delay_s)
            if self.fail:
                raise RuntimeError(f"{self.name}: killed mid-resume")
        for _ in range(handle["remaining"]):
            time.sleep(self.delay_s)
            if self.fail:
                raise RuntimeError(f"{self.name}: killed mid-resume")
            yield "tok "

    def healthy(self) -> bool:
        return not self.fail


#: the two-tier tenant selftest: a pinned tenant with a TTFT objective
#: and a bulk tenant whose KV-block quota is deliberately tight, so the
#: bulk flood sheds at admission instead of queueing in front of the
#: pinned tenant's traffic.
SELFTEST_TENANTS = {
    "plat": {"tier": "pinned", "adapters": ["tenant-a"], "share": 8.0,
             "ttft_p95_ms": 500.0},
    "batch": {"tier": "bulk", "adapters": ["tenant-b"], "share": 1.0,
              "kv_block_quota": 8},
}

#: the matching workload mix: the bulk tenant arrives 4x as often — the
#: overload is the experiment, the pinned tenant's p95 is the verdict
SELFTEST_TENANT_MIX = {
    "plat": {"adapters": ["tenant-a"], "weight": 1.0},
    "batch": {"adapters": ["tenant-b"], "weight": 4.0},
}


def build_selftest_fleet(adapters: Optional[List[str]] = None,
                         session_handoff: bool = True,
                         delay_s: float = 0.002,
                         roles: Optional[List[str]] = None,
                         prefill_steps: int = 0,
                         tenants: Optional[dict] = None):
    """2 in-process fake replicas behind a real Gateway — the CI smoke
    fleet. Returns (gateway, engines). ``roles`` assigns disaggregation
    roles by replica index and turns the fleet handoff plane on, so a
    drain ships mid-prefill tails instead of skipping them. ``tenants``
    turns the multi-tenant QoS plane on (directory config, tenancy/)."""
    from datatunerx_tpu_torch.gateway.replica_pool import (
        InProcessReplica,
        ReplicaPool,
    )
    from datatunerx_tpu_torch.gateway.server import Gateway

    adapters = adapters if adapters is not None else ["tenant-a", "tenant-b"]
    roles = roles or []
    engines = [_FakeEngine(f"replica-{i}", delay_s=delay_s,
                           adapters=adapters, prefill_steps=prefill_steps)
               for i in range(2)]
    pool = ReplicaPool([
        InProcessReplica(e.name, e,
                         role=roles[i] if i < len(roles) else "mixed")
        for i, e in enumerate(engines)])
    gw = Gateway(pool, model_name="selftest",
                 session_handoff=session_handoff,
                 fleet_handoff=bool(roles),
                 tenants=tenants)
    return gw, engines


def drain_when_busy(gw, name: str, wait_s: float = 3.0) -> dict:
    """Chaos action: wait (bounded) until the replica actually holds
    in-flight work, then drain it — a time-offset drain that lands on an
    idle replica proves nothing about mid-stream handoff."""
    r = gw.pool.get(name)
    deadline = time.monotonic() + wait_s
    while (r is not None and r.inflight == 0
           and time.monotonic() < deadline):
        time.sleep(0.002)
    busy = r.inflight if r is not None else None
    return {"drained": gw.drain(name), "inflight_at_drain": busy,
            "handoff": gw.last_handoff}


def selftest_chaos(gw, engines, duration_s: float,
                   drain_replica: str = "replica-1") -> ChaosInjector:
    """The default self-test schedule: one /admin/drain mid-run, fired
    when the replica is mid-stream (the drained replica stops taking
    traffic; its sessions hand off and availability must hold on the
    survivor)."""
    ops = [{"t": round(duration_s * 0.5, 3), "op": "drain",
            "replica": drain_replica}]
    actions = {
        "drain": lambda op: drain_when_busy(gw, op["replica"]),
        "kill": lambda op: _kill_engine(engines, op["replica"]),
        "adapter_unload": lambda op: {
            "unloaded": [e.unload_adapter(op["adapter"])
                         for e in engines
                         if e.name == op.get("replica", e.name)]},
    }
    return ChaosInjector(ops, actions)


def _kill_engine(engines, name: str) -> dict:
    for e in engines:
        if e.name == name:
            e.fail = True
            return {"killed": name}
    raise ValueError(f"no engine {name!r}")


# ------------------------------------------------------------------ tighten

def apply_tighten(slos: List[SLO], specs: List[str]) -> List[SLO]:
    """``--tighten NAME=OBJECTIVE[@THRESHOLD]`` overrides — CI's way of
    proving the epilogue DETECTS a breach without a second config file."""
    out = list(slos)
    for spec in specs:
        name, sep, rest = spec.partition("=")
        if not sep:
            raise ValueError(f"--tighten wants NAME=OBJECTIVE, got {spec!r}")
        obj_s, _, thr_s = rest.partition("@")
        for i, slo in enumerate(out):
            if slo.name != name:
                continue
            sli = dict(slo.sli)
            if thr_s:
                if sli.get("kind") != "latency":
                    raise ValueError(
                        f"--tighten {name}: @threshold only applies to "
                        "latency SLIs")
                sli["threshold"] = float(thr_s)
            # back through from_dict, not dataclasses.replace: the
            # override must pass the same validation a config file would
            # (objective=1.0 leaves no budget to divide by — reject it
            # with a message, not a ZeroDivisionError mid-epilogue)
            try:
                objective = float(obj_s)
            except ValueError:
                raise ValueError(
                    f"--tighten {name}: objective {obj_s!r} is not a "
                    "number")
            out[i] = SLO.from_dict({
                "name": slo.name, "objective": objective, "sli": sli,
                "windows_s": list(slo.windows_s),
                "description": slo.description})
            break
        else:
            raise ValueError(
                f"--tighten {name!r}: no such SLO "
                f"(have {[s.name for s in out]})")
    return out


# ---------------------------------------------------------------------- CLI

#: DTX_SAN values that ask for no sanitizer (the reference's off values)
_SAN_OFF = ("", "0", "off", "false")


def _refuse_san() -> None:
    """The reference installs its runtime sanitizers (lock order, thread
    leaks, compile budgets) when ``DTX_SAN`` asks for them. They live in
    the reference's ``analysis/`` package, which the port does not carry
    (its rules check JAX programs), so a replay that asks for them stops
    here rather than running without the checks it asked for."""
    spec = os.environ.get("DTX_SAN", "")
    if spec.strip().lower() not in _SAN_OFF:
        raise SystemExit(
            f"dtx-torch replay: DTX_SAN={spec!r} asks for the runtime "
            "sanitizers (analysis.sanitizers), which the port does not "
            "have; unset DTX_SAN to replay without them")


def main(argv=None) -> int:
    _refuse_san()
    return _replay_main(argv)


def _replay_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dtx-torch replay",
        description="trace-driven load replay + chaos harness with an SLO "
                    "epilogue (exits 1 naming any violated objective)")
    p.add_argument("--url", default="",
                   help="gateway/serving base URL to replay against")
    p.add_argument("--selftest", action="store_true",
                   help="replay against a 2-replica in-process fake fleet "
                        "with one injected /admin/drain (the CI smoke)")
    p.add_argument("--trace", default="",
                   help="replay this recorded JSONL trace instead of "
                        "generating traffic")
    p.add_argument("--from_trace_log", default="",
                   help="convert a gateway --trace_log JSONL (completed "
                        "request spans) into the replay workload: real "
                        "arrival times, adapter mix and output sizes, "
                        "synthetic prompt text (spans don't record "
                        "message content); combine with --record to save "
                        "the converted dtx-load-trace")
    p.add_argument("--record", default="",
                   help="write the generated trace here (with no --url/"
                        "--selftest: generate-and-exit)")
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--sessions", type=int, default=6)
    p.add_argument("--rps", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adapters", default="",
                   help="comma-separated adapter names the model field "
                        "churns through (selftest default: "
                        "tenant-a,tenant-b)")
    p.add_argument("--speed", type=float, default=1.0,
                   help="time-scale: 2.0 replays a trace twice as fast")
    p.add_argument("--max_inflight", type=int, default=32)
    p.add_argument("--chaos", default="",
                   help="chaos schedule: JSON file or inline JSON "
                        "(loadgen/chaos.py op format)")
    p.add_argument("--slo", default="",
                   help="SLO specs: JSON file or inline JSON (obs/slo.py "
                        "format); default: the loadgen availability + "
                        "TTFT objectives")
    p.add_argument("--tighten", action="append", default=[],
                   metavar="NAME=OBJECTIVE[@THRESHOLD]",
                   help="override an SLO's objective (and latency "
                        "threshold) — prove the epilogue detects a breach")
    p.add_argument("--handoff", choices=["on", "off"], default="on",
                   help="selftest fleet: drain hands in-flight sessions "
                        "to the surviving replica (on, default) or drops "
                        "them on today's cold re-prefill path (off)")
    p.add_argument("--expect_handoff", action="store_true",
                   help="fail (exit 1) unless the run handed off at least "
                        "one session with zero cold fallbacks and zero "
                        "5xx — the drain-mid-stream CI assertion")
    p.add_argument("--selftest_delay", type=float, default=0.002,
                   help="selftest per-token delay (raise it so a "
                        "mid-stream drain reliably catches sessions)")
    p.add_argument("--roles", default="",
                   help="selftest fleet: comma-separated disaggregation "
                        "roles by replica index (e.g. 'prefill,decode') — "
                        "turns the fleet handoff plane on and points the "
                        "default drain chaos at the first prefill replica")
    p.add_argument("--tenants", choices=["on", "off"], default="off",
                   help="selftest: turn the multi-tenant QoS plane on — a "
                        "pinned tenant (plat, TTFT objective) and a bulk "
                        "tenant (batch, tight KV-block quota) share the "
                        "fleet, with the bulk tenant arriving 4x as often")
    p.add_argument("--expect_tenant_qos", action="store_true",
                   help="fail (exit 1) unless the pinned tenant's ttft p95 "
                        "held under its objective with zero sheds/5xx "
                        "while the bulk overload was shed at admission — "
                        "the multi-tenant isolation CI assertion")
    p.add_argument("--selftest_prefill", type=int, default=0,
                   help="selftest: silent prefill steps per session before "
                        "the first token; with --roles + --expect_handoff "
                        "the drain must catch and re-home at least one "
                        "session mid-prefill with its prompt work kept")
    p.add_argument("--report_json", default="",
                   help="write the full report (results + chaos log + SLO "
                        "verdicts) to this file")
    args = p.parse_args(argv)

    adapters = [a.strip() for a in args.adapters.split(",") if a.strip()]
    if args.from_trace_log:
        from datatunerx_tpu_torch.loadgen.workload import from_trace_log

        meta, events = from_trace_log(args.from_trace_log)
        print(f"[replay] converted {args.from_trace_log}: "
              f"{summarize(events)}")
    elif args.trace:
        meta, events = read_trace(args.trace)
        print(f"[replay] trace {args.trace}: {summarize(events)}")
    else:
        model = WorkloadModel(
            requests=args.requests, sessions=args.sessions, rps=args.rps,
            seed=args.seed,
            adapters=adapters or (["tenant-a", "tenant-b"]
                                  if args.selftest else []),
            tenants=SELFTEST_TENANT_MIX if args.tenants == "on" else None)
        events = model.generate()
        meta = model.meta()
        print(f"[replay] generated workload: {summarize(events)}")
    if args.record:
        write_trace(args.record, events, meta)
        print(f"[replay] trace recorded to {args.record}")
        if not args.url and not args.selftest:
            return 0

    if not args.url and not args.selftest:
        p.error("need --url, --selftest, or --record")

    slos = load_slos(args.slo) if args.slo else default_slos("loadgen")
    try:
        slos = apply_tighten(slos, args.tighten)
    except ValueError as e:
        p.error(str(e))

    gw = engines = None
    # chaos op offsets live in TRACE time (the injector applies --speed
    # itself, like the traffic loop does)
    trace_duration = events[-1]["t"] if events else 0.0
    try:
        if args.selftest:
            roles = [r.strip() for r in args.roles.split(",") if r.strip()]
            for r in roles:
                if r not in ("prefill", "decode", "mixed"):
                    p.error(f"--roles: {r!r} is not prefill/decode/mixed")
            gw, engines = build_selftest_fleet(
                adapters or None, session_handoff=args.handoff == "on",
                delay_s=args.selftest_delay, roles=roles or None,
                prefill_steps=args.selftest_prefill,
                tenants=SELFTEST_TENANTS if args.tenants == "on" else None)
            client = LocalClient(gw)
            # with roles on, the interesting drain is the prefill
            # specialist — caught mid-prompt, its tail must ship
            drain_target = "replica-1"
            if roles and "prefill" in roles:
                drain_target = f"replica-{roles.index('prefill')}"
            default = selftest_chaos(gw, engines, trace_duration,
                                     drain_replica=drain_target)
            chaos = (ChaosInjector(load_chaos(args.chaos), default.actions)
                     if args.chaos else default)
        else:
            client = HTTPClient(args.url)
            from datatunerx_tpu_torch.loadgen.chaos import http_actions

            chaos = (ChaosInjector(load_chaos(args.chaos),
                                   http_actions(args.url))
                     if args.chaos else None)

        runner = ReplayRunner(client, max_inflight=args.max_inflight)
        evaluator = SLOEvaluator(runner.registry, slos)
        t_start = time.monotonic()
        report = runner.run(events, speed=args.speed, chaos=chaos)
        print(f"[replay] {report['requests']} requests in "
              f"{report['duration_s']}s ({report['rps_achieved']} rps) — "
              f"errors={report['errors']} codes={report['codes']}")
        print(f"[replay] ttft ms p50={report['ttft_ms_p50']} "
              f"p95={report['ttft_ms_p95']} p99={report['ttft_ms_p99']} · "
              f"latency ms p50={report['latency_ms_p50']} "
              f"p95={report['latency_ms_p95']} p99={report['latency_ms_p99']}")
        for entry in report.get("chaos") or []:
            print(f"[chaos] t={entry['t']}s {entry['op']} "
                  f"{entry['args']} ok={entry['ok']} — {entry['detail']}")
        if gw is not None:
            report["handoff"] = gw.handoff_stats()
            report["handoff_enabled"] = gw.session_handoff
            print(f"[replay] session handoff "
                  f"({'on' if gw.session_handoff else 'off'}): "
                  f"{report['handoff'] or 'no sessions moved'}")
        for name, st in sorted((report.get("tenants") or {}).items()):
            print(f"[replay] tenant {name}: {st['requests']} requests "
                  f"ok={st['ok']} shed={st['shed']} errors={st['errors']} "
                  f"ttft p95={st['ttft_ms_p95']}ms")
        verdict = slo_epilogue(evaluator, since_t=t_start - 1.0)
        report["slo"] = verdict
        report["workload"] = meta
        rc = 0 if verdict["pass"] else 1
        if args.expect_handoff:
            problems = []
            hs = report.get("handoff") or {}
            if hs.get("imported", 0) < 1:
                problems.append("no session was handed off")
            if hs.get("cold", 0):
                problems.append(f"{hs['cold']} session(s) fell back cold")
            dropped = sum(n for c, n in report["codes"].items()
                          if int(c) >= 500)
            if dropped:
                problems.append(f"{dropped} request(s) dropped (5xx)")
            if engines is not None and args.selftest_prefill > 0:
                mid = sum(e.mid_prefill_imports for e in engines)
                report["mid_prefill_imports"] = mid
                if mid < 1:
                    problems.append(
                        "no session was re-homed mid-prefill (the drain "
                        "missed the prompt phase — raise "
                        "--selftest_prefill or --selftest_delay)")
                else:
                    print(f"[replay] {mid} session(s) re-homed "
                          "mid-prefill with prompt work kept")
            for p_ in problems:
                print(f"[replay] handoff assertion FAILED: {p_}")
            if problems:
                rc = 1
            else:
                print("[replay] handoff assertion PASSED: sessions moved, "
                      "zero cold fallbacks, zero drops")
        if args.expect_tenant_qos:
            problems = []
            ts = report.get("tenants") or {}
            plat, batch = ts.get("plat") or {}, ts.get("batch") or {}
            if not plat.get("requests") or not batch.get("requests"):
                problems.append("both selftest tenants must see traffic "
                                "(run with --selftest --tenants on)")
            else:
                objective = SELFTEST_TENANTS["plat"]["ttft_p95_ms"]
                if plat.get("shed") or plat.get("errors"):
                    problems.append(
                        "pinned tenant was not isolated: "
                        f"shed={plat['shed']} errors={plat['errors']}")
                if plat.get("ttft_ms_p95", 0.0) > objective:
                    problems.append(
                        f"pinned tenant ttft p95 {plat['ttft_ms_p95']}ms "
                        f"blew its {objective:g}ms objective under bulk "
                        "overload")
                if not batch.get("shed"):
                    problems.append(
                        "bulk tenant was never shed — the overload this "
                        "assertion exists to survive did not happen")
            for p_ in problems:
                print(f"[replay] tenant QoS assertion FAILED: {p_}")
            if problems:
                rc = 1
            else:
                print("[replay] tenant QoS assertion PASSED: pinned p95 "
                      f"{plat['ttft_ms_p95']}ms held its objective; bulk "
                      f"shed {batch['shed']}/{batch['requests']} at "
                      "admission")
        if args.report_json:
            with open(args.report_json, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1)
        return rc
    finally:
        if gw is not None:
            gw.close()


if __name__ == "__main__":
    sys.exit(main())
