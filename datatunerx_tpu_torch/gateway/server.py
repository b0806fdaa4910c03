"""Gateway HTTP front-end: one endpoint fronting N serving replicas (the
port's copy of ``datatunerx_tpu/gateway/server.py``; spawned replicas are
``datatunerx_tpu_torch.serving.server`` processes on ``--device``).

Same wire surface the single server exposes (POST /chat/completions and
/v1/chat/completions with SSE streaming, GET /healthz, /v1/models,
/metrics, POST /perplexity) plus gateway-only endpoints:

  GET  /autoscale            queue/p95 summary + desired-replica hint
                             (operator/capacity.py consumes this)
  POST /admin/scale          {"replicas": N} — resize the managed replica
                             set (graceful drain on downscale)
  POST /admin/drain          {"replica": name} — drain one replica for a
                             rolling restart

Request handling: admission control first (429 + Retry-After on overload),
then routed to a replica (least-busy / round-robin / session affinity /
adapter awareness), with failover — a replica dying yields a retry on
another replica, including MID-STREAM: the replacement's output has the
already-emitted prefix skipped, so the client's SSE stream continues
seamlessly. Every request carries an X-DTX-Trace-Id, generated here when
absent and propagated to the replica, so one id follows a request
operator → gateway → engine.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from datatunerx_tpu_torch.fleet import FleetPlane
from datatunerx_tpu_torch.gateway.admission import AdmissionController, Overloaded
from datatunerx_tpu_torch.gateway.autoscale import autoscale_hint
from datatunerx_tpu_torch.gateway.metrics import MS_BUCKETS, Registry
from datatunerx_tpu_torch.gateway.replica_pool import (
    MIGRATED_MARKER,
    HTTPReplica,
    NoReplicaAvailable,
    Replica,
    ReplicaError,
    ReplicaPool,
)
from datatunerx_tpu_torch.gateway.router import Router
from datatunerx_tpu_torch.obs.metrics import (
    exemplars_requested,
    set_build_info,
    set_uptime,
)
from datatunerx_tpu_torch.obs.slo import SLOEvaluator, default_slos, load_slos
from datatunerx_tpu_torch.obs.trace import Span, Tracer, TraceStore
from datatunerx_tpu_torch.serving.local_backend import _free_port
from datatunerx_tpu_torch.tenancy import load_tenants


# an import may PARK on the target's scheduler this long waiting for
# capacity (BatchedEngine.import_session wait_s default) — the claim wait
# must outlast it, or a session that imports late degrades to a cold
# re-prefill PLUS an orphaned continuation
HANDOFF_IMPORT_WAIT_S = 10.0
HANDOFF_CLAIM_WAIT_S = HANDOFF_IMPORT_WAIT_S + 2.0


class _HandoffBuffer:
    """Imported session continuations parked between the drain thread
    (which exports from the source and imports on the target) and the
    request thread whose stream just died with the migrated marker. One
    entry per trace id, claimed once; ``claim`` can WAIT because the
    stream's death races the import completing. Entries unclaimed past
    the TTL are swept (streams closed) on every put AND claim — any
    gateway traffic at all unpins an abandoned handoff's HTTP response."""

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s
        self._cond = threading.Condition()
        self._entries: dict = {}

    @staticmethod
    def _close(entries):
        for e in entries:
            close = getattr(e.get("stream"), "close", None)
            if callable(close):
                try:
                    close()
                except Exception:  # noqa: BLE001 — cleanup is best-effort
                    pass

    def _sweep_locked(self):
        now = time.monotonic()
        return [self._entries.pop(tid)
                for tid in [t for t, e in self._entries.items()
                            if now - e["t"] > self.ttl_s]]

    def put(self, trace_id: str, entry: dict):
        if not trace_id:
            # unclaimable (payload with no trace id): release the imported
            # continuation immediately — nobody can ever splice it
            self._close([entry])
            return
        entry["t"] = time.monotonic()
        with self._cond:
            stale = self._sweep_locked()
            self._entries[trace_id] = entry
            self._cond.notify_all()
        self._close(stale)

    def claim(self, trace_id: str, wait_s: float = 0.0) -> Optional[dict]:
        with self._cond:
            stale = self._sweep_locked()
        self._close(stale)  # outside the lock: close() may do socket work
        deadline = time.monotonic() + wait_s
        with self._cond:
            while True:
                entry = self._entries.pop(trace_id, None)
                if entry is not None:
                    return entry
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cond.wait(left)


class Gateway:
    """Transport-independent core: tests drive this directly; the HTTP
    handler below is a thin shell around it."""

    def __init__(self, pool: ReplicaPool, policy: str = "least_busy",
                 admission: Optional[AdmissionController] = None,
                 max_attempts: int = 3, model_name: str = "",
                 trace_ring: int = 256,
                 trace_log_path: Optional[str] = None,
                 slos=None, session_handoff: bool = True,
                 prefill_threshold: int = 0,
                 fleet_prefix_bytes: int = 0,
                 fleet_handoff: bool = False,
                 fleet_spill: bool = False,
                 tenants=None):
        self.pool = pool
        self.router = Router(pool, policy=policy,
                             prefill_threshold=prefill_threshold)
        self.admission = admission or AdmissionController()
        # fleet-true admission: tie 429/Retry-After to the fleet's LIVE
        # free-block sum whenever the replicas report a paged pool (dense
        # fleets return None and the static token budget stays the gate).
        # Only wired when the controller wasn't given its own source —
        # tests injecting a custom fn keep it.
        if getattr(self.admission, "fleet_blocks_fn", None) is None \
                and hasattr(self.admission, "fleet_blocks_fn"):
            self.admission.fleet_blocks_fn = self.fleet_kv_blocks
        self.max_attempts = max_attempts
        self.model_name = model_name
        self.registry = Registry()
        self.started_at = time.monotonic()
        self._requests = self.registry.counter(
            "dtx_gateway_requests_total", "Requests by terminal HTTP code.")
        self._failovers = self.registry.counter(
            "dtx_gateway_failovers_total",
            "Requests retried on another replica after a replica fault.")
        self._latency = self.registry.histogram(
            "dtx_gateway_request_latency_seconds",
            "End-to-end request latency through the gateway.")
        self._queue_wait = self.registry.histogram(
            "dtx_gateway_queue_wait_ms",
            "Admission + routing time before the first replica attempt "
            "(time a request spends queued at the gateway, not serving).",
            buckets=MS_BUCKETS)
        # the gateway's half of a request's trace: spans for admission /
        # route / retry / stream land here, keyed by the X-DTX-Trace-Id the
        # handler mints; GET /debug/trace/<id> merges the replica's half in
        self.trace_store = TraceStore(capacity=trace_ring,
                                      jsonl_path=trace_log_path)
        self.tracer = Tracer(store=self.trace_store)
        self.replica_set = None  # ManagedReplicaSet when the gateway spawns
        # serializes snapshot-gauge restating (concurrent scrapes would race
        # clear/set and drop per-replica series) and the shed-delta tracking
        self._scrape_lock = threading.Lock()
        self._shed_at_last_hint = 0
        # active canary promotion (experiment/promotion.py), single-flight;
        # started by POST /admin/promote or ExperimentRunner
        self.promotion = None
        self._promotion_lock = threading.Lock()
        # SLO plane (obs/slo.py): objectives over this registry's own
        # request histograms/counters, judged at GET /debug/slo and restated
        # as dtx_slo_* gauges on every /metrics scrape — the same evaluator
        # class the promotion guard and the replay epilogue run
        self.slo = SLOEvaluator(self.registry, slos or default_slos("gateway"))
        # operator-configured SLOs also drive /autoscale off burn rate
        # instead of raw p95 (defaults stay advisory-only: they are loose
        # bootstrap objectives, not a scaling contract)
        self.slo_configured = slos is not None
        # KV migration fabric: drain exports every in-flight session from
        # the leaving replica and imports it elsewhere; the dying streams
        # splice the imported continuation instead of re-prefilling
        self.session_handoff = session_handoff
        self._handoff = _HandoffBuffer()
        self.last_handoff: Optional[dict] = None
        self._handoffs = self.registry.counter(
            "dtx_gateway_handoff_total",
            "Drain/failover session handoffs by outcome (imported = "
            "resumed re-prefill-free elsewhere, cold = fell back to the "
            "re-prefill path, export_failed / unsupported = source could "
            "not export).")
        self._splices = self.registry.counter(
            "dtx_gateway_handoff_splices_total",
            "Client streams spliced onto an imported continuation, by "
            "outcome.")
        self._h_handoff = self.registry.histogram(
            "dtx_gateway_handoff_ms",
            "Per-session export→import handoff time (trace exemplars "
            "resolve at /debug/trace/<id>).",
            buckets=MS_BUCKETS)
        # disaggregated fleet plane (datatunerx_tpu_torch/fleet/): prefix tier
        # + prefill→decode handoff + peer spill, each flag-gated. With
        # every flag at its default the plane is never constructed and
        # the gateway is byte-identical to a fleet-less build.
        self.fleet: Optional[FleetPlane] = None
        if fleet_prefix_bytes > 0 or fleet_handoff or fleet_spill:
            self.fleet = FleetPlane(
                pool, self._handoff.put,
                prefix_budget_bytes=fleet_prefix_bytes,
                handoff=fleet_handoff, spill=fleet_spill)
        # multi-tenant QoS plane (datatunerx_tpu_torch/tenancy/): same gating
        # contract as the fleet plane — no tenant config means no
        # directory, no per-tenant admission pricing, no dtx_gateway_
        # tenant_* families, and an exposition byte-identical to a
        # tenancy-less build.
        self.tenants = load_tenants(tenants)
        # adapter → checkpoint catalog for prefetch-on-route, merged
        # lazily (and stickily) from replicas' adapter_inventory() — the
        # serving side's adapter_catalog() over the wire
        self._adapter_catalog: dict = {}
        self._catalog_lock = threading.Lock()
        self._tenant_lock = threading.Lock()
        # per-tenant TTFT observations (ms) for the /autoscale burn
        # branch; bounded deques keyed by directory names only
        self._tenant_ttft: dict = {}
        self._tenant_outcomes: dict = {}  # (tenant, outcome) -> count
        # distinct tenant label values, capped like router.adapter_requests:
        # every name becomes a Prometheus series, and a directory
        # grown through POST /admin/tenants must not grow the exposition
        # without bound
        self._tenant_seen: set = set()
        self._tenant_series_cap = 1024
        self._prefetches = 0
        # live fire-and-forget workers (adapter prefetch, promotion run):
        # pruned on spawn, joined by close() so no worker outlives the
        # gateway and ticks against torn-down replicas in tests
        self._worker_threads: list = []
        self._promotion_thread = None

    # -------------------------------------------------------------- routing
    def _kwargs_from(self, req: dict) -> dict:
        return dict(
            max_new_tokens=int(req.get("max_tokens", 128)),
            temperature=float(req.get("temperature", 0.0)),
            top_p=float(req.get("top_p", 1.0)),
        )

    def _adapter_from(self, req: dict) -> str:
        adapter = req.get("model") or ""
        if adapter and adapter == self.model_name:
            return ""
        return adapter

    def _route(self, messages, adapter, session_id, tried,
               on_event=None, prefer_spec: bool = False,
               prompt_tokens: Optional[int] = None) -> Replica:
        return self.router.route(messages=messages, adapter=adapter,
                                 session_id=session_id, exclude=tried,
                                 on_event=on_event, prefer_spec=prefer_spec,
                                 prompt_tokens=prompt_tokens)

    @staticmethod
    def _spec_friendly(kwargs: dict) -> bool:
        """Greedy requests are the spec-friendliest traffic (deterministic
        proposals verify best and the guarantee is token-exactness, not
        just distribution-exactness) — prefer replicas whose speculative
        plane is live for them."""
        return float(kwargs.get("temperature", 0.0) or 0.0) <= 0.0

    def _replica_failed(self, replica: Replica):
        replica.breaker.record_failure()
        self.router.forget_replica(replica.name)

    # -------------------------------------------------------------- tenancy
    def _resolve_tenant(self, tenant: str, adapter: str):
        """The request's TenantSpec (header first, adapter mapping second)
        or None — anonymous requests take the pre-tenancy path exactly."""
        if self.tenants is None:
            return None
        return self.tenants.resolve(tenant=tenant, adapter=adapter)

    def _admission_tenant(self, spec) -> Optional[dict]:
        """A resolved tenant's admission pricing row; share_total is the
        directory-wide Σshares the weighted-fair cap divides by."""
        if spec is None:
            return None
        return {"name": spec.name, "share": spec.share,
                "share_total": sum(self.tenants.shares().values()) or 1.0,
                "kv_block_quota": spec.kv_block_quota}

    def _catalog_checkpoint(self, adapter: str) -> Optional[str]:
        """adapter → checkpoint, merged lazily (and stickily) from the
        replicas: in-process replicas expose the engine's FULL
        adapter_catalog(); remote ones their resident inventory."""
        with self._catalog_lock:
            ckpt = self._adapter_catalog.get(adapter)
        if ckpt:
            return ckpt
        for r in self.pool.replicas():
            cat = None
            fn = getattr(getattr(r, "engine", None), "adapter_catalog",
                         None)
            if callable(fn):
                try:
                    cat = dict(fn())
                except Exception:  # noqa: BLE001 — catalog is best-effort
                    cat = None
            if cat is None:
                try:
                    cat = r.adapter_inventory()
                except Exception:  # noqa: BLE001
                    cat = None
            if cat:
                with self._catalog_lock:
                    for n, c in cat.items():
                        self._adapter_catalog.setdefault(n, c)
        with self._catalog_lock:
            return self._adapter_catalog.get(adapter)

    def note_adapter_checkpoint(self, adapter: str, checkpoint: str):
        """Seed the prefetch catalog (admin adapter registration path)."""
        if adapter and checkpoint:
            with self._catalog_lock:
                self._adapter_catalog[adapter] = checkpoint

    def _maybe_prefetch(self, adapter: str, root: Span):
        """Prefetch-on-route: when NO replica holds the adapter resident,
        fire its load on the least-loaded available replica in parallel
        with admission — by the time the request clears admission and
        routes, the load-on-miss it would have paid is already in
        flight. Purely an optimization: any fault is swallowed and the
        request proceeds down the ordinary load-on-miss path."""
        try:
            candidates = self.pool.available()
            if not candidates:
                return
            for r in candidates:
                try:
                    st = r.stats_snapshot()
                except Exception:  # noqa: BLE001 — stats are advisory
                    st = {}
                if adapter in (st.get("resident_adapters") or ()):
                    return  # warm somewhere — the router will find it
            ckpt = self._catalog_checkpoint(adapter)
            if not ckpt:
                return
            target = min(candidates, key=lambda c: c.inflight)
            root.event("adapter_prefetch", replica=target.name,
                       adapter=adapter)
            with self._tenant_lock:
                self._prefetches += 1
            t = threading.Thread(
                target=self._prefetch_worker, args=(target, adapter, ckpt),
                name=f"dtx-prefetch-{adapter}", daemon=True)
            with self._tenant_lock:
                self._worker_threads = [
                    w for w in self._worker_threads if w.is_alive()]
                self._worker_threads.append(t)
            t.start()
        except Exception:  # noqa: BLE001 — prefetch must never fail a request
            pass

    @staticmethod
    def _prefetch_worker(replica, adapter: str, checkpoint: str):
        try:
            replica.preload_adapter(adapter, checkpoint)
        except Exception:  # noqa: BLE001 — best-effort warm
            pass

    def _tenant_observe(self, name: str, outcome: str,
                        ttft_ms: Optional[float] = None):
        if self.tenants is None or not name:
            return
        with self._tenant_lock:
            if name not in self._tenant_seen:
                if len(self._tenant_seen) >= self._tenant_series_cap:
                    return
                self._tenant_seen.add(name)
            key = (name, outcome)
            self._tenant_outcomes[key] = self._tenant_outcomes.get(key, 0) + 1
            if ttft_ms is not None:
                dq = self._tenant_ttft.get(name)
                if dq is None:
                    dq = self._tenant_ttft[name] = deque(maxlen=256)
                dq.append(float(ttft_ms))

    def _tenant_ttft_p95(self, name: str) -> Optional[float]:
        with self._tenant_lock:
            window = list(self._tenant_ttft.get(name) or ())
        if not window:
            return None
        window.sort()
        return window[min(len(window) - 1, int(0.95 * len(window)))]

    def _tenant_burn(self) -> Optional[dict]:
        """Worst per-tenant TTFT-objective burn, shaped like _slo_burn's
        verdict — tenants with a ttft_p95_ms objective drive /autoscale
        even when no gateway-wide SLO doc is configured."""
        if self.tenants is None:
            return None
        worst: Optional[dict] = None
        for name in self.tenants.names():
            spec = self.tenants.get(name)
            if spec is None or spec.ttft_p95_ms <= 0:
                continue
            p95 = self._tenant_ttft_p95(name)
            if p95 is None:
                continue
            burn = p95 / spec.ttft_p95_ms
            if worst is None or burn > worst["burn_rate"]:
                worst = {"name": f"tenant/{name}:ttft_p95_ms",
                         "burn_rate": round(burn, 4)}
        return worst

    # -------------------------------------------------------------- tracing
    def _begin_request_span(self, name: str, trace_id: str,
                            adapter: str) -> Span:
        """Open the gateway's root span for one request. Explicit spans
        (Tracer.start / finish), not the contextvar manager: chat_stream is
        a generator and a ``with`` block suspending across yields would
        leak the contextvar into the HTTP handler's context."""
        sp = self.tracer.start(name, trace_id=trace_id)
        if adapter:
            sp.set(adapter=adapter)
        return sp

    def _finish_request_span(self, sp: Span, status: str = "ok",
                             error: Optional[BaseException] = None):
        if error is not None and "error" not in sp.attrs:
            sp.set(error=str(error) or type(error).__name__)
        self.tracer.finish(sp, status=status)

    # ----------------------------------------------------------- non-stream
    def chat(self, req: dict, trace_id: str = "",
             session_id: Optional[str] = None, tenant: str = "") -> str:
        """Complete a non-streamed chat request with failover. Raises
        Overloaded / NoReplicaAvailable / ValueError(client error)."""
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        adapter = self._adapter_from(req)
        kwargs = self._kwargs_from(req)
        if adapter:
            kwargs["adapter"] = adapter
        t_spec = self._resolve_tenant(tenant, adapter)
        if t_spec is not None:
            kwargs["tenant"] = t_spec.name
        t0 = time.monotonic()
        root = self._begin_request_span("gateway.request", trace_id, adapter)
        if t_spec is not None:
            root.set(tenant=t_spec.name)
        try:
            if self.tenants is not None and adapter:
                # fired BEFORE admission so the adapter load overlaps it
                self._maybe_prefetch(adapter, root)
            admit_kw = ({"tenant": self._admission_tenant(t_spec)}
                        if t_spec is not None else {})
            with self.admission.try_admit(messages, **admit_kw) as ticket:
                root.event("admitted")
                tried: set = set()
                last: Optional[Exception] = None
                expect_handoff = False
                for attempt in range(self.max_attempts):
                    # a drained-away session leaves its imported
                    # continuation here — splice it instead of re-routing
                    # (and re-prefilling) the whole request
                    entry = self._claim_handoff(root.trace_id,
                                                expect_handoff)
                    expect_handoff = False
                    if entry is not None:
                        try:
                            # emitted="" makes the splice yield the full
                            # text: migrated tail + continuation
                            text = "".join(
                                self._consume_splice(entry, "", root))
                        except ReplicaError as e:
                            last = e
                            continue
                        self._latency.observe(time.monotonic() - t0,
                                              trace_id=root.trace_id)
                        if t_spec is not None:
                            self._tenant_observe(
                                t_spec.name, "ok",
                                ttft_ms=(time.monotonic() - t0) * 1e3)
                        root.set(replica=entry.get("target"),
                                 attempts=attempt + 1, handoff=True)
                        self._finish_request_span(root)
                        return text
                    replica = self._route(
                        messages, adapter, session_id, tried,
                        on_event=root.event,
                        prefer_spec=self._spec_friendly(kwargs),
                        # the admission estimate IS the routing signal:
                        # tokenizer-exact when one is wired, else the
                        # calibrated chars-per-token heuristic
                        prompt_tokens=ticket.tokens)
                    tried.add(replica.name)
                    root.event("route", replica=replica.name,
                               attempt=attempt)
                    if attempt == 0:
                        self._queue_wait.observe(
                            (time.monotonic() - t0) * 1e3,
                            trace_id=root.trace_id)
                    replica.acquire()
                    t_attempt = time.monotonic()
                    try:
                        text = replica.chat(messages, trace_id=root.trace_id,
                                            **kwargs)
                        replica.breaker.record_success()
                        self._calibrate_usage(replica)
                        replica.record_outcome(
                            True, (time.monotonic() - t_attempt) * 1e3)
                        self._latency.observe(time.monotonic() - t0,
                                              trace_id=root.trace_id)
                        if t_spec is not None:
                            self._tenant_observe(
                                t_spec.name, "ok",
                                ttft_ms=(time.monotonic() - t0) * 1e3)
                        root.set(replica=replica.name, attempts=attempt + 1)
                        self._finish_request_span(root)
                        return text
                    except ReplicaError as e:
                        if self.session_handoff and MIGRATED_MARKER in str(e):
                            # not a fault: the session was exported off a
                            # draining replica; next pass splices it
                            expect_handoff = True
                            root.event("handoff_pending",
                                       replica=replica.name)
                            last = e
                            continue
                        replica.record_outcome(
                            False, (time.monotonic() - t_attempt) * 1e3)
                        self._replica_failed(replica)
                        self._failovers.inc()
                        root.event("retry", replica=replica.name,
                                   error=str(e))
                        last = e
                    finally:
                        replica.release()
                raise NoReplicaAvailable(
                    f"all {len(tried)} attempted replicas failed: {last}")
        except BaseException as e:
            if t_spec is not None:
                self._tenant_observe(
                    t_spec.name,
                    "shed" if isinstance(e, Overloaded) else "error")
            self._finish_request_span(root, status="error", error=e)
            raise

    # --------------------------------------------------------------- stream
    def chat_stream(self, req: dict, trace_id: str = "",
                    session_id: Optional[str] = None, tenant: str = ""):
        """Yield text deltas with MID-STREAM failover: when a replica dies
        after emitting part of the answer, the request restarts on another
        replica and the already-emitted character prefix is skipped — the
        client's stream continues where it stopped. (Deterministic decode
        gives byte-identical resumption; sampled requests resume the same
        way but may diverge, which beats a dead stream.)"""
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        adapter = self._adapter_from(req)
        kwargs = self._kwargs_from(req)
        if adapter:
            kwargs["adapter"] = adapter
        t_spec = self._resolve_tenant(tenant, adapter)
        if t_spec is not None:
            kwargs["tenant"] = t_spec.name
        t0 = time.monotonic()
        root = self._begin_request_span("gateway.stream", trace_id, adapter)
        if t_spec is not None:
            root.set(tenant=t_spec.name)
        try:
            if self.tenants is not None and adapter:
                # fired BEFORE admission so the adapter load overlaps it
                self._maybe_prefetch(adapter, root)
            admit_kw = ({"tenant": self._admission_tenant(t_spec)}
                        if t_spec is not None else {})
            with self.admission.try_admit(messages, **admit_kw) as ticket:
                root.event("admitted")
                emitted = ""
                t_first: Optional[float] = None
                tried: set = set()
                expect_handoff = False
                for attempt in range(self.max_attempts):
                    # a drained-away session leaves its imported
                    # continuation in the handoff buffer: splice it onto
                    # the client's stream instead of re-prefilling
                    entry = self._claim_handoff(root.trace_id,
                                                expect_handoff)
                    expect_handoff = False
                    if entry is not None:
                        try:
                            for delta in self._consume_splice(entry,
                                                              emitted, root):
                                if not emitted:
                                    root.event("first_delta",
                                               replica=entry.get("target"))
                                    t_first = time.monotonic()
                                emitted += delta
                                yield delta
                        except ReplicaError:
                            continue  # next attempt: the cold path
                        self._latency.observe(time.monotonic() - t0,
                                              trace_id=root.trace_id)
                        if t_spec is not None:
                            self._tenant_observe(
                                t_spec.name, "ok",
                                ttft_ms=((t_first or time.monotonic())
                                         - t0) * 1e3)
                        root.set(replica=entry.get("target"),
                                 attempts=attempt + 1, chars=len(emitted),
                                 handoff=True)
                        self._finish_request_span(root)
                        return
                    replica = self._route(
                        messages, adapter, session_id, tried,
                        on_event=root.event,
                        prefer_spec=self._spec_friendly(kwargs),
                        prompt_tokens=ticket.tokens)
                    tried.add(replica.name)
                    root.event("route", replica=replica.name,
                               attempt=attempt)
                    if attempt == 0:
                        self._queue_wait.observe(
                            (time.monotonic() - t0) * 1e3,
                            trace_id=root.trace_id)
                    replica.acquire()
                    skip = len(emitted)
                    t_attempt = time.monotonic()
                    try:
                        for delta in replica.chat_stream(
                                messages, trace_id=root.trace_id, **kwargs):
                            if skip > 0:
                                if len(delta) <= skip:
                                    skip -= len(delta)
                                    continue
                                delta = delta[skip:]
                                skip = 0
                            if not emitted:
                                root.event("first_delta",
                                           replica=replica.name)
                                t_first = time.monotonic()
                            emitted += delta
                            yield delta
                        replica.breaker.record_success()
                        self._calibrate_usage(replica)
                        replica.record_outcome(
                            True, (time.monotonic() - t_attempt) * 1e3)
                        self._latency.observe(time.monotonic() - t0,
                                              trace_id=root.trace_id)
                        if t_spec is not None:
                            self._tenant_observe(
                                t_spec.name, "ok",
                                ttft_ms=((t_first or time.monotonic())
                                         - t0) * 1e3)
                        root.set(replica=replica.name, attempts=attempt + 1,
                                 chars=len(emitted))
                        self._finish_request_span(root)
                        return
                    except ReplicaError as e:
                        if self.session_handoff and MIGRATED_MARKER in str(e):
                            # the session was exported off a draining
                            # replica — not a fault; the next pass waits
                            # for (then splices) the imported continuation
                            expect_handoff = True
                            root.event("handoff_pending",
                                       replica=replica.name,
                                       resumed_at_char=len(emitted))
                            continue
                        replica.record_outcome(
                            False, (time.monotonic() - t_attempt) * 1e3)
                        self._replica_failed(replica)
                        self._failovers.inc()
                        root.event("retry", replica=replica.name,
                                   error=str(e),
                                   resumed_at_char=len(emitted))
                    finally:
                        replica.release()
                raise NoReplicaAvailable(
                    f"stream failed over {len(tried)} replicas")
        except BaseException as e:
            if t_spec is not None:
                self._tenant_observe(
                    t_spec.name,
                    "shed" if isinstance(e, Overloaded) else "error")
            # GeneratorExit included: a client hanging up mid-stream still
            # closes the gateway's span (status error, error=GeneratorExit)
            self._finish_request_span(root, status="error", error=e)
            raise

    # ----------------------------------------------------------- perplexity
    def perplexity(self, req: dict, trace_id: str = "") -> dict:
        import urllib.error

        replica = self._route(None, req.get("model") or "", None, set())
        if not isinstance(replica, HTTPReplica):
            raise NotImplementedError(
                "perplexity proxying requires HTTP replicas")
        replica.acquire()
        try:
            with replica._post("/perplexity", req, trace_id) as r:
                out = json.load(r)
            replica.breaker.record_success()
            return out
        except urllib.error.HTTPError as e:
            # 4xx is the CLIENT's error (same rule as chat): the replica is
            # fine — don't trip its breaker over someone's malformed body
            if 400 <= e.code < 500:
                try:
                    detail = json.load(e).get("error", e.reason)
                except Exception:  # noqa: BLE001
                    detail = e.reason
                raise ValueError(str(detail)) from e
            self._replica_failed(replica)
            raise ReplicaError(f"{replica.name}: HTTP {e.code}") from e
        except (OSError, ValueError) as e:
            self._replica_failed(replica)
            raise ReplicaError(f"{replica.name}: {e}") from e
        finally:
            replica.release()

    # ----------------------------------------------------- session handoff
    def _claim_handoff(self, trace_id: str,
                       expect: bool) -> Optional[dict]:
        """Pop this request's imported continuation, if any. When the
        previous attempt died with the migrated marker (``expect``), wait
        long enough to outlast the import's own park deadline — giving up
        earlier would re-prefill cold AND orphan the late import."""
        if not self.session_handoff:
            return None
        entry = self._handoff.claim(
            trace_id, wait_s=HANDOFF_CLAIM_WAIT_S if expect else 0.0)
        if entry is None or entry.get("failed"):
            return None  # tombstone = the drain already counted it cold
        return entry

    def _consume_splice(self, entry: dict, emitted: str, root: Span):
        """Relay an imported continuation, recording splice outcome and
        target-replica accounting — the shared core of chat's and
        chat_stream's handoff paths. Yields net-new text; raises
        ReplicaError (after failure accounting) when the target dies
        mid-splice, which the caller turns into a cold retry."""
        target = self.pool.get(entry.get("target") or "")
        root.event("handoff_splice", replica=entry.get("target"),
                   resumed_at_char=len(emitted))
        t_attempt = time.monotonic()
        try:
            for delta in self._splice_deltas(entry, emitted):
                yield delta
        except ReplicaError as e:
            self._splices.inc({"outcome": "failed"})
            root.event("handoff_splice_failed", error=str(e))
            if target is not None:
                target.record_outcome(
                    False, (time.monotonic() - t_attempt) * 1e3)
                self._replica_failed(target)
            raise
        self._splices.inc({"outcome": "ok"})
        if target is not None:
            target.breaker.record_success()
            target.record_outcome(
                True, (time.monotonic() - t_attempt) * 1e3)

    def _splice_deltas(self, entry: dict, emitted: str):
        """Yield ONLY net-new text for a spliced stream: reconcile the
        import's ``text_so_far`` against what the client already received
        (token-exact resume makes them equal; the skip logic absorbs any
        detokenization-boundary char drift), then relay the continuation."""
        pre = str(entry.get("text_so_far") or "")
        if len(pre) > len(emitted):
            yield pre[len(emitted):]
        skip = max(0, len(emitted) - len(pre))
        for delta in entry["stream"]:
            if skip > 0:
                if len(delta) <= skip:
                    skip -= len(delta)
                    continue
                delta = delta[skip:]
                skip = 0
            if delta:
                yield delta

    def handoff_sessions(self, source: Replica) -> dict:
        """Export every in-flight decode session from ``source`` and
        import each onto another available replica (adapter-resident
        targets first, like the router's preference). Imported sessions
        park in the handoff buffer keyed by trace id; the dying client
        streams splice them. Sessions no target can admit are counted
        cold and fall back to today's re-prefill failover."""
        summary: dict = {"source": source.name, "exported": 0,
                         "imported": 0, "cold": 0, "skipped": 0}
        # with the fleet handoff plane on, a drain also ships MID-chunked-
        # prefill tails (blocks written so far + remaining prompt) — a
        # prefill specialist drained mid-prompt re-prefills nothing.
        # Off (default): mid-prefill slots are
        # skipped and their streams take the cold path.
        include_prefill = (self.fleet is not None
                           and self.fleet.handoff is not None)
        try:
            doc = source.export_sessions(include_prefill=include_prefill)
        except ReplicaError as e:
            self._handoffs.inc({"outcome": "export_failed"})
            summary["error"] = str(e)
            return summary
        if doc is None:
            self._handoffs.inc({"outcome": "unsupported"})
            summary["unsupported"] = True
            return summary
        skipped = doc.get("skipped") or []
        summary["skipped"] = len(skipped)
        if skipped:
            print(f"[gateway] handoff from {source.name}: "
                  f"{len(skipped)} session(s) not exportable "
                  f"({sorted({s.get('reason') for s in skipped})})",
                  flush=True)
        for payload in doc.get("sessions") or []:
            summary["exported"] += 1
            self._handoff_one(source, payload, summary)
        self.last_handoff = summary
        return summary

    def _handoff_one(self, source: Replica, payload: dict, summary: dict):
        t0 = time.monotonic()
        tid = str(payload.get("trace_id") or "")
        adapter = str(payload.get("adapter") or "")
        targets = [r for r in self.pool.available() if r.name != source.name]

        def _resident_rank(r: Replica) -> int:
            if not adapter:
                return 0
            try:
                res = r.stats().get("resident_adapters")
            except Exception:  # noqa: BLE001 — stats are advisory
                return 1
            return 0 if (res and adapter in res) else 1

        targets.sort(key=lambda r: (_resident_rank(r), r.name))
        last_err: Optional[Exception] = None
        for target in targets:
            try:
                res = target.import_session(payload)
            except ReplicaError as e:
                last_err = e
                continue
            if res is None:
                continue  # replica kind without the migration surface
            meta, stream = res
            self._handoff.put(tid, {
                "target": target.name, "meta": meta, "stream": stream,
                "text_so_far": str(meta.get("text_so_far") or "")})
            self._handoffs.inc({"outcome": "imported"})
            self._h_handoff.observe((time.monotonic() - t0) * 1e3,
                                    trace_id=tid or None)
            summary["imported"] += 1
            return
        # nothing could admit it: the dying stream takes the cold path
        # (a tombstone stops the claimer's wait immediately)
        self._handoff.put(tid, {"failed": True})
        self._handoffs.inc({"outcome": "cold"})
        summary["cold"] += 1
        if last_err is not None:
            summary["last_error"] = str(last_err)
            print(f"[gateway] handoff of {tid or '<no-trace>'} fell back "
                  f"cold: {last_err}", flush=True)

    def handoff_stats(self) -> dict:
        """Handoff outcome counts (the dtx_gateway_handoff_total series),
        plus splice outcomes — the replay harness's zero-drop assertion
        reads this."""
        out: dict = {}
        for key, value in self._handoffs.series().items():
            out[dict(key).get("outcome", "")] = int(value)
        for key, value in self._splices.series().items():
            out[f"splice_{dict(key).get('outcome', '')}"] = int(value)
        return out

    # -------------------------------------------------------- observability
    def trace(self, trace_id: str) -> Optional[dict]:
        """The merged end-to-end view of one trace: the gateway's own spans
        (admission/route/retry/stream) plus every replica's half (engine
        span timelines with per-request TTFT/TPOT), sorted by wall-clock
        start. None = no plane has seen the id."""
        doc = self.trace_store.get(trace_id)
        spans = list(doc["spans"]) if doc else []
        for replica in self.pool.replicas():
            try:
                rdoc = replica.fetch_trace(trace_id)
            except Exception:  # noqa: BLE001 — debug path, best-effort
                rdoc = None
            if rdoc:
                for sp in rdoc.get("spans", []):
                    # copy: an in-process replica hands back references into
                    # its live ring — annotating those in place would write
                    # gateway state into the engine's store
                    sp = dict(sp)
                    sp.setdefault("replica", replica.name)
                    spans.append(sp)
        if not spans:
            return None
        spans.sort(key=lambda s: s.get("start_ms") or 0)
        return {"trace_id": trace_id, "spans": spans}

    def profile(self, seconds: float, log_dir: Optional[str] = None,
                replica_name: str = "") -> dict:
        """Arm a torch.profiler window on one replica (named, or the first
        available). Raises NoReplicaAvailable / ReplicaError /
        NotImplementedError (replica kind has no profiler)."""
        if replica_name:
            replica = self.pool.get(replica_name)
            if replica is None:
                raise NoReplicaAvailable(f"no replica {replica_name!r}")
        else:
            available = self.pool.available()
            if not available:
                raise NoReplicaAvailable("no replica available to profile")
            replica = available[0]
        out = replica.start_profile(seconds, log_dir)
        if out is None:
            raise NotImplementedError(
                f"replica {replica.name!r} does not support profiling")
        return out

    def slo_report(self) -> dict:
        """The /debug/slo body: every declared objective judged over its
        burn-rate windows, from the same registry the request paths record
        into (one evaluator — obs/slo.py — shared with the promotion guard
        and the replay epilogue)."""
        return self.slo.report(plane="gateway")

    # -------------------------------------------------------------- reports
    def fleet_kv_blocks(self) -> Optional[dict]:
        """The fleet's live paged-KV inventory, summed over AVAILABLE
        replicas: {"free", "total", "block_size"} — the signal fleet-true
        admission and the /autoscale hint derive from. None when no
        available replica reports a block pool (dense fleet / no stats):
        callers fall back to their static heuristics."""
        free = total = block_size = 0
        for r in self.pool.available():
            try:
                st = r.stats()  # TTL-cached on HTTP replicas
            except Exception:  # noqa: BLE001 — stats are advisory
                continue
            if st.get("kv_blocks_total"):
                free += int(st.get("kv_blocks_free", 0))
                total += int(st["kv_blocks_total"])
                block_size = max(block_size,
                                 int(st.get("kv_block_size", 0) or 0))
        if total <= 0:
            return None
        return {"free": free, "total": total,
                "block_size": block_size or 16}

    def _calibrate_usage(self, replica: Replica):
        """After a successful attempt, fold the replica-reported tokenized
        prompt length into admission's chars-per-token estimate."""
        take = getattr(replica, "take_usage", None)
        cal = getattr(self.admission, "calibrate", None)
        if not callable(take) or not callable(cal):
            return
        usage = take()
        if usage:
            cal(usage.get("prompt_chars", 0), usage.get("prompt_tokens", 0))

    def healthy(self) -> bool:
        return len(self.pool.available()) > 0

    def autoscale(self) -> dict:
        shed_total = self.admission.shed_count
        with self._scrape_lock:
            shed_recent = shed_total - self._shed_at_last_hint
            self._shed_at_last_hint = shed_total
        slo_burn = self._slo_burn() if self.slo_configured else None
        # a tenant with a ttft_p95_ms objective burns the same branch —
        # the hint's reason names the tenant and objective
        t_burn = self._tenant_burn()
        if t_burn is not None and (slo_burn is None
                                   or t_burn["burn_rate"]
                                   > slo_burn["burn_rate"]):
            slo_burn = t_burn
        return autoscale_hint(
            replicas=len(self.pool.replicas()),
            available_replicas=len(self.pool.available()),
            queue_depth=self.admission.depth,
            queued_tokens=self.admission.queued_tokens,
            shed_count=shed_total,
            shed_recent=shed_recent,
            p95_latency_s=self._latency.percentile(0.95),
            slo_burn=slo_burn,
            # the hint derives from blocks, not slots: the same live
            # free-block sum admission sheds on
            fleet_blocks=self.fleet_kv_blocks(),
        )

    def _slo_burn(self) -> Optional[dict]:
        """The worst-burning configured objective, for the autoscale hint.
        Per the multi-window page rule, an SLO's effective burn is the MIN
        over its populated windows (every window must burn to page); the
        hint reports the max of those across objectives."""
        worst: Optional[dict] = None
        try:
            self.slo.sample()
            for doc in self.slo.evaluate():
                populated = [w for w in doc["windows"] if not w["no_data"]]
                if not populated:
                    continue
                burn = min(w["burn_rate"] for w in populated)
                if worst is None or burn > worst["burn_rate"]:
                    worst = {"name": doc["name"],
                             "burn_rate": round(burn, 4)}
        except Exception:  # noqa: BLE001 — a broken SLO eval must not 500 /autoscale
            return None
        return worst

    def record_request(self, code: int):
        self._requests.inc({"code": str(code)})

    def metrics_text(self, with_exemplars: bool = True) -> str:
        with self._scrape_lock:
            return self._metrics_text_locked(with_exemplars)

    def _metrics_text_locked(self, with_exemplars: bool = True) -> str:
        # re-state snapshot gauges at scrape time
        set_build_info(self.registry, "gateway")
        set_uptime(self.registry, "gateway", self.started_at)
        # dtx_slo_* verdict gauges: SAMPLE first so window baselines keep
        # advancing even when nothing polls /debug/slo and no background
        # sampler runs — a scrape-only deployment still gets honest windows
        self.slo.sample()
        self.slo.restate_gauges(self.slo.evaluate())
        g = self.registry.gauge
        g("dtx_gateway_trace_open_spans",
          "Spans opened and not yet finished (a growing value means "
          "leaking request handlers; orphans reap at 10 min).").set(
            self.tracer.open_count())
        g("dtx_gateway_up", "1 when at least one replica is available.").set(
            1 if self.healthy() else 0)
        g("dtx_gateway_queue_depth",
          "Admitted requests currently queued or in flight.").set(
            self.admission.depth)
        g("dtx_gateway_queued_tokens",
          "Estimated prefill tokens admitted and not yet released.").set(
            self.admission.queued_tokens)
        shed = self.registry.counter(
            "dtx_gateway_shed_total",
            "Requests rejected with 429 by admission control.")
        shed.set(self.admission.shed_count)
        circuit = g("dtx_gateway_replica_circuit_state",
                    "One-hot per-replica breaker state "
                    "(closed/half_open/open).")
        up = g("dtx_gateway_replica_up",
               "Per-replica health-probe verdict (0 = draining too).")
        busy = g("dtx_gateway_replica_inflight",
                 "Gateway-side in-flight requests per replica.")
        blocks_free = g("dtx_gateway_replica_kv_blocks_free",
                        "Free paged KV-cache blocks per replica — the "
                        "admission headroom gauge (0 labels absent on "
                        "dense-cache replicas).")
        blocks_reserved = g("dtx_gateway_replica_kv_blocks_reserved",
                            "Reserved (allocated) paged KV-cache blocks "
                            "per replica, restated from the same stats "
                            "snapshot as the free gauge — together they "
                            "are the fleet-true admission ledger.")
        weight = g("dtx_gateway_replica_weight",
                   "Traffic weight per replica (canary promotion: the "
                   "router's smooth-WRR share when weights are "
                   "non-uniform; 0 = receives no new requests).")
        attempts = self.registry.counter(
            "dtx_gateway_replica_attempts_total",
            "Routed attempts per replica by outcome (ok/error) — the "
            "promotion guard's error-rate source, restated at scrape "
            "time from the per-replica outcome windows.")
        # adapter plane: residency-preference routing outcomes + per-adapter
        # demand (restated from the router's counters at scrape time)
        a_routes = self.registry.counter(
            "dtx_gateway_adapter_routes_total",
            "Adapter-request routing outcomes: resident = cache-locality "
            "hit, load_miss = routed to a replica that must load-on-miss, "
            "blind = no replica reported the adapter.")
        a_reqs = self.registry.counter(
            "dtx_gateway_adapter_requests_total",
            "Requests routed per adapter name.")
        a_resident = g("dtx_gateway_adapter_resident_replicas",
                       "Replicas whose pool currently holds each adapter "
                       "(from replica stats snapshots).")
        # speculative decoding: the per-replica acceptance-rate gauge the
        # spec-friendly routing preference reads, plus preference outcomes
        spec_rate = g("dtx_gateway_replica_spec_accept_rate",
                      "Per-replica speculative-decode acceptance-rate EMA "
                      "(labels absent on replicas without a draft model "
                      "or with no observations yet).")
        spec_routes = self.registry.counter(
            "dtx_gateway_spec_routes_total",
            "Spec-friendly (greedy) routing outcomes: preferred = "
            "narrowed to spec-enabled replicas, blind = no narrowing "
            "possible (none or all candidates run spec).")
        # disaggregated routing: long prompts steered to prefill
        # specialists / short ones away, plus each replica's declared role
        role_routes = self.registry.counter(
            "dtx_gateway_role_routes_total",
            "Role-aware routing outcomes: prefill = long prompt steered "
            "to a prefill specialist, decode = short prompt steered away "
            "from them, blind = no role signal narrowed the candidates.")
        replica_role = g("dtx_gateway_replica_role",
                         "Per-replica declared disaggregation role, "
                         "one-hot by label (scraped from "
                         "dtx_serving_role on remote replicas).")
        circuit.clear()
        up.clear()
        busy.clear()
        blocks_free.clear()
        blocks_reserved.clear()
        weight.clear()
        attempts.clear()
        a_routes.clear()
        a_reqs.clear()
        a_resident.clear()
        spec_rate.clear()
        spec_routes.clear()
        role_routes.clear()
        replica_role.clear()
        with self.router._lock:
            routes = dict(self.router.adapter_routes)
            per_adapter = dict(self.router.adapter_requests)
            s_routes = dict(getattr(self.router, "spec_routes", {}))
            r_routes = dict(getattr(self.router, "role_routes", {}))
        for outcome, n in sorted(s_routes.items()):
            spec_routes.set(n, {"outcome": outcome})
        for outcome, n in sorted(r_routes.items()):
            role_routes.set(n, {"outcome": outcome})
        for outcome, n in sorted(routes.items()):
            a_routes.set(n, {"outcome": outcome})
        for name, n in sorted(per_adapter.items()):
            a_reqs.set(n, {"adapter": name})
        residency: dict = {}
        for r in self.pool.replicas():
            state = r.breaker.state
            for s in ("closed", "half_open", "open"):
                circuit.set(1 if s == state else 0,
                            {"replica": r.name, "state": s})
            up.set(1 if r.available() else 0, {"replica": r.name})
            busy.set(r.inflight, {"replica": r.name})
            try:
                # snapshot, not stats(): a scrape must never block on a hung
                # replica's 2s-timeout fetch — routing keeps the cache warm
                st = r.stats_snapshot()
            except Exception:  # noqa: BLE001 — stats are advisory
                st = {}
            if st.get("kv_blocks_total"):
                blocks_free.set(st.get("kv_blocks_free", 0),
                                {"replica": r.name})
                blocks_reserved.set(
                    st["kv_blocks_total"] - st.get("kv_blocks_free", 0),
                    {"replica": r.name})
            for a in st.get("resident_adapters") or ():
                if a:
                    residency[a] = residency.get(a, 0) + 1
            if st.get("spec_enabled") and \
                    st.get("spec_accept_rate") is not None:
                spec_rate.set(round(st["spec_accept_rate"], 4),
                              {"replica": r.name})
            weight.set(round(getattr(r, "weight", 1.0), 6),
                       {"replica": r.name})
            replica_role.set(1, {"replica": r.name,
                                 "role": getattr(r, "role", "mixed")})
            out = r.outcome_stats()
            attempts.set(out["requests"] - out["errors"],
                         {"replica": r.name, "outcome": "ok"})
            attempts.set(out["errors"],
                         {"replica": r.name, "outcome": "error"})
        for a, n in sorted(residency.items()):
            a_resident.set(n, {"adapter": a})
        if self.fleet is not None:
            self._restate_fleet_locked()
        if self.tenants is not None:
            self._restate_tenants_locked()
        return self.registry.expose(with_exemplars=with_exemplars)

    def _restate_tenants_locked(self):
        """dtx_gateway_tenant_* series, restated from the tenancy plane's
        counters at scrape time. Only emitted when a tenant directory is
        configured — a tenant-less gateway's exposition is unchanged down
        to the byte. Label values are resolved directory names plus the
        bounded outcome enum, so cardinality is operator-controlled."""
        g = self.registry.gauge
        t_reqs = self.registry.counter(
            "dtx_gateway_tenant_requests_total",
            "Requests per tenant by terminal outcome (ok/shed/error).")
        t_tokens = g("dtx_gateway_tenant_inflight_tokens",
                     "Admitted prefill tokens currently held per tenant "
                     "(the weighted-fair share ledger).")
        t_blocks = g("dtx_gateway_tenant_inflight_blocks",
                     "Admission-priced KV blocks currently held per "
                     "tenant (the kv_block_quota ledger).")
        t_share = g("dtx_gateway_tenant_share",
                    "Configured weighted-fair share per tenant.")
        t_ttft = g("dtx_gateway_tenant_ttft_p95_ms",
                   "Observed per-tenant TTFT p95 over the rolling "
                   "window (absent until a tenant has traffic).")
        prefetch = self.registry.counter(
            "dtx_gateway_adapter_prefetch_total",
            "Adapter loads fired on route (prefetch-on-route) in "
            "parallel with admission.")
        t_reqs.clear()
        t_tokens.clear()
        t_blocks.clear()
        t_share.clear()
        t_ttft.clear()
        with self._tenant_lock:
            outcomes = dict(self._tenant_outcomes)
            prefetch.set(self._prefetches)
        for (name, outcome), n in sorted(outcomes.items()):
            t_reqs.set(n, {"tenant": name, "outcome": outcome})
        usage = (self.admission.tenant_usage()
                 if hasattr(self.admission, "tenant_usage") else {})
        for name, n in sorted((usage.get("tokens") or {}).items()):
            t_tokens.set(n, {"tenant": name})
        for name, n in sorted((usage.get("blocks") or {}).items()):
            t_blocks.set(n, {"tenant": name})
        for name in self.tenants.names():
            spec = self.tenants.get(name)
            if spec is None:
                continue
            t_share.set(spec.share, {"tenant": name})
            p95 = self._tenant_ttft_p95(name)
            if p95 is not None:
                t_ttft.set(round(p95, 3), {"tenant": name})

    def _restate_fleet_locked(self):
        """dtx_fleet_* series, restated from the fleet plane's counters
        at scrape time (same pattern as the router's). Only emitted when
        the plane exists — a fleet-less gateway's exposition is unchanged
        down to the byte."""
        g = self.registry.gauge
        fstats = self.fleet.stats()
        prefix = fstats.get("prefix")
        if prefix is not None:
            g("dtx_fleet_prefix_entries",
              "Prefix payloads resident in the fleet-shared tier "
              "directory.").set(prefix["entries"])
            g("dtx_fleet_prefix_bytes",
              "Approximate directory footprint of the fleet prefix tier "
              "(b64 wire bytes; LRU-evicted past the budget).").set(
                prefix["bytes"])
            pub = self.registry.counter(
                "dtx_fleet_prefix_publishes_total",
                "Prefix entries pulled from a replica into the fleet "
                "tier (first prefill of a shared prompt).")
            hits = self.registry.counter(
                "dtx_fleet_prefix_hits_total",
                "Peer imports that activated a fleet prefix entry — "
                "that replica's next matching request prefills zero "
                "chunks.")
            misses = self.registry.counter(
                "dtx_fleet_prefix_misses_total",
                "Prefix pushes a peer refused or failed (no free "
                "slot/blocks, adapter not loaded there, transport "
                "fault).")
            pub.set(prefix["publishes"])
            hits.set(prefix["hits"])
            misses.set(prefix["misses"])
        handoff = fstats.get("handoff")
        if handoff is not None:
            c = self.registry.counter(
                "dtx_fleet_handoff_total",
                "Prefill→decode re-homings by outcome (ok = continuation "
                "parked on a decode peer, cold = no peer could admit, "
                "skipped = still mid-prefill this tick, none = no "
                "decode-side peer existed).")
            c.clear()
            for outcome, n in sorted(handoff.items()):
                c.set(n, {"outcome": outcome})
        spill = fstats.get("spill")
        if spill is not None:
            c = self.registry.counter(
                "dtx_fleet_spill_total",
                "Parked-session spills to a peer by outcome (ok = "
                "re-homed token-exactly, refused = every peer 409'd, "
                "error = transport/drop fault, skipped = no eligible "
                "peer).")
            c.clear()
            for outcome, n in sorted(spill.items()):
                c.set(n, {"outcome": outcome})

    # ------------------------------------------------------------ promotion
    def set_weight(self, name: str, weight: float) -> bool:
        """Set one replica's traffic weight (router smooth-WRR share when
        weights are non-uniform; 0 = no new requests)."""
        r = self.pool.get(name)
        if r is None:
            return False
        r.weight = max(0.0, float(weight))
        return True

    def start_promotion(self, canary: str, config: Optional[dict] = None,
                        metrics=None, background: bool = True):
        """Start a canary promotion (experiment/promotion.py): weighted
        traffic shift through the schedule with auto-rollback. Single
        flight — an active promotion raises ValueError. Returns the
        controller (its status() is the /admin/promote response)."""
        from datatunerx_tpu_torch.experiment.promotion import (
            TERMINAL,
            PromotionConfig,
            PromotionController,
        )

        with self._promotion_lock:
            if self.promotion is not None \
                    and self.promotion.state not in TERMINAL:
                raise ValueError(
                    f"a promotion of {self.promotion.canary_name!r} is "
                    "already active")
            cfg = PromotionConfig.from_dict(config or {})
            promo = PromotionController(self, canary, config=cfg,
                                        metrics=metrics)
            self.promotion = promo
        if background:
            t = threading.Thread(target=promo.run, daemon=True)
            self._promotion_thread = t
            t.start()
        return promo

    def promotion_status(self) -> Optional[dict]:
        promo = self.promotion
        return promo.status() if promo is not None else None

    def scale(self, n: int) -> int:
        if self.replica_set is None:
            raise NotImplementedError("gateway does not manage its replicas")
        return self.replica_set.scale(n)

    def drain(self, name: str) -> bool:
        """Drain a replica for a rolling restart. Managed replicas get the
        full treatment (reap the subprocess, spawn a replacement); bare
        pool replicas just stop receiving new requests.

        With ``session_handoff`` on (default), every in-flight decode
        session is exported from the leaving replica and imported onto a
        peer BEFORE the reap — the drained replica empties immediately and
        no client stream re-prefills. Sessions nothing can admit fall back
        to today's cold path, logged and counted."""
        replica = self.pool.get(name)
        if replica is None:
            return False
        if self.session_handoff:
            replica.drain()  # no new routes while sessions migrate
            if any(r.name != name for r in self.pool.available()):
                self.handoff_sessions(replica)  # summary → self.last_handoff
        if self.replica_set is not None and self.replica_set.drain(name):
            self.router.forget_replica(name)
            return True
        if self.pool.drain(name) or replica.draining:
            self.router.forget_replica(name)
            return True
        return False

    def close(self):
        self.slo.stop()
        # abort an in-flight promotion so its run loop goes terminal, then
        # reap the background workers — a promotion ticking against a
        # closed gateway was a real leak the thread sanitizer flagged
        promo = self.promotion
        if promo is not None:
            promo.abort("gateway shutdown")
        t = self._promotion_thread
        if t is not None and t.is_alive():
            t.join(timeout=10)
        with self._tenant_lock:
            workers, self._worker_threads = self._worker_threads, []
        for w in workers:
            w.join(timeout=5)
        if self.fleet is not None:
            self.fleet.stop()
        if self.replica_set is not None:
            self.replica_set.close()
        self.pool.close()


# ------------------------------------------------------------------- subprocs
class ManagedReplicaSet:
    """Supervises port serving.server subprocess replicas on localhost, each
    on ``device`` (``"cuda"`` by default; tests pass ``"cpu"``) — the
    process-per-replica deployment LocalServingBackend/`dtx serve
    --replicas N` uses. A supervisor thread reconciles toward ``target``:
    dead processes (crashed/killed replicas) are reaped and REPLACED, so the
    fleet self-heals like Ray Serve restarting a dead deployment replica.
    Downscale AND /admin/drain are graceful: the replica drains (no new
    requests) and its process is reaped once in-flight work finishes —
    every drained managed replica gets a reaper, so a drain can never
    leave a zombie subprocess + pool entry behind (the fleet previously
    grew past target by one zombie per /admin/drain)."""

    def __init__(self, pool: ReplicaPool, server_args: List[str],
                 workdir: str = "", drain_timeout_s: float = 30.0,
                 supervise_interval_s: float = 2.0,
                 roles: Optional[List[str]] = None, device: str = "cuda"):
        self.pool = pool
        self.server_args = list(server_args)
        self.device = device
        # disaggregation role cycle ("prefill,decode" = half and half):
        # each spawn takes the role furthest below its share of the
        # cycle, so a replacement restores the fleet's role balance no
        # matter which replica died. Empty/None = role-less (mixed).
        self.roles = [r for r in (roles or []) if r]
        self.workdir = workdir or os.getcwd()
        self.drain_timeout_s = drain_timeout_s
        self.target = 0
        self._procs: dict = {}
        self._reaping: set = set()
        self._next_idx = 0
        # drained replicas' promotion weight + adapter warm-set, queued for
        # the replacement spawn to inherit: a replacement joining at
        # defaults (weight 1.0, cold pool) skews smooth-WRR shares
        # mid-promotion and pays every tenant's load-on-miss again
        self._inherit: List[dict] = []
        self._lock = threading.Lock()
        # serializes whole reconcile passes: drain()/scale() callers (HTTP
        # handler threads) race the supervisor tick, and two concurrent
        # passes would both see live < target and double-spawn a replica
        self._reconcile_lock = threading.Lock()
        os.makedirs(self.workdir, exist_ok=True)
        self._shutdown = threading.Event()
        self._supervisor = None
        if supervise_interval_s > 0:
            self._supervisor = threading.Thread(
                target=self._supervise, args=(supervise_interval_s,),
                daemon=True)
            self._supervisor.start()

    def _next_role(self) -> Optional[str]:
        """The role this spawn should take: the cycle entry furthest
        below its share of the live fleet (ties break in cycle order, so
        a fresh fleet spawns exactly the configured cycle)."""
        if not self.roles:
            return None
        want: dict = {}
        for r in self.roles:
            want[r] = want.get(r, 0) + 1
        live = {r: 0 for r in want}
        for rep in self.pool.replicas():
            role = getattr(rep, "role", "mixed")
            if role in live and not rep.draining:
                live[role] += 1
        return min(want, key=lambda r: (live[r] / want[r],
                                        self.roles.index(r)))

    def spawn(self) -> HTTPReplica:
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        name = f"replica-{idx}"
        port = _free_port()
        role = self._next_role()
        args = list(self.server_args)
        if role:
            args += ["--role", role]
        log = open(os.path.join(self.workdir, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "datatunerx_tpu_torch.serving.server",
             *args, "--device", self.device, "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, cwd=self.workdir,
        )
        with self._lock:
            self._procs[name] = proc
        replica = HTTPReplica(name, f"http://127.0.0.1:{port}",
                              role=role or "mixed")
        replica.healthy = False  # until the health probe sees model loaded
        self._apply_inheritance(replica)
        self.pool.add(replica)
        return replica

    def _apply_inheritance(self, replica: Replica):
        """Hand a freshly-spawned replacement the drained replica's
        promotion weight immediately, and rebuild its adapter warm set
        once it reports healthy (a background thread — the model load is
        minutes, the spawn must not block on it)."""
        with self._lock:
            now = time.monotonic()
            # entries expire: a drain whose replacement never spawned
            # (target dropped meanwhile) must not skew a later scale-up
            self._inherit = [e for e in self._inherit
                             if now - e["t"] < 300.0]
            entry = self._inherit.pop(0) if self._inherit else None
        if entry is None:
            return
        replica.weight = entry["weight"]
        if entry.get("adapters"):
            threading.Thread(
                target=self._warm_replacement,
                args=(replica, dict(entry["adapters"])),
                daemon=True).start()

    def _warm_replacement(self, replica: Replica, adapters: dict):
        deadline = time.monotonic() + max(self.drain_timeout_s, 30.0) + 300.0
        while not self._shutdown.is_set() and time.monotonic() < deadline:
            try:
                if replica.probe_health():
                    break
            except Exception:  # noqa: BLE001 — still booting
                pass
            if self._shutdown.wait(0.2):
                return
        else:
            return
        for name, ckpt in sorted(adapters.items()):
            try:
                replica.preload_adapter(name, ckpt)
            except Exception as e:  # noqa: BLE001 — warm-set is best-effort
                print(f"[gateway] warm-set {name!r} on {replica.name} "
                      f"failed: {e}", flush=True)

    def scale(self, n: int) -> int:
        n = max(0, int(n))
        with self._lock:  # target is read by the supervisor thread
            self.target = n
        self._reconcile()
        return n

    def drain(self, name: str) -> bool:
        """Drain one MANAGED replica for a rolling restart: stop routing to
        it, reap its process once in-flight work finishes, and let the
        supervisor spawn a replacement to hold ``target``."""
        with self._lock:
            managed = name in self._procs
        replica = self.pool.get(name)
        if not managed or replica is None:
            return False
        replica.drain()
        self._start_reap(replica, inherit=True)
        self._reconcile()  # spawn the replacement now, not next tick
        return True

    def _supervise(self, interval: float):
        while not self._shutdown.wait(interval):
            self._reconcile()

    def _reconcile(self):
        """Converge the live managed fleet on ``target``: reap dead
        processes first (a killed replica must not count toward the target,
        or the fleet would stay degraded forever), then spawn/drain."""
        with self._reconcile_lock:
            self._reconcile_locked()

    def _reconcile_locked(self):
        with self._lock:
            dead = [name for name, proc in self._procs.items()
                    if proc.poll() is not None]
            for name in dead:
                self._procs.pop(name, None)
        for name in dead:
            self.pool.remove(name)
        with self._lock:
            managed = set(self._procs)
            target = self.target
        live = []
        for r in self.pool.replicas():
            if r.name not in managed:
                continue
            if r.draining:
                # safety net: however a managed replica got its draining
                # flag (/admin/drain via pool.drain, an operator poking the
                # pool directly), it must end up reaped — draining without
                # a reaper is how zombies used to accumulate. The target is
                # unchanged here, so a replacement will spawn: it inherits.
                self._start_reap(r, inherit=True)
            else:
                live.append(r)
        live.sort(key=lambda r: r.name)
        for _ in range(target - len(live)):
            self.spawn()
        for replica in live[target:][::-1]:  # drain newest-first
            replica.drain()
            self._start_reap(replica)

    def _start_reap(self, replica: HTTPReplica, inherit: bool = False):
        with self._lock:
            if replica.name in self._reaping or replica.name not in self._procs:
                return
            self._reaping.add(replica.name)
        if inherit:
            # snapshot NOW, while the draining replica still answers: the
            # replacement spawn (possibly this same reconcile pass) pops it
            entry = {"weight": float(getattr(replica, "weight", 1.0)),
                     "adapters": None, "t": time.monotonic()}
            try:
                entry["adapters"] = replica.adapter_inventory()
            except Exception:  # noqa: BLE001 — inventory is best-effort
                pass
            with self._lock:
                self._inherit.append(entry)
        threading.Thread(target=self._reap, args=(replica,),
                         daemon=True).start()

    def _reap(self, replica: HTTPReplica):
        try:
            deadline = time.monotonic() + self.drain_timeout_s
            while replica.inflight > 0 and time.monotonic() < deadline:
                time.sleep(0.1)
            self.pool.remove(replica.name)
            with self._lock:
                proc = self._procs.pop(replica.name, None)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
        finally:
            with self._lock:
                self._reaping.discard(replica.name)

    def close(self):
        self._shutdown.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


# ----------------------------------------------------------------------- http
def make_handler(gw: Gateway):
    class Handler(BaseHTTPRequestHandler):
        gateway = gw

        # ------------------------------------------------------------ plumbing
        def _trace_id(self) -> str:
            return (self.headers.get("X-DTX-Trace-Id")
                    or f"dtx-{uuid.uuid4().hex[:16]}")

        def _json(self, code: int, payload: dict, trace_id: str = "",
                  extra_headers: Optional[dict] = None):
            # count BEFORE the body goes out: a client that scrapes
            # /metrics the instant its response arrives must see its own
            # request counted (the code is already terminal here)
            self.gateway.record_request(code)
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace_id:
                self.send_header("X-DTX-Trace-Id", trace_id)
            for k, v in (extra_headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        # -------------------------------------------------------------- GET
        def do_GET(self):
            if self.path == "/healthz":
                if self.gateway.healthy():
                    self._json(200, {
                        "status": "HEALTHY",
                        "replicas": len(self.gateway.pool.replicas()),
                        "available": len(self.gateway.pool.available()),
                    })
                else:
                    self._json(503, {"status": "LOADING"})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": self.gateway.model_name, "object": "model"}]})
            elif self.path == "/autoscale":
                self._json(200, self.gateway.autoscale())
            elif self.path == "/admin/promote":
                status = self.gateway.promotion_status()
                if status is None:
                    self._json(404, {"error": "no promotion started"})
                else:
                    self._json(200, status)
            elif self.path.split("?")[0] == "/metrics":
                # exemplars only on the explicit ?exemplars=1 debug view:
                # the annotation tail is a parse error to a classic
                # Prometheus parser and would fail the WHOLE scrape
                body = self.gateway.metrics_text(
                    with_exemplars=exemplars_requested(self.path)).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/debug/slo":
                self._json(200, self.gateway.slo_report())
            elif self.path == "/debug/fleet":
                if self.gateway.fleet is None:
                    self._json(404, {"error": "fleet plane not enabled"})
                else:
                    self._json(200, self.gateway.fleet.stats())
            elif self.path == "/admin/tenants":
                if self.gateway.tenants is None:
                    self._json(404, {"error": "tenancy plane not enabled"})
                else:
                    self._json(200, {
                        "tenants": self.gateway.tenants.to_dict(),
                        "generation": self.gateway.tenants.generation})
            elif self.path.startswith("/debug/trace/"):
                tid = self.path[len("/debug/trace/"):]
                doc = self.gateway.trace(tid) if tid else None
                if doc is None:
                    self._json(404, {"error": f"no trace {tid!r}"})
                else:
                    self._json(200, doc)
            else:
                self._json(404, {"error": "not found"})

        # ------------------------------------------------------------- POST
        def do_POST(self):
            trace_id = self._trace_id()
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"invalid JSON body: {e}"},
                           trace_id)
                return
            if self.path in ("/chat/completions", "/v1/chat/completions"):
                self._chat(req, trace_id)
            elif self.path == "/perplexity":
                self._perplexity(req, trace_id)
            elif self.path == "/admin/scale":
                self._scale(req, trace_id)
            elif self.path == "/admin/drain":
                self._drain(req, trace_id)
            elif self.path == "/admin/promote":
                self._promote(req, trace_id)
            elif self.path == "/admin/tenants":
                self._tenants_admin(req, trace_id)
            elif self.path == "/debug/profile":
                self._profile(req, trace_id)
            else:
                self._json(404, {"error": "not found"}, trace_id)

        def _session_id(self, req: dict) -> Optional[str]:
            return (self.headers.get("X-DTX-Session-Id")
                    or req.get("session_id") or req.get("user"))

        def _tenant(self, req: dict) -> str:
            return (self.headers.get("X-DTX-Tenant")
                    or req.get("tenant") or "")

        def _chat(self, req: dict, trace_id: str):
            session_id = self._session_id(req)
            try:
                if req.get("stream"):
                    self._chat_sse(req, trace_id, session_id)
                    return
                text = self.gateway.chat(req, trace_id=trace_id,
                                         session_id=session_id,
                                         tenant=self._tenant(req))
                self._json(200, {
                    "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": self.gateway.model_name,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": "stop",
                    }],
                }, trace_id)
            except Overloaded as e:
                self._json(429, {"error": f"overloaded: {e.reason}"},
                           trace_id,
                           {"Retry-After": e.retry_after_s})
            except ValueError as e:
                self._json(400, {"error": str(e)}, trace_id)
            except NoReplicaAvailable as e:
                self._json(503, {"error": str(e)}, trace_id)
            except Exception as e:  # noqa: BLE001 — gateway must answer
                self._json(500, {"error": str(e)}, trace_id)

        def _chat_sse(self, req: dict, trace_id: str,
                      session_id: Optional[str]):
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            try:
                deltas = self.gateway.chat_stream(req, trace_id=trace_id,
                                                  session_id=session_id,
                                                  tenant=self._tenant(req))
                first = next(deltas, None)
            except Overloaded as e:
                self._json(429, {"error": f"overloaded: {e.reason}"},
                           trace_id, {"Retry-After": e.retry_after_s})
                return
            except ValueError as e:
                self._json(400, {"error": str(e)}, trace_id)
                return
            except (NoReplicaAvailable, ReplicaError) as e:
                self._json(503, {"error": str(e)}, trace_id)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-DTX-Trace-Id", trace_id)
            self.end_headers()

            def event(payload: dict):
                self.wfile.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                self.wfile.flush()

            def chunk(delta, finish=None):
                event({
                    "id": rid, "object": "chat.completion.chunk",
                    "created": int(time.time()),
                    "model": self.gateway.model_name,
                    "choices": [{"index": 0,
                                 "delta": ({"content": delta}
                                           if delta is not None else {}),
                                 "finish_reason": finish}],
                })

            code = 200
            try:
                try:
                    if first is not None:
                        chunk(first)
                    for delta in deltas:
                        chunk(delta)
                    chunk(None, finish="stop")
                except Exception as e:  # noqa: BLE001 — headers already sent
                    event({"error": {"message": str(e)}})
                    code = 500
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                code = 499
            self.gateway.record_request(code)

        def _perplexity(self, req: dict, trace_id: str):
            try:
                self._json(200, self.gateway.perplexity(req, trace_id),
                           trace_id)
            except NotImplementedError as e:
                self._json(501, {"error": str(e)}, trace_id)
            except ValueError as e:  # replica judged the request malformed
                self._json(400, {"error": str(e)}, trace_id)
            except NoReplicaAvailable as e:
                self._json(503, {"error": str(e)}, trace_id)
            except Exception as e:  # noqa: BLE001 — replica fault
                self._json(502, {"error": str(e)}, trace_id)

        def _tenants_admin(self, req: dict, trace_id: str):
            gw_t = self.gateway.tenants
            if gw_t is None:
                self._json(404, {"error": "tenancy plane not enabled "
                                          "(start with --tenants_config)"},
                           trace_id)
                return
            name = req.get("name") or ""
            try:
                if req.get("remove"):
                    if not gw_t.remove(name):
                        self._json(404, {"error": f"no tenant {name!r}"},
                                   trace_id)
                        return
                else:
                    entry = {k: v for k, v in req.items()
                             if k in ("tier", "adapters", "share",
                                      "kv_block_quota", "ttft_p95_ms")}
                    gw_t.upsert(name, entry)
            except ValueError as e:
                self._json(400, {"error": str(e)}, trace_id)
                return
            self._json(200, {"tenants": gw_t.to_dict(),
                             "generation": gw_t.generation}, trace_id)

        def _scale(self, req: dict, trace_id: str):
            try:
                n = int(req.get("replicas"))
            except (TypeError, ValueError):
                self._json(400, {"error": "replicas must be an integer"},
                           trace_id)
                return
            try:
                self._json(200, {"replicas": self.gateway.scale(n)}, trace_id)
            except NotImplementedError as e:
                self._json(501, {"error": str(e)}, trace_id)

        def _drain(self, req: dict, trace_id: str):
            name = req.get("replica") or ""
            self.gateway.last_handoff = None
            if self.gateway.drain(name):
                body = {"draining": name}
                if self.gateway.last_handoff is not None:
                    body["handoff"] = self.gateway.last_handoff
                self._json(200, body, trace_id)
            else:
                self._json(404, {"error": f"no replica {name!r}"}, trace_id)

        def _promote(self, req: dict, trace_id: str):
            """Start a canary promotion: {"replica": name, "schedule":
            [w...], "step_s": s, "min_requests": n, "max_error_rate": f,
            "max_latency_ratio": f}. The named replica must already be in
            the pool (spawned from the winning checkpoint). 409 while a
            promotion is active; the 202 body (and later GETs of this
            path) carry the shift state + trace id."""
            name = str(req.get("replica") or "")
            if not name:
                self._json(400, {"error": "replica is required"}, trace_id)
                return
            try:
                promo = self.gateway.start_promotion(name, config=req)
            except ValueError as e:
                code = 409 if "already active" in str(e) else 400
                self._json(code, {"error": str(e)}, trace_id)
                return
            self._json(202, promo.status(), trace_id)

        def _profile(self, req: dict, trace_id: str):
            """Pass a profiling request through to a replica (serving's
            POST /debug/profile); in-process replicas capture the gateway's
            own process."""
            try:
                seconds = float(req.get("seconds", 2.0))
            except (TypeError, ValueError):
                self._json(400, {"error": "seconds must be a number"},
                           trace_id)
                return
            try:
                out = self.gateway.profile(
                    seconds, log_dir=str(req.get("dir") or "") or None,
                    replica_name=str(req.get("replica") or ""))
                self._json(202, out, trace_id)
            except ValueError as e:  # dir escapes the allowed root
                self._json(400, {"error": str(e)}, trace_id)
            except NoReplicaAvailable as e:
                self._json(503, {"error": str(e)}, trace_id)
            except NotImplementedError as e:
                self._json(501, {"error": str(e)}, trace_id)
            except ReplicaError as e:
                # relay the replica's own status (409 conflict, 400 bad
                # dir); no status on the error = the replica itself failed
                code = e.status if e.status in (400, 409) else 502
                self._json(code, {"error": str(e)}, trace_id)

        def log_message(self, *a):
            pass

    return Handler


def serve(gw: Gateway, port: int = 0,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    srv = ThreadingHTTPServer((host, port), make_handler(gw))
    return srv


def main(argv=None):
    p = argparse.ArgumentParser(prog="datatunerx-tpu-torch-gateway")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--policy", default="least_busy",
                   choices=["least_busy", "round_robin"])
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--token_budget", type=int, default=32768,
                   help="estimated queued prefill tokens before shedding")
    p.add_argument("--chars_per_token", type=float, default=4.0,
                   help="admission prefill estimate when no tokenizer is "
                        "available (~4 for English BPE; lower for CJK)")
    p.add_argument("--tokenizer_path", default="",
                   help="model dir or preset:NAME for token-accurate "
                        "admission estimates (defaults to --model_path)")
    p.add_argument("--health_interval", type=float, default=2.0)
    p.add_argument("--trace_ring", type=int, default=256,
                   help="completed request traces kept for "
                        "GET /debug/trace/<id>")
    p.add_argument("--trace_log", default="",
                   help="append every completed gateway span as one JSON "
                        "line to this file (offline trace forensics)")
    p.add_argument("--slo_config", default="",
                   help="JSON file of SLO specs (obs/slo.py format) judged "
                        "at GET /debug/slo; default: the built-in gateway "
                        "availability + latency objectives")
    p.add_argument("--slo_sample_s", type=float, default=15.0,
                   help="background SLO sampling interval so the burn-rate "
                        "windows have history without a /debug/slo poller "
                        "(0 disables the sampler)")
    p.add_argument("--prefill_threshold", type=int, default=0,
                   help="prompts of >= this many tokens PREFER replicas "
                        "declaring role=prefill (shorter prompts prefer "
                        "the rest); 0 (default) disables role-aware "
                        "routing entirely")
    p.add_argument("--fleet_prefix_mb", type=float, default=0.0,
                   help="fleet-shared prefix tier budget in MB: the "
                        "first replica to prefill a shared system prompt "
                        "publishes it and peers import it COW — their "
                        "first matching request prefills zero chunks. "
                        "0 (default) disables the tier")
    p.add_argument("--fleet_handoff", type=int, default=0,
                   help="1: prefill→decode handoff — finished prompt "
                        "work on role=prefill replicas is re-homed onto "
                        "decode peers (and drains ship mid-prefill "
                        "tails); 0 (default) off")
    p.add_argument("--fleet_spill", type=int, default=0,
                   help="1: peer-replica KV spill — preemption-parked "
                        "sessions re-home onto a peer with free blocks "
                        "instead of waiting locally; 0 (default) off")
    p.add_argument("--fleet_interval", type=float, default=1.0,
                   help="fleet coordination tick interval in seconds "
                        "(prefix sync + handoff + spill passes)")
    p.add_argument("--role", default="",
                   help="comma-separated role cycle for spawned replicas "
                        "(e.g. 'prefill,decode' alternates; entries from "
                        "prefill/decode/mixed); empty = all mixed")
    p.add_argument("--tenants_config", default="",
                   help="tenant directory: a JSON file path or inline "
                        "JSON object mapping tenant -> {tier, adapters, "
                        "share, kv_block_quota, ttft_p95_ms}. Enables "
                        "the multi-tenant QoS plane (weighted-fair "
                        "admission, per-tenant KV quotas, pinned adapter "
                        "tiers); empty (default) leaves the gateway "
                        "byte-identical to a tenant-less build")
    p.add_argument("--host_adapter_cache_mb", type=float, default=0.0,
                   help="per-replica host-RAM adapter tier budget in MB "
                        "(spawn mode pass-through): evicted adapters "
                        "re-load from host arrays instead of storage. "
                        "0 (default) disables the tier")
    p.add_argument("--session_handoff", type=int, default=1,
                   help="1 (default): drain exports every in-flight KV "
                        "session from the leaving replica and imports it "
                        "on a peer — rolling restarts drop nothing and "
                        "re-prefill nothing; 0 reverts to cold drain")
    p.add_argument("--replica_url", action="append", default=[],
                   help="front an EXISTING serving server (repeatable); "
                        "mutually exclusive with --replicas spawning")
    p.add_argument("--replicas", type=int, default=0,
                   help="spawn N serving.server subprocesses to front")
    p.add_argument("--workdir", default="",
                   help="replica log directory (spawn mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every spawned replica (spawn "
                        "mode; the port server's --device)")
    # pass-through model flags for spawn mode (mirror serving.server)
    p.add_argument("--model_path", default="")
    p.add_argument("--checkpoint_path", default="")
    p.add_argument("--template", default="llama2")
    p.add_argument("--max_seq_len", type=int, default=1024)
    p.add_argument("--quantization", default="")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--adapters", default="")
    p.add_argument("--adapter_pool", type=int, default=0)
    p.add_argument("--adapter_rank_max", type=int, default=8)
    p.add_argument("--adapter_targets", default="")
    p.add_argument("--kv_quant", default="")
    p.add_argument("--prefix_cache", type=int, default=0)
    p.add_argument("--kv_block_size", type=int, default=0)
    p.add_argument("--kv_blocks", type=int, default=0)
    p.add_argument("--kv_overcommit", default="off",
                   choices=["off", "on"])
    p.add_argument("--spec_draft_config", default="")
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--spec_mode", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--spec_tree", default="")
    p.add_argument("--sampling_epilogue", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--paged_kernel", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--prefill_chunk", type=int, default=256)
    p.add_argument("--prefill_token_budget", type=int, default=0)
    args = p.parse_args(argv)

    if not args.replica_url and args.replicas <= 0:
        p.error("need --replica_url URL(s) or --replicas N with --model_path")
    if args.replicas > 0 and not args.model_path:
        p.error("--replicas spawning requires --model_path")
    roles = [r.strip() for r in args.role.split(",") if r.strip()]
    for r in roles:
        if r not in ("prefill", "decode", "mixed"):
            p.error(f"--role entries must be prefill/decode/mixed, got {r!r}")

    # token-accurate admission (ROADMAP): count prefill tokens with the real
    # tokenizer when one is loadable; otherwise the chars/token heuristic
    count_tokens = None
    tok_src = args.tokenizer_path or args.model_path
    if tok_src:
        from datatunerx_tpu_torch.utils.model_loader import load_tokenizer

        tok = load_tokenizer(tok_src)
        if tok is not None:
            count_tokens = lambda text: len(tok.encode(text))  # noqa: E731
            print(f"[gateway] admission using tokenizer from {tok_src}",
                  flush=True)

    pool = ReplicaPool(health_interval_s=args.health_interval)
    gw = Gateway(pool, policy=args.policy,
                 admission=AdmissionController(
                     max_queue=args.max_queue,
                     token_budget=args.token_budget,
                     chars_per_token=args.chars_per_token,
                     count_tokens=count_tokens),
                 model_name=args.model_path,
                 trace_ring=args.trace_ring,
                 trace_log_path=args.trace_log or None,
                 slos=load_slos(args.slo_config) if args.slo_config else None,
                 session_handoff=bool(args.session_handoff),
                 prefill_threshold=args.prefill_threshold,
                 fleet_prefix_bytes=int(args.fleet_prefix_mb * 1024 * 1024),
                 fleet_handoff=bool(args.fleet_handoff),
                 fleet_spill=bool(args.fleet_spill),
                 tenants=args.tenants_config or None)
    if args.slo_sample_s > 0:
        gw.slo.start(args.slo_sample_s)
    if gw.fleet is not None:
        gw.fleet.start(args.fleet_interval)
    for i, url in enumerate(args.replica_url):
        pool.add(HTTPReplica(f"replica-{i}", url))
    if args.replicas > 0:
        server_args = ["--model_path", args.model_path,
                       "--checkpoint_path", args.checkpoint_path,
                       "--template", args.template,
                       "--max_seq_len", str(args.max_seq_len),
                       "--quantization", args.quantization,
                       "--slots", str(args.slots),
                       "--decode_chunk", str(args.decode_chunk),
                       "--adapters", args.adapters,
                       "--adapter_pool", str(args.adapter_pool),
                       "--adapter_rank_max", str(args.adapter_rank_max),
                       "--adapter_targets", args.adapter_targets,
                       "--kv_quant", args.kv_quant,
                       "--prefix_cache", str(args.prefix_cache),
                       "--kv_block_size", str(args.kv_block_size),
                       "--kv_blocks", str(args.kv_blocks),
                       "--kv_overcommit", args.kv_overcommit,
                       "--paged_kernel", args.paged_kernel,
                       "--spec_draft_config", args.spec_draft_config,
                       "--spec_k", str(args.spec_k),
                       "--spec_mode", args.spec_mode,
                       "--spec_tree", args.spec_tree,
                       "--sampling_epilogue", args.sampling_epilogue,
                       "--prefill_chunk", str(args.prefill_chunk),
                       "--prefill_token_budget",
                       str(args.prefill_token_budget)]
        if args.tenants_config:
            server_args += ["--tenants_config", args.tenants_config]
        if args.host_adapter_cache_mb > 0:
            server_args += ["--host_adapter_cache_mb",
                            str(args.host_adapter_cache_mb)]
        gw.replica_set = ManagedReplicaSet(
            pool, server_args, workdir=args.workdir or "gateway-replicas",
            roles=roles, device=args.device)
        gw.replica_set.scale(args.replicas)

    srv = serve(gw, port=args.port)
    print(f"[gateway] listening on :{args.port} "
          f"({len(pool.replicas())} replicas, policy={args.policy})",
          flush=True)

    def _on_sigterm(signum, frame):
        # SIGTERM (LocalServingBackend.delete, a pod's stop) takes the
        # KeyboardInterrupt path, so the finally below reaps the spawned
        # replicas instead of leaving them holding their devices
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        gw.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
