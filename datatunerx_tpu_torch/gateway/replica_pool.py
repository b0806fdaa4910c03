"""Replica pool: the gateway's inventory of serving replicas.

Two replica flavors share one interface:

  InProcessReplica — wraps an engine object (BatchedEngine/InferenceEngine or
                     any duck-typed stand-in) directly; the test/CI path.
  HTTPReplica      — speaks the serving/server.py wire protocol (POST
                     /chat/completions with SSE streaming, GET /healthz,
                     GET /metrics for slot stats); the production path.

Each replica carries a circuit breaker (closed → open on consecutive
failures → half-open probe after a cooldown → closed on success), replacing
KubeRay's pod-restart-only failure handling with request-level routing
awareness, and a ``draining`` flag for graceful rolling restarts: a draining
replica finishes in-flight requests but receives no new ones.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional

from datatunerx_tpu_torch.obs.metrics import (
    annotation_start,
    sample_percentile,
)


# The error text a migrated-away request dies with (same literal as
# serving/migration.MIGRATED_SESSION — it crosses the wire as an SSE error
# event's plain-text message, so the marker is matched, not typed). A
# ReplicaError carrying it means "this session was exported, splice the
# imported continuation" — not a replica fault.
MIGRATED_MARKER = "session migrated"


class ReplicaError(Exception):
    """A replica failed to serve a request (connection refused, died
    mid-stream, 5xx). The gateway fails over; the breaker records it.

    ``status`` optionally carries the upstream HTTP status (e.g. a
    replica's 409 profile-conflict) so the gateway can relay the real
    code instead of guessing from the message text."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _strip_annotation(line: str) -> str:
    """Drop an OpenMetrics-style trailing annotation (`` # {…} v ts`` —
    exemplars — or any future `` # …`` tail) from an exposition line, so a
    new replica's exemplar-bearing /metrics can't break an older gateway's
    stats scrape (and vice versa in a mixed-version fleet). Quote-aware
    via the shared obs.metrics.annotation_start scanner."""
    pos = annotation_start(line)
    return line if pos < 0 else line[:pos].rstrip()


def _adapter_label(line: str, prefix: str) -> Optional[str]:
    """Extract the adapter label value from a ``<prefix>adapter="x"} 1``
    exposition line with value 1 (0 = series cleared, not a member).
    Walks to the first UNESCAPED quote, undoing the exposition escapes
    (obs.metrics.escape_label_value: \\\\, \\n, \\") as it goes — a tenant
    name containing a quote must not truncate to the wrong name."""
    if not line.startswith(prefix):
        return None
    rest = line[len(prefix):]
    if not rest.startswith('adapter="'):
        return None
    s = rest[len('adapter="'):]
    out: list = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
            continue
        if c == '"':
            break
        out.append(c)
        i += 1
    else:
        return None  # unterminated label value
    try:
        if float(s[i + 1:].rsplit(None, 1)[-1]) != 1:
            return None
    except (ValueError, IndexError):
        return None
    return "".join(out)


def _error_detail(e: "urllib.error.HTTPError") -> str:
    """The serving server's JSON error body (or the bare HTTP reason) —
    the one extraction every HTTPReplica error path shares."""
    try:
        return str(json.load(e).get("error", e.reason))
    except Exception:  # noqa: BLE001 — non-JSON body: the reason is all we have
        return str(e.reason)


def _client_error_message(e: BaseException) -> str:
    # KeyError.__str__ reprs its argument — unwrap so the 400 body reads
    # "unknown adapter 'x'", not "\"unknown adapter 'x'\""
    if isinstance(e, KeyError) and e.args:
        return str(e.args[0])
    return str(e)


class NoReplicaAvailable(Exception):
    """No healthy, non-draining, circuit-closed replica to route to."""


class CircuitBreaker:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._failures = 0
        self._opened_at = 0.0
        self._state = self.CLOSED
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == self.OPEN
                    and time.monotonic() - self._opened_at >= self.cooldown_s):
                self._state = self.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """May a request be routed here? Open circuits reject until the
        cooldown elapses; half-open admits (the probe) — its outcome decides
        between re-open and close."""
        return self.state != self.OPEN

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = time.monotonic()


class Replica:
    """Interface + shared bookkeeping. Subclasses implement ``chat``,
    ``chat_stream``, ``probe_health`` and ``stats``."""

    def __init__(self, name: str, failure_threshold: int = 3,
                 cooldown_s: float = 5.0, role: str = "mixed"):
        self.name = name
        self.breaker = CircuitBreaker(failure_threshold, cooldown_s)
        # disaggregation role: "prefill" (long-prompt specialist), "decode"
        # (steady-state token production), or "mixed" (either — the
        # default, which keeps routing byte-identical to a role-less
        # fleet). HTTP replicas refresh this from their /metrics scrape.
        self.role = role or "mixed"
        self.draining = False
        self.healthy = True  # last health-probe verdict
        self.inflight = 0  # gateway-side in-flight count (least-busy fallback)
        self._inflight_lock = threading.Lock()
        # canary/traffic weight: the router's smooth-WRR share when weights
        # in the candidate set are non-uniform (all-1.0 = policy as before);
        # weight 0 receives no new requests (a rolled-back canary)
        self.weight = 1.0
        # per-replica outcome window: the promotion controller compares the
        # canary's error rate and latency p95 against the fleet's from these
        # (fed by the gateway per attempt, same measurements as the
        # request histograms)
        self.requests_total = 0
        self.errors_total = 0
        self._latency_ms: List[float] = []
        self._outcome_lock = threading.Lock()
        # last completed request's replica-side tokenized prompt length
        # (the serving response's ``usage``): the gateway pops this after
        # each success and calibrates its admission estimator with it
        self._last_usage: Optional[dict] = None

    def note_usage(self, prompt_chars: int, prompt_tokens: int):
        """Record one request's REAL tokenized prompt length (replica-side
        truth) next to the prompt's char count."""
        self._last_usage = {"prompt_chars": int(prompt_chars),
                            "prompt_tokens": int(prompt_tokens)}

    def take_usage(self) -> Optional[dict]:
        usage, self._last_usage = self._last_usage, None
        return usage

    @staticmethod
    def _prompt_chars(messages) -> int:
        return sum(len(str(m.get("content", ""))) for m in messages or [])

    def record_outcome(self, ok: bool, latency_ms: float):
        """One routed attempt's terminal outcome (gateway-side). Client
        errors (4xx/ValueError) are NOT recorded — they say nothing about
        the replica."""
        with self._outcome_lock:
            self.requests_total += 1
            if not ok:
                self.errors_total += 1
            self._latency_ms.append(float(latency_ms))
            if len(self._latency_ms) > 512:
                del self._latency_ms[:256]

    def outcome_stats(self, last_n: Optional[int] = None) -> dict:
        """Rolling outcome summary. ``last_n`` limits the latency p95 to
        the most recent n samples — the promotion guard judges a stage on
        the traffic served DURING it, not on warm-up requests that happen
        to still sit in the rolling window."""
        with self._outcome_lock:
            window = self._latency_ms[-last_n:] if last_n else \
                list(self._latency_ms)
            reqs, errs = self.requests_total, self.errors_total
        return {"requests": reqs, "errors": errs,
                "error_rate": errs / reqs if reqs else 0.0,
                "latency_p95_ms": sample_percentile(window, 0.95)}

    # ------------------------------------------------------------- requests
    def chat(self, messages: List[dict], **kwargs) -> str:
        raise NotImplementedError

    def chat_stream(self, messages: List[dict], **kwargs) -> Iterator[str]:
        raise NotImplementedError

    # --------------------------------------------------------------- health
    def probe_health(self) -> bool:
        raise NotImplementedError

    def stats(self) -> dict:
        """{"slots_busy": int, "slots_total": int, "kv_blocks_free": int,
        "kv_blocks_total": int, "kv_block_size": int,
        "adapters": set|None,
        "resident_adapters": set|None, "spec_enabled": bool,
        "spec_accept_rate": float|None}.
        kv_blocks_total 0 means the replica runs a dense cache (no block
        signal; kv_block_size is then 0 too — fleet-true admission prices
        admits in blocks of kv_block_size tokens when present);
        adapters=None means unknown — the router treats it as
        capable of anything (load-on-demand fallback). resident_adapters
        is the subset already materialised in the replica's pool (static
        stacks: everything it knows) — the router's cache-locality
        preference; None = no residency signal. spec_enabled/_accept_rate
        carry the speculative-decode plane's signal for the router's
        spec-friendly preference (rate None = no observations yet)."""
        raise NotImplementedError

    def stats_snapshot(self) -> dict:
        """Last-known stats WITHOUT doing any fetch work — for observability
        paths (the gateway /metrics scrape handler) that must never block on
        a slow replica. Local replicas answer live; remote replicas return
        whatever the routing/stats path last cached (possibly stale on an
        idle gateway — a stale gauge beats a scrape that hangs 2s per hung
        replica)."""
        return self.stats()

    # --------------------------------------------------- KV migration fabric
    def export_sessions(self, slots: Optional[List[int]] = None,
                        wire: Optional[str] = None,
                        include_prefill: bool = False) -> Optional[dict]:
        """Serialize (and terminate) the replica's in-flight decode
        sessions for handoff. None = the replica kind/engine has no
        migration surface; otherwise {"sessions": [payload...],
        "skipped": [...]}. ``include_prefill`` ships mid-chunked-prefill
        slots too (disaggregated prefill→decode handoff). Raises
        ReplicaError on transport faults."""
        return None

    def import_session(self, payload: dict):
        """Admit an exported session and resume its decode. None =
        unsupported; otherwise ``(meta, stream)`` where ``meta`` carries
        ``text_so_far`` (the detokenized migrated tail) and ``stream``
        yields the continuation deltas. Raises ReplicaError on refusal
        (status 409: no slot / blocks / adapter) or fault."""
        return None

    # ------------------------------------------------------ fleet plane
    def hold_parked(self, max_sessions: int = 4,
                    hold_s: float = 10.0) -> Optional[dict]:
        """Lease preemption-parked sessions for a peer spill (phase 1).
        None = unsupported; otherwise {"sessions": [...], "parked": n}."""
        return None

    def drop_parked(self, trace_ids: List[str]) -> Optional[dict]:
        """Finish a spill (phase 2, success): drop the re-homed sessions
        and terminate their source requests with the migrated marker."""
        return None

    def release_parked(self, trace_ids: List[str]) -> Optional[dict]:
        """Abort a spill (phase 2, failure): clear the leases so the
        sessions resume locally."""
        return None

    def export_prefix_entries(self, exclude: Optional[List[str]] = None,
                              max_entries: int = 4,
                              wire: Optional[str] = None) -> Optional[dict]:
        """Publishable local prefix-cache entries (dtx-kv-prefix payloads)
        for the fleet prefix tier; None = unsupported."""
        return None

    def import_prefix_entry(self, payload: dict) -> Optional[dict]:
        """Install a fleet-published prefix payload into the replica's
        local prefix cache; None = unsupported. Raises ReplicaError on
        refusal (status 409) or fault."""
        return None

    def adapter_inventory(self) -> Optional[Dict[str, str]]:
        """Resident adapter name → checkpoint path (the warm set a
        replacement replica should rebuild); None when unknown."""
        return None

    def preload_adapter(self, name: str, checkpoint: str) -> bool:
        """Register + warm one adapter (warm-set inheritance); False when
        the replica kind can't."""
        return False

    # -------------------------------------------------------- observability
    def fetch_trace(self, trace_id: str) -> Optional[dict]:
        """The replica's span timeline for one trace id (None = unknown or
        unsupported) — the gateway merges this into its own trace view so
        GET /debug/trace/<id> spans gateway→replica→engine."""
        return None

    def start_profile(self, seconds: float,
                      log_dir: Optional[str] = None) -> Optional[dict]:
        """Arm an N-second torch.profiler capture on the replica (None =
        unsupported; raises ReplicaError on a refused/failed capture)."""
        return None

    # ------------------------------------------------------------ lifecycle
    def available(self) -> bool:
        return self.healthy and not self.draining and self.breaker.allow()

    def drain(self):
        self.draining = True

    def undrain(self):
        self.draining = False

    def acquire(self):
        with self._inflight_lock:
            self.inflight += 1

    def release(self):
        with self._inflight_lock:
            self.inflight = max(0, self.inflight - 1)

    def busy_fraction(self) -> float:
        """Load signal for least-busy routing. Paged replicas report KV
        block occupancy — the gauge that actually bounds admission (a free
        slot with no free blocks cannot take work) — combined with slot
        occupancy (no free slot means no admission however many blocks
        remain). Dense replicas fall back to slot occupancy, then to the
        gateway-side in-flight count."""
        st = self.stats()
        slot_total = st.get("slots_total") or 0
        slot_frac = (st.get("slots_busy", 0) / slot_total
                     if slot_total > 0 else None)
        block_total = st.get("kv_blocks_total") or 0
        if block_total > 0:
            block_frac = 1.0 - st.get("kv_blocks_free", 0) / block_total
            return max(block_frac, slot_frac or 0.0)
        if slot_frac is not None:
            return slot_frac
        return float(self.inflight)

    def close(self):
        pass


class InProcessReplica(Replica):
    """Wraps an engine object living in this process — the tier-1 test path
    and single-host `dtx serve --gateway` without subprocess replicas.
    The engine contract is duck-typed: ``chat(messages, **kw) -> str`` and
    optionally ``chat_stream``, ``slots``/``_slot_req``, ``adapter_ids``."""

    def __init__(self, name: str, engine, **kw):
        super().__init__(name, **kw)
        self.engine = engine

    def _trace_kwargs(self, kwargs: dict) -> dict:
        """Engines that keep span timelines (BatchedEngine) take the trace
        id; duck-typed stand-ins get it popped like before. Same rule for
        the tenant tag: only engines running a tenant directory take it."""
        trace_id = kwargs.pop("trace_id", "")
        if trace_id and getattr(self.engine, "trace_store", None) is not None:
            kwargs["trace_id"] = trace_id
        tenant = kwargs.pop("tenant", "")
        if tenant and getattr(self.engine, "tenants", None) is not None:
            kwargs["tenant"] = tenant
        return kwargs

    def _note_engine_usage(self, messages):
        """Tokenize the prompt with the ENGINE's own tokenizer — the same
        count the serving wire's ``usage`` carries — so in-process and
        HTTP replicas feed admission calibration identically."""
        enc = getattr(self.engine, "_encode_chat", None)
        if not callable(enc):
            return
        try:
            ids, _ = enc(messages)
            self.note_usage(self._prompt_chars(messages), len(ids))
        except Exception:  # noqa: BLE001 — usage is advisory
            pass

    def chat(self, messages, **kwargs) -> str:
        kwargs = self._trace_kwargs(kwargs)
        try:
            text = self.engine.chat(messages, **kwargs)
            self._note_engine_usage(messages)
            return text
        except (ValueError, KeyError) as e:
            # the CLIENT's error (unknown adapter, over-length prompt, bad
            # params): same rule as HTTPReplica's 4xx mapping — the replica
            # is fine, don't trip its breaker or fail over; the gateway
            # answers 400, not 503
            raise ValueError(_client_error_message(e)) from e
        except Exception as e:  # noqa: BLE001 — engine fault = replica fault
            raise ReplicaError(f"{self.name}: {e}") from e

    def chat_stream(self, messages, **kwargs):
        kwargs = self._trace_kwargs(kwargs)
        stream_fn = getattr(self.engine, "chat_stream", None)
        if stream_fn is None:
            kwargs.pop("trace_id", None)  # duck-typed chat may not take it
        try:
            if stream_fn is None:
                yield self.engine.chat(messages, **kwargs)
                self._note_engine_usage(messages)
                return
            for delta in stream_fn(messages, **kwargs):
                yield delta
            self._note_engine_usage(messages)
        except ReplicaError:
            raise
        except (ValueError, KeyError) as e:  # client error — no failover
            raise ValueError(_client_error_message(e)) from e
        except Exception as e:  # noqa: BLE001
            raise ReplicaError(f"{self.name}: {e}") from e

    def probe_health(self) -> bool:
        probe = getattr(self.engine, "healthy", None)
        if callable(probe):
            try:
                self.healthy = bool(probe())
            except Exception:  # noqa: BLE001
                self.healthy = False
        else:
            self.healthy = self.engine is not None
        return self.healthy

    # --------------------------------------------------- KV migration fabric
    def export_sessions(self, slots=None, wire=None, include_prefill=False):
        fn = getattr(self.engine, "export_sessions", None)
        if not callable(fn):
            return None
        try:
            if include_prefill:
                return fn(slots=slots, wire_quant=wire, include_prefill=True)
            # older engines lack the kwarg — the default call keeps them
            return fn(slots=slots, wire_quant=wire)
        except Exception as e:  # noqa: BLE001 — export fault = replica fault
            raise ReplicaError(f"{self.name}: export failed: {e}") from e

    def import_session(self, payload: dict):
        fn = getattr(self.engine, "import_session", None)
        if not callable(fn):
            return None
        try:
            meta = dict(fn(dict(payload)))
        except (ValueError, KeyError) as e:
            raise ReplicaError(
                f"{self.name}: import refused: {_client_error_message(e)}",
                status=409) from e
        except Exception as e:  # noqa: BLE001
            raise ReplicaError(f"{self.name}: import failed: {e}") from e
        handle = meta.pop("_request", None)
        return meta, self._guarded_resume(handle)

    def _guarded_resume(self, handle):
        """Map resume-stream faults to ReplicaError like chat_stream does,
        so the gateway's splice failure handling sees one exception type."""
        if handle is None:
            return
        try:
            for delta in self.engine.resume_stream(handle):
                yield delta
        except ReplicaError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ReplicaError(f"{self.name}: resume failed: {e}") from e

    # ------------------------------------------------------ fleet plane
    def _fleet_call(self, attr: str, **kw) -> Optional[dict]:
        """One error-mapping shim for the engine's fleet surface:
        ValueError/KeyError = refusal (409, no failover), anything else =
        replica fault; None when the engine lacks the method."""
        fn = getattr(self.engine, attr, None)
        if not callable(fn):
            return None
        try:
            return fn(**kw)
        except (ValueError, KeyError) as e:
            raise ReplicaError(
                f"{self.name}: {attr} refused: {_client_error_message(e)}",
                status=409) from e
        except Exception as e:  # noqa: BLE001
            raise ReplicaError(f"{self.name}: {attr} failed: {e}") from e

    def hold_parked(self, max_sessions: int = 4,
                    hold_s: float = 10.0) -> Optional[dict]:
        return self._fleet_call("hold_parked", max_sessions=max_sessions,
                                hold_s=hold_s)

    def drop_parked(self, trace_ids: List[str]) -> Optional[dict]:
        return self._fleet_call("drop_parked", trace_ids=trace_ids)

    def release_parked(self, trace_ids: List[str]) -> Optional[dict]:
        return self._fleet_call("release_parked", trace_ids=trace_ids)

    def export_prefix_entries(self, exclude: Optional[List[str]] = None,
                              max_entries: int = 4,
                              wire: Optional[str] = None) -> Optional[dict]:
        return self._fleet_call("export_prefix_entries", exclude=exclude,
                                max_entries=max_entries, wire_quant=wire)

    def import_prefix_entry(self, payload: dict) -> Optional[dict]:
        return self._fleet_call("import_prefix_entry",
                                payload=dict(payload))

    def adapter_inventory(self) -> Optional[Dict[str, str]]:
        catalog_fn = getattr(self.engine, "adapter_catalog", None)
        if not callable(catalog_fn):
            return None
        try:
            catalog = dict(catalog_fn())
        except Exception:  # noqa: BLE001 — inventory is best-effort
            return None
        resident = getattr(self.engine, "resident_adapters", None)
        if resident is not None:
            catalog = {n: c for n, c in catalog.items() if n in resident}
        return catalog or None

    def preload_adapter(self, name: str, checkpoint: str) -> bool:
        loader = getattr(self.engine, "load_adapter", None)
        if not callable(loader):
            return False
        loader(name, checkpoint, preload=True)
        return True

    def fetch_trace(self, trace_id: str) -> Optional[dict]:
        store = getattr(self.engine, "trace_store", None)
        if store is None:
            return None
        return store.get(trace_id)

    def start_profile(self, seconds: float,
                      log_dir: Optional[str] = None) -> Optional[dict]:
        """In-process replica = the gateway's own process, so the capture
        covers the engine's decode/prefill ticks directly. Raises
        ValueError for a dir escaping the allowed root (client error) and
        ReplicaError(status=409) when a capture is already running."""
        from datatunerx_tpu_torch.obs.profiling import (
            process_profiler,
            resolve_profile_dir,
        )

        log_dir = resolve_profile_dir(log_dir)
        try:
            effective = process_profiler().start(log_dir, seconds)
        except Exception as e:  # noqa: BLE001 — profiler fault, not replica
            raise ReplicaError(f"{self.name}: profiler failed: {e}") from e
        if effective is None:
            raise ReplicaError(
                f"{self.name}: a profile capture is already running",
                status=409)
        return {"profiling": log_dir, "seconds": effective,
                "replica": self.name}

    def stats(self) -> dict:
        slot_req = getattr(self.engine, "_slot_req", None)
        busy = (sum(1 for r in slot_req if r is not None)
                if slot_req is not None else 0)
        adapter_ids = getattr(self.engine, "adapter_ids", None)
        # residency: dynamic pools report their live resident set; static
        # stacks ARE resident (weights baked at startup), so everything the
        # engine knows counts — the router's preference degrades gracefully
        resident = getattr(self.engine, "resident_adapters", None)
        if resident is not None:
            resident = set(resident)
        elif adapter_ids is not None:
            resident = set(adapter_ids)
        spec_fn = getattr(self.engine, "spec_info", None)
        try:
            spec_doc = spec_fn() if callable(spec_fn) else None
        except Exception:  # noqa: BLE001 — stats are advisory
            spec_doc = None
        return {
            "slots_busy": busy,
            "slots_total": getattr(self.engine, "slots", 0),
            "kv_blocks_free": getattr(self.engine, "free_kv_blocks", None) or 0,
            "kv_blocks_total": getattr(self.engine, "total_kv_blocks", None) or 0,
            # tokens per block — fleet-true admission prices an admit with
            # this (0 = dense cache, no block signal)
            "kv_block_size": getattr(self.engine, "block_size", 0) or 0,
            "adapters": set(adapter_ids) if adapter_ids is not None else None,
            "resident_adapters": resident,
            # speculative decoding: the router's spec-friendly preference
            # and the gateway's per-replica acceptance gauge read these
            "spec_enabled": bool(spec_doc),
            "spec_accept_rate": (spec_doc or {}).get("accept_rate"),
            # disaggregation: routing role + parked-session count (the
            # spill coordinator's candidate signal)
            "role": self.role,
            "sessions_parked": int(
                getattr(self.engine, "parked_sessions", 0) or 0),
        }

    def close(self):
        closer = getattr(self.engine, "close", None)
        if callable(closer):
            closer()


class HTTPReplica(Replica):
    """A remote serving/server.py process. Requests carry the gateway's
    trace id via the X-DTX-Trace-Id header so a request can be followed
    operator → gateway → replica log."""

    def __init__(self, name: str, base_url: str, timeout: float = 300.0,
                 stats_ttl_s: float = 1.0, **kw):
        super().__init__(name, **kw)
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # stats() is on the ROUTING hot path (least-busy + adapter filter
        # both consult it per request); cache the scrape for a TTL so a slow
        # replica can't add its /metrics round-trip to every routed request
        self.stats_ttl_s = stats_ttl_s
        self._stats_cache: Optional[dict] = None
        self._stats_at = 0.0

    # ------------------------------------------------------------------ http
    def _post(self, path: str, payload: dict, trace_id: str = "",
              tenant: str = ""):
        headers = {"Content-Type": "application/json"}
        if trace_id:
            headers["X-DTX-Trace-Id"] = trace_id
        if tenant:
            headers["X-DTX-Tenant"] = tenant
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(payload).encode(),
            headers=headers, method="POST")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _payload(self, messages, kwargs) -> dict:
        payload = {
            "messages": messages,
            "max_tokens": kwargs.get("max_new_tokens", 128),
            "temperature": kwargs.get("temperature", 0.0),
            "top_p": kwargs.get("top_p", 1.0),
        }
        if kwargs.get("adapter"):
            payload["model"] = kwargs["adapter"]
        return payload

    def _note_wire_usage(self, messages, usage):
        """Feed the serving response's ``usage`` (replica-side tokenized
        prompt length) back — the truthful count gateway admission
        calibrates against instead of the chars-per-token heuristic."""
        if not isinstance(usage, dict):
            return
        try:
            tokens = int(usage.get("prompt_tokens") or 0)
        except (TypeError, ValueError):
            return
        if tokens > 0:
            self.note_usage(self._prompt_chars(messages), tokens)

    def chat(self, messages, **kwargs) -> str:
        trace_id = kwargs.pop("trace_id", "")
        tenant = kwargs.pop("tenant", "")
        try:
            with self._post("/chat/completions",
                            self._payload(messages, kwargs), trace_id,
                            tenant=tenant) as r:
                body = json.load(r)
            self._note_wire_usage(messages, body.get("usage"))
            return body["choices"][0]["message"]["content"]
        except urllib.error.HTTPError as e:
            detail = _error_detail(e)
            # 4xx is the CLIENT's error (bad adapter name, bad body): the
            # replica is fine, don't trip the breaker or fail over
            if 400 <= e.code < 500:
                raise ValueError(detail) from e
            # the detail rides along so markers the gateway matches on
            # (MIGRATED_MARKER) survive a non-streamed 500 crossing the wire
            raise ReplicaError(f"{self.name}: HTTP {e.code}: {detail}") from e
        except (OSError, ValueError, KeyError) as e:
            raise ReplicaError(f"{self.name}: {e}") from e

    def chat_stream(self, messages, **kwargs):
        trace_id = kwargs.pop("trace_id", "")
        tenant = kwargs.pop("tenant", "")
        payload = self._payload(messages, kwargs)
        payload["stream"] = True
        try:
            resp = self._post("/chat/completions", payload, trace_id,
                              tenant=tenant)
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                raise ValueError(f"HTTP {e.code}") from e
            raise ReplicaError(f"{self.name}: HTTP {e.code}") from e
        except OSError as e:
            raise ReplicaError(f"{self.name}: {e}") from e
        try:
            with resp:
                for raw in resp:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        return
                    evt = json.loads(data)
                    if "error" in evt:
                        raise ReplicaError(
                            f"{self.name}: {evt['error'].get('message')}")
                    if "usage" in evt:  # terminal chunk's token truth
                        self._note_wire_usage(messages, evt["usage"])
                    delta = evt["choices"][0]["delta"].get("content")
                    if delta:
                        yield delta
        except ReplicaError:
            raise
        except Exception as e:  # noqa: BLE001 — stream cut = replica fault
            raise ReplicaError(f"{self.name}: stream died: {e}") from e

    def probe_health(self) -> bool:
        try:
            with urllib.request.urlopen(
                    self.base_url + "/healthz", timeout=2) as r:
                self.healthy = json.load(r).get("status") == "HEALTHY"
        except Exception:  # noqa: BLE001
            self.healthy = False
        return self.healthy

    # --------------------------------------------------- KV migration fabric
    def _admin_error(self, e: "urllib.error.HTTPError") -> ReplicaError:
        return ReplicaError(f"{self.name}: {_error_detail(e)}",
                            status=e.code)

    def export_sessions(self, slots=None, wire=None, include_prefill=False):
        body: dict = {}
        if slots is not None:
            body["slots"] = list(slots)
        if wire:
            body["wire"] = wire
        if include_prefill:
            body["prefill"] = True
        try:
            with self._post("/admin/sessions/export", body) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            if e.code == 501:
                return None  # replica build without the migration surface
            raise self._admin_error(e) from e
        except (OSError, ValueError) as e:
            raise ReplicaError(f"{self.name}: export failed: {e}") from e

    # ------------------------------------------------------ fleet plane
    def _fleet_post(self, path: str, body: dict,
                    what: str) -> Optional[dict]:
        """POST a fleet-plane admin call; 501 (or 404 from an older
        serving build) = surface absent → None, like export_sessions."""
        try:
            with self._post(path, body) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            if e.code in (404, 501):
                return None
            raise self._admin_error(e) from e
        except (OSError, ValueError) as e:
            raise ReplicaError(f"{self.name}: {what} failed: {e}") from e

    def hold_parked(self, max_sessions: int = 4,
                    hold_s: float = 10.0) -> Optional[dict]:
        return self._fleet_post("/admin/sessions/hold",
                                {"max_sessions": max_sessions,
                                 "hold_s": hold_s}, "hold_parked")

    def drop_parked(self, trace_ids: List[str]) -> Optional[dict]:
        return self._fleet_post("/admin/sessions/drop",
                                {"trace_ids": list(trace_ids)},
                                "drop_parked")

    def release_parked(self, trace_ids: List[str]) -> Optional[dict]:
        return self._fleet_post("/admin/sessions/release",
                                {"trace_ids": list(trace_ids)},
                                "release_parked")

    def export_prefix_entries(self, exclude: Optional[List[str]] = None,
                              max_entries: int = 4,
                              wire: Optional[str] = None) -> Optional[dict]:
        body: dict = {"max_entries": max_entries}
        if exclude:
            body["exclude"] = list(exclude)
        if wire:
            body["wire"] = wire
        return self._fleet_post("/admin/prefix/export", body,
                                "export_prefix")

    def import_prefix_entry(self, payload: dict) -> Optional[dict]:
        return self._fleet_post("/admin/prefix/import", dict(payload),
                                "import_prefix")

    def import_session(self, payload: dict):
        body = dict(payload)
        body["stream"] = True
        try:
            resp = self._post("/admin/sessions/import", body)
        except urllib.error.HTTPError as e:
            if e.code == 501:
                return None
            raise self._admin_error(e) from e
        except OSError as e:
            raise ReplicaError(f"{self.name}: import failed: {e}") from e
        # first SSE event is the import receipt; the rest is the spliced
        # continuation stream, handed back lazily
        try:
            first = self._next_event(resp)
        except Exception as e:  # noqa: BLE001
            resp.close()
            raise ReplicaError(
                f"{self.name}: import stream died: {e}") from e
        if first is None or "imported" not in first:
            resp.close()
            detail = (first or {}).get("error", {}).get("message", "no receipt")
            raise ReplicaError(f"{self.name}: import failed: {detail}")
        return first["imported"], self._resume_deltas(resp)

    @staticmethod
    def _next_event(resp) -> Optional[dict]:
        for raw in resp:
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                return None
            return json.loads(data)
        return None

    def _resume_deltas(self, resp):
        try:
            with resp:
                while True:
                    evt = self._next_event(resp)
                    if evt is None:
                        return
                    if "error" in evt:
                        raise ReplicaError(
                            f"{self.name}: "
                            f"{evt['error'].get('message')}")
                    delta = evt.get("delta")
                    if delta:
                        yield delta
        except ReplicaError:
            raise
        except Exception as e:  # noqa: BLE001 — stream cut = replica fault
            raise ReplicaError(f"{self.name}: resume died: {e}") from e

    def adapter_inventory(self) -> Optional[Dict[str, str]]:
        try:
            with urllib.request.urlopen(
                    self.base_url + "/admin/adapters", timeout=2) as r:
                doc = json.load(r)
        except Exception:  # noqa: BLE001 — inventory is best-effort
            return None
        checkpoints = doc.get("checkpoints") or {}
        resident = doc.get("resident") or []
        out = {n: checkpoints[n] for n in resident if n in checkpoints}
        return out or None

    def preload_adapter(self, name: str, checkpoint: str) -> bool:
        try:
            with self._post("/admin/adapters",
                            {"name": name, "checkpoint": checkpoint,
                             "load": True}) as r:
                json.load(r)
            return True
        except urllib.error.HTTPError as e:
            raise self._admin_error(e) from e
        except (OSError, ValueError) as e:
            raise ReplicaError(
                f"{self.name}: adapter preload failed: {e}") from e

    def fetch_trace(self, trace_id: str) -> Optional[dict]:
        """GET the replica's half of a trace. Debug path, not routing: a
        short timeout and None on any failure (the gateway still returns
        its own spans)."""
        try:
            with urllib.request.urlopen(
                    self.base_url + "/debug/trace/" + trace_id,
                    timeout=2) as r:
                return json.load(r)
        except Exception:  # noqa: BLE001 — trace fetch is best-effort
            return None

    def start_profile(self, seconds: float,
                      log_dir: Optional[str] = None) -> Optional[dict]:
        payload: dict = {"seconds": seconds}
        if log_dir:
            payload["dir"] = log_dir
        try:
            with self._post("/debug/profile", payload) as r:
                out = json.load(r)
            out["replica"] = self.name
            return out
        except urllib.error.HTTPError as e:
            # carry the replica's real status (409 conflict, 400 bad dir)
            # so the gateway relays it instead of guessing from the text
            raise self._admin_error(e) from e
        except (OSError, ValueError) as e:
            raise ReplicaError(f"{self.name}: {e}") from e

    def stats(self) -> dict:
        now = time.monotonic()
        if (self._stats_cache is not None
                and now - self._stats_at < self.stats_ttl_s):
            return self._stats_cache
        out = {"slots_busy": 0, "slots_total": 0,
               "kv_blocks_free": 0, "kv_blocks_total": 0,
               "kv_block_size": 0, "adapters": None,
               "resident_adapters": None,
               "spec_enabled": False, "spec_accept_rate": None,
               "role": self.role, "sessions_parked": 0}
        try:
            with urllib.request.urlopen(
                    self.base_url + "/metrics", timeout=2) as r:
                for line in r.read().decode().splitlines():
                    # exemplars / unknown trailing annotations are stripped
                    # first: a mixed-version fleet must never break scraping
                    line = _strip_annotation(line)
                    # *_capacity is the older name; *_total accepted so a new
                    # gateway can front not-yet-restarted older replicas
                    if line.startswith("dtx_serving_slots_busy "):
                        out["slots_busy"] = int(float(line.split()[-1]))
                    elif line.startswith(("dtx_serving_slots_capacity ",
                                          "dtx_serving_slots_total ")):
                        out["slots_total"] = int(float(line.split()[-1]))
                    elif line.startswith("dtx_serving_kv_blocks_free "):
                        out["kv_blocks_free"] = int(float(line.split()[-1]))
                    elif line.startswith(("dtx_serving_kv_blocks_capacity ",
                                          "dtx_serving_kv_blocks_total ")):
                        out["kv_blocks_total"] = int(float(line.split()[-1]))
                    elif line.startswith("dtx_serving_kv_block_size "):
                        out["kv_block_size"] = int(float(line.split()[-1]))
                    elif line.startswith("dtx_serving_spec_enabled "):
                        out["spec_enabled"] = float(line.split()[-1]) > 0
                    elif line.startswith("dtx_serving_spec_accept_rate "):
                        out["spec_accept_rate"] = float(line.split()[-1])
                    elif line.startswith("dtx_serving_sessions_parked "):
                        out["sessions_parked"] = int(float(line.split()[-1]))
                    elif line.startswith('dtx_serving_role{role="'):
                        rest = line[len('dtx_serving_role{role="'):]
                        name = rest.split('"', 1)[0]
                        try:
                            if float(line.rsplit(None, 1)[-1]) == 1:
                                out["role"] = name
                                self.role = name  # routing reads the attr
                        except ValueError:
                            pass
                    else:
                        # residency/capability sets from the labeled gauges
                        # (absent series = no signal, stays None)
                        for prefix, key in (
                                ("dtx_serving_adapter_resident{",
                                 "resident_adapters"),
                                ("dtx_serving_adapter_registered{",
                                 "adapters")):
                            name = _adapter_label(line, prefix)
                            if name is not None:
                                if out[key] is None:
                                    out[key] = set()
                                out[key].add(name)
        except Exception:  # noqa: BLE001 — stats are advisory
            pass
        self._stats_cache = out
        self._stats_at = now
        return out

    def stats_snapshot(self) -> dict:
        """Never fetches: the last stats() result (routing keeps it warm
        under any traffic), or all-zeros/unknown before the first fetch."""
        if self._stats_cache is not None:
            return self._stats_cache
        return {"slots_busy": 0, "slots_total": 0,
                "kv_blocks_free": 0, "kv_blocks_total": 0,
                "kv_block_size": 0, "adapters": None,
                "resident_adapters": None,
                "spec_enabled": False, "spec_accept_rate": None,
                "role": self.role, "sessions_parked": 0}


class ReplicaPool:
    """Thread-safe replica set + periodic health checking.

    ``health_interval_s=0`` disables the background thread (tests drive
    ``check_health()`` explicitly)."""

    def __init__(self, replicas: Optional[List[Replica]] = None,
                 health_interval_s: float = 0.0):
        self._replicas: Dict[str, Replica] = {}
        self._lock = threading.Lock()
        for r in replicas or []:
            self._replicas[r.name] = r
        self._shutdown = threading.Event()
        self._thread = None
        if health_interval_s > 0:
            self._thread = threading.Thread(
                target=self._health_loop, args=(health_interval_s,),
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ membership
    def add(self, replica: Replica):
        with self._lock:
            self._replicas[replica.name] = replica

    def remove(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.pop(name, None)

    def get(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(name)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def available(self) -> List[Replica]:
        return [r for r in self.replicas() if r.available()]

    def drain(self, name: str) -> bool:
        r = self.get(name)
        if r is None:
            return False
        r.drain()
        return True

    # --------------------------------------------------------------- health
    def check_health(self):
        for r in self.replicas():
            r.probe_health()

    def _health_loop(self, interval: float):
        while not self._shutdown.wait(interval):
            self.check_health()

    # -------------------------------------------------------------- reports
    def circuit_states(self) -> Dict[str, str]:
        return {r.name: r.breaker.state for r in self.replicas()}

    def close(self):
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for r in self.replicas():
            r.close()
