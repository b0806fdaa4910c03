"""Serving HTTP server: OpenAI-ish ``/chat/completions``, ``/perplexity`` and
health gating, the port of ``datatunerx_tpu/serving/server.py`` (its chat and
scoring surface).

``/healthz`` answers 503 until the model is loaded, then 200 (500 with the
error when loading failed). ``/chat/completions`` and
``/v1/chat/completions`` answer with the same keys as the JAX server, as JSON
or, with ``"stream": true``, as SSE ``chat.completion.chunk`` events ending in
``data: [DONE]``. ``/perplexity`` takes ``{"prompt", "completion"[,
"model"]}`` and answers the completion's NLL and perplexity (dataset
scoring's perplexity metric POSTs it).

The engine runs on CUDA unless ``--device cpu`` is given. With ``--slots``
above 1 and no ``--quantization`` it is the port's ``BatchedEngine``: over
the dense cache by default (``--kv_block_size 0``), over the paged block pool
with ``--kv_block_size N`` (the paged attention kernels), with ``--kv_quant
int8`` over an int8 cache on either layout, with ``--prefix_cache N`` reusing
prefilled prompts and with ``--kv_overcommit on`` (paged) growing block
tables on demand. ``--slots 1`` or a serve-time ``--quantization
int8|int4|nf4`` selects the single-request ``InferenceEngine``, as in the
JAX server; flags only the batched engine carries are then refused.

Tuned models: ``--checkpoint_path`` serves a trained run (its
``checkpoints`` directory or a step of it): the batched engine serves the
adapter under the name ``"default"`` (requests name it in ``"model"``; a
request without one gets the base model, as in the reference), the
single-request engine merges it. ``--adapters name=ckpt[,name=ckpt...]``
stacks several adapters on one base; ``--adapter_pool N`` loads them into N
device slots at runtime instead (``--adapter_rank_max``,
``--adapter_targets``, ``--host_adapter_cache_mb``), managed through
``GET``/``POST /admin/adapters`` and ``DELETE /admin/adapters/<name>``.
``--tenants_config`` (a JSON file or inline JSON) turns on the tenancy
plane; the ``X-DTX-Tenant`` header names a request's tenant.

Session migration and the fleet plane (``serving/migration.py``,
``fleet/``): ``POST /admin/sessions/export`` serializes live sessions
(``{"slots", "wire", "prefill"}``) and ``/admin/sessions/import`` admits
one and answers with SSE (``{"imported": meta}``, ``{"delta": text}``
events, ``[DONE]``) or, with ``"stream": false``, one JSON body;
``/admin/sessions/{hold,drop,release}`` lease preempted sessions to a
peer-spill coordinator; ``/admin/prefix/{export,import}`` move prefix-cache
entries. A refusal answers 409, an engine without the surface (the
single-request engine) 501, a timeout or an unloaded model 503.
``--role`` declares the replica's disaggregation role.

Observability (``obs/``): ``GET /metrics`` is the JAX server's exposition
under the same names, help text and label sets — the engine's TTFT, TPOT,
prefill-chunk, adapter-load and spec accept-length histograms, and the
scrape-time families: slots and KV blocks, prefix cache, preemptions, role
and parked sessions, the adapter pool and its residency set, the spec
family, session export/import counters, tenancy, build info, uptime and
the ``dtx_slo_*`` verdicts. ``/metrics?exemplars=1`` adds the trace-id
exemplars (the plain wire leaves them out, for classic parsers). ``GET
/debug/trace/<id>`` answers a request's span (404 for an unknown id; the
ring holds ``--trace_ring`` traces and ``--trace_log`` appends each span to
a JSONL file). ``GET /debug/slo`` judges ``--slo_config`` (a file or inline
JSON; default the built-in serving objectives), sampled every
``--slo_sample_s`` seconds. ``POST /debug/profile {"seconds", "dir"}``
opens a ``torch.profiler`` window over the process (202 with the clamped
window; 400 for a bad ``seconds`` or a ``dir`` outside ``DTX_PROFILE_DIR``;
409 while a window is open; 500 when the profiler fails to start) and
writes ``<dir>/trace.json``, a Chrome trace.

Run::

    python -m datatunerx_tpu_torch.serving.server \\
        --model_path preset:tinyllama-1.1b --kv_block_size 16 \\
        --prefix_cache 8 --kv_overcommit on

The flag names are the JAX server's.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from datatunerx_tpu_torch.obs.metrics import (
    Registry,
    adapter_load_histogram,
    exemplars_requested,
    serving_latency_histograms,
    set_build_info,
    set_uptime,
    spec_accept_len_histogram,
)
from datatunerx_tpu_torch.obs.slo import SLOEvaluator, default_slos


class ServingState:
    def __init__(self):
        self.engine = None
        self.error: Optional[str] = None
        self.model_path = ""
        # the disaggregation role this replica declares to the fleet
        self.role = "mixed"
        # the server's ONE registry: the engine's histograms record into
        # it and every scrape re-states its gauges there
        self.registry = Registry()
        self.started_at = time.monotonic()
        # serializes scrape-time restating (concurrent scrapes would race
        # clear/set on the labeled series)
        self.scrape_lock = threading.Lock()
        # the SLO evaluator over the registry, built on first use unless
        # start() installed a --slo_config set
        self.slo: Optional[SLOEvaluator] = None
        self.slo_lock = threading.Lock()


STATE = ServingState()

# ceiling on slot-labeled series per family in the exposition: slots are a
# small fixed pool, so this never binds on a healthy engine — it is a guard
# against unbounded label cardinality if a spec_info document goes wrong
_SLOT_SERIES_CAP = 1024


def slo_evaluator(state: Optional[ServingState] = None) -> SLOEvaluator:
    """The server's evaluator, created on first use with the default
    serving objectives unless start() already installed a configured one."""
    state = state or STATE
    with state.slo_lock:
        if state.slo is None:
            state.slo = SLOEvaluator(state.registry, default_slos("serving"))
        return state.slo


def metrics_text(with_exemplars: bool = True,
                 state: Optional[ServingState] = None) -> str:
    """The /metrics body: scrape-time gauges re-stated into the shared
    registry next to the engine's live histograms, the JAX server's bytes
    for the same engine state. The HTTP wire defaults to
    ``with_exemplars=False`` (classic-parser safety); ``/metrics?exemplars=1``
    opts in."""
    state = state or STATE
    with state.scrape_lock:
        return _metrics_text_locked(state, with_exemplars)


def _metrics_text_locked(state: "ServingState",
                         with_exemplars: bool = True) -> str:
    reg = state.registry
    eng = state.engine
    set_build_info(reg, "serving")
    set_uptime(reg, "serving", state.started_at)
    # dtx_slo_* verdict gauges: sample FIRST so window baselines advance
    # under scrape-only deployments (no /debug/slo poller, no sampler)
    ev = slo_evaluator(state)
    ev.sample()
    ev.restate_gauges(ev.evaluate())
    # declare the serving latency histograms even before the engine loads:
    # a scraper sees stable series from the first scrape (zero counts), and
    # an engine sharing this registry observes into these same objects
    # (one declaration site in obs.metrics — help text cannot diverge)
    serving_latency_histograms(reg)
    reg.gauge("dtx_serving_up", "1 once the model is fully loaded.").set(
        1 if eng is not None else 0)
    stats = getattr(eng, "prefill_stats", None)
    pf = reg.counter("dtx_serving_prefill_total",
                     "Admissions by prefill kind (full/reuse/extend).")
    # engine-derived series are re-stated per scrape — cleared first so a
    # swapped/reloaded engine can't leave stale samples behind
    hits = reg.counter("dtx_serving_prefix_cache_hits_total",
                       "Exact prefix-cache hits (prefill skipped).")
    partial = reg.counter("dtx_serving_prefix_cache_partial_hits_total",
                          "Strict-prefix hits (suffix-only prefill).")
    misses = reg.counter("dtx_serving_prefix_cache_misses_total",
                         "Full prefills.")
    evictions = reg.counter("dtx_serving_prefix_cache_evictions_total",
                            "Prefix-cache LRU evictions.")
    for c in (pf, hits, partial, misses, evictions):
        c.clear()
    if stats is not None:
        for kind, n in sorted(stats.items()):
            pf.set(n, {"kind": kind})
        # hit = exact reuse, partial = suffix extension, miss = full;
        # .get so a partially-populated stats dict (engine mid-init or a
        # duck-typed test engine) can't 500 the scrape
        hits.set(stats.get("reuse", 0))
        partial.set(stats.get("extend", 0))
        misses.set(stats.get("full", 0))
    prefix = getattr(eng, "_prefix", None)
    entries = reg.gauge("dtx_serving_prefix_cache_entries",
                        "Live prefix-cache entries.")
    entries.clear()
    if prefix is not None:
        entries.set(len(prefix))
        evictions.set(prefix.evictions)
    slots_busy = reg.gauge("dtx_serving_slots_busy",
                           "Cache slots holding an in-flight request.")
    # _capacity, not _total: the Prometheus _total suffix is reserved for
    # counters, and these are gauges (the gateway's scrape parser also
    # accepts the older dtx_serving_{slots,kv_blocks}_total names)
    slots_total = reg.gauge("dtx_serving_slots_capacity",
                            "Configured cache slots.")
    slots_busy.clear()
    slots_total.clear()
    if eng is not None and hasattr(eng, "_slot_req"):
        slots_busy.set(sum(1 for r in eng._slot_req if r is not None))
        slots_total.set(eng.slots)
    # paged KV cache: FREE BLOCKS are the real admission headroom (the
    # gateway prefers this gauge over free slots — a slot is cheap, the
    # blocks behind it are not)
    blocks_free = reg.gauge("dtx_serving_kv_blocks_free",
                            "Free paged KV-cache blocks.")
    blocks_total = reg.gauge("dtx_serving_kv_blocks_capacity",
                             "Total paged KV-cache blocks.")
    blocks_reserved = reg.gauge("dtx_serving_kv_blocks_reserved",
                                "Allocated paged KV-cache blocks (slots' "
                                "tables + COW prefix-cache entries).")
    block_size_g = reg.gauge("dtx_serving_kv_block_size",
                             "Tokens per paged KV block — the unit the "
                             "gateway's fleet-true admission prices "
                             "admits in.")
    over_ratio = reg.gauge("dtx_serving_kv_overcommit_ratio",
                           "Live sessions' eager-equivalent block demand "
                           "over the physical pool (> 1 = overcommitted; "
                           "only meaningful with --kv_overcommit on).")
    preempt = reg.counter("dtx_serving_preemptions_total",
                          "KV-overcommit preemptions by outcome (exported "
                          "= session parked host-side, resumed = parked "
                          "session re-admitted token-exactly, "
                          "requeued_prefill = mid-prefill admission "
                          "rolled back to the cold queue).")
    blocks_free.clear()
    blocks_total.clear()
    blocks_reserved.clear()
    block_size_g.clear()
    over_ratio.clear()
    preempt.clear()
    if getattr(eng, "total_kv_blocks", None):
        blocks_free.set(eng.free_kv_blocks)
        blocks_total.set(eng.total_kv_blocks)
        reserved = getattr(eng, "kv_blocks_reserved", None)
        if reserved is None:
            reserved = eng.total_kv_blocks - eng.free_kv_blocks
        blocks_reserved.set(reserved)
        block_size_g.set(getattr(eng, "block_size", 0) or 0)
        ratio = getattr(eng, "kv_overcommit_ratio", None)
        if ratio is not None:
            over_ratio.set(ratio)
    pstats = getattr(eng, "preempt_stats", None)
    if isinstance(pstats, dict):
        for outcome, np_ in sorted(pstats.items()):
            preempt.set(np_, {"outcome": outcome})
    # disaggregated fleet plane: the role this replica declares (one-hot
    # label the gateway's role-aware routing scrapes) and the parked-
    # session backlog the fleet spill coordinator treats as work
    role_g = reg.gauge("dtx_serving_role",
                       "Replica disaggregation role, one-hot by label "
                       "(prefill / decode / mixed).")
    parked_g = reg.gauge("dtx_serving_sessions_parked",
                         "Preemption-parked sessions awaiting resume — "
                         "the fleet spill coordinator's work signal.")
    role_g.clear()
    role_g.set(1, {"role": state.role})
    parked_g.set(int(getattr(eng, "parked_sessions", 0) or 0))
    # dynamic adapter pool (adapters/): occupancy, the
    # residency set the gateway's cache-locality routing scrapes, and
    # per-adapter traffic. Declared/cleared on every scrape so a swapped
    # engine or an unloaded adapter can't leave stale series behind.
    adapter_load_histogram(reg)  # stable series even pre-engine-load
    pool_cap = reg.gauge("dtx_serving_adapter_pool_slots_capacity",
                         "Adapter pool slots (loadable adapters resident "
                         "at once; the base model is not a slot).")
    pool_free = reg.gauge("dtx_serving_adapter_pool_slots_free",
                          "Adapter pool slots holding no adapter.")
    resident_g = reg.gauge("dtx_serving_adapter_resident",
                           "1 per adapter resident in the pool "
                           "(load-on-miss already paid).")
    registered_g = reg.gauge("dtx_serving_adapter_registered",
                             "1 per adapter this replica can serve "
                             "(resident or loadable on miss).")
    a_loads = reg.counter("dtx_serving_adapter_loads_total",
                          "Adapters materialised into pool slots "
                          "(checkpoint load + device insert).")
    a_evict = reg.counter("dtx_serving_adapter_evictions_total",
                          "Unpinned residents LRU-evicted to make room.")
    a_hits = reg.counter("dtx_serving_adapter_hits_total",
                         "Admissions whose adapter was already resident.")
    a_miss = reg.counter("dtx_serving_adapter_misses_total",
                         "Admissions that had to load their adapter.")
    a_reqs = reg.counter("dtx_serving_adapter_requests_total",
                         "Requests per adapter name ('' = base model).")
    for m in (pool_cap, pool_free, resident_g, registered_g, a_loads,
              a_evict, a_hits, a_miss, a_reqs):
        m.clear()
    occ_fn = getattr(eng, "adapter_occupancy", None)
    occ = occ_fn() if callable(occ_fn) else None
    if occ:
        pool_cap.set(occ.get("slots", 0))
        pool_free.set(occ.get("free", 0))
        for name in occ.get("resident_adapters") or []:
            resident_g.set(1, {"adapter": name})
        for name in occ.get("registered_adapters") or []:
            registered_g.set(1, {"adapter": name})
        a_loads.set(occ.get("loads", 0))
        a_evict.set(occ.get("evictions", 0))
        a_hits.set(occ.get("hits", 0))
        a_miss.set(occ.get("misses", 0))
    # speculative decoding: proposal/acceptance counters + the acceptance-
    # rate EMAs (global, per adapter, per slot) the gateway's spec-friendly
    # routing reads. Declared every scrape (stable zero series on non-spec
    # engines), restated from the engine's spec_info document.
    spec_accept_len_histogram(reg)  # engine observes into this same object
    sp_enabled = reg.gauge("dtx_serving_spec_enabled",
                           "1 when speculative decoding is configured "
                           "(a draft model is loaded).")
    sp_active = reg.gauge("dtx_serving_spec_active",
                          "1 while the adaptive controller is actually "
                          "drafting (0 = fallen back to plain decode).")
    sp_k = reg.gauge("dtx_serving_spec_k",
                     "Current proposal depth k (adaptive, <= --spec_k).")
    sp_rate = reg.gauge("dtx_serving_spec_accept_rate",
                        "Global acceptance-rate EMA (accepted/proposed "
                        "per verify step).")
    sp_rate_adapter = reg.gauge("dtx_serving_spec_adapter_accept_rate",
                                "Acceptance-rate EMA per adapter name "
                                "('' = base model).")
    sp_rate_slot = reg.gauge("dtx_serving_spec_slot_accept_rate",
                             "Acceptance-rate EMA per live cache slot.")
    sp_prop = reg.counter("dtx_serving_spec_proposed_total",
                          "Draft tokens proposed to the verifier.")
    sp_acc = reg.counter("dtx_serving_spec_accepted_total",
                         "Proposed tokens the target accepted.")
    sp_steps = reg.counter("dtx_serving_spec_steps_total",
                           "Decode programs run by path (spec = draft/"
                           "verify, plain = pending-form fallback).")
    # tree-draft families: declared every scrape like the rest (stable
    # zeros on chain-only engines), restated from spec_info()["tree"]
    sp_tree_steps = reg.counter("dtx_serving_spec_tree_steps_total",
                                "Verify steps that ran the tree-draft "
                                "program (vs chain draft/verify).")
    sp_tree_width = reg.gauge("dtx_serving_spec_tree_width",
                              "Current tree branch width per draft depth "
                              "(learned/adaptive, <= the --spec_tree W; "
                              "label depth is 1-based).")
    sp_tree_depth = reg.gauge("dtx_serving_spec_tree_depth",
                              "Configured tree draft depth D (0 = chain "
                              "drafts).")
    sp_tree_path = reg.gauge("dtx_serving_spec_tree_slot_path_len",
                             "Accepted root-to-leaf path length EMA per "
                             "live cache slot.")
    # fused sampling epilogue (K9, ops/cuda_sampling.py): resolved mode +
    # decode ticks by sampler path, which say which path actually ran. The
    # help text is the JAX server's, byte for byte, so a fleet of both
    # packages aggregates one family
    sp_epilogue = reg.gauge("dtx_serving_sampling_epilogue",
                            "Fused sampling epilogue state: 0 = off "
                            "(legacy host sampler), 1 = on via the XLA "
                            "oracle, 2 = on via the Pallas kernel.")
    sp_fused = reg.counter("dtx_serving_sampling_fused_steps_total",
                           "Decode/spec ticks by sampler path (fused = "
                           "on-chip epilogue, legacy = host argsort).")
    for m in (sp_enabled, sp_active, sp_k, sp_rate, sp_rate_adapter,
              sp_rate_slot, sp_prop, sp_acc, sp_steps, sp_tree_steps,
              sp_tree_width, sp_tree_depth, sp_tree_path, sp_epilogue,
              sp_fused):
        m.clear()
    spec_fn = getattr(eng, "spec_info", None)
    spec_doc = spec_fn() if callable(spec_fn) else None
    sp_enabled.set(1 if spec_doc else 0)
    if spec_doc:
        sp_active.set(1 if spec_doc.get("active") else 0)
        sp_k.set(spec_doc.get("k", 0))
        if spec_doc.get("accept_rate") is not None:
            sp_rate.set(spec_doc["accept_rate"])
        for name, v in sorted(
                (spec_doc.get("adapter_accept_rate") or {}).items()):
            sp_rate_adapter.set(v, {"adapter": name})
        # per-slot series are pruned on slot release engine-side; the cap
        # here bounds exposition cardinality even if an engine misbehaves
        for slot, v in sorted(
                (spec_doc.get("slot_accept_rate") or {}).items()
                )[:_SLOT_SERIES_CAP]:
            sp_rate_slot.set(v, {"slot": str(slot)})
        sp_prop.set(spec_doc.get("proposed", 0))
        sp_acc.set(spec_doc.get("accepted", 0))
        sp_steps.set(spec_doc.get("spec_steps", 0), {"path": "spec"})
        sp_steps.set(spec_doc.get("plain_steps", 0), {"path": "plain"})
        sp_tree_steps.set(spec_doc.get("tree_steps", 0))
        tree_doc = spec_doc.get("tree")
        if tree_doc:
            widths = (tree_doc.get("widths") or
                      [tree_doc.get("plan_width", 0)])
            for j, w in enumerate(widths):
                sp_tree_width.set(w, {"depth": str(j + 1)})
            sp_tree_depth.set(tree_doc.get("depth", 0))
            for slot, v in sorted(
                    (tree_doc.get("slot_path_len") or {}).items()
                    )[:_SLOT_SERIES_CAP]:
                sp_tree_path.set(v, {"slot": str(slot)})
    # the fused epilogue runs in plain decode too, spec or not — restate
    # from the engine, not the spec document
    impl = getattr(eng, "_epilogue_impl", "off")
    sp_epilogue.set({"off": 0, "xla": 1, "kernel": 2}.get(impl, 0))
    samp_stats = getattr(eng, "sampling_stats", None)
    if isinstance(samp_stats, dict):
        sp_fused.set(samp_stats.get("fused_steps", 0), {"path": "fused"})
        sp_fused.set(samp_stats.get("legacy_steps", 0), {"path": "legacy"})
    # KV migration fabric: session export/import outcomes (restated from
    # the engine's scheduler-thread counters, cleared first like the rest)
    s_exp = reg.counter("dtx_serving_session_export_total",
                        "Live decode sessions exported for replica-to-"
                        "replica handoff, by outcome.")
    s_imp = reg.counter("dtx_serving_session_import_total",
                        "Exported sessions imported (re-prefill-free "
                        "resume), by outcome.")
    s_exp.clear()
    s_imp.clear()
    sess_stats = getattr(eng, "session_stats", None)
    if isinstance(sess_stats, dict):
        for outcome, n in sorted((sess_stats.get("export") or {}).items()):
            s_exp.set(n, {"outcome": outcome})
        for outcome, n in sorted((sess_stats.get("import") or {}).items()):
            s_imp.set(n, {"outcome": outcome})
    # multi-tenant QoS plane: per-tenant usage + the host-RAM adapter
    # tier's load split. BOTH families are created only when their plane
    # is configured — a tenancy-less engine's scrape stays byte-identical
    # to one without the plane.
    usage_fn = getattr(eng, "tenant_usage", None)
    usage = usage_fn() if callable(usage_fn) else None
    if usage is not None:
        t_reqs = reg.counter("dtx_serving_tenant_requests_total",
                             "Requests per tenant ('' = anonymous).")
        t_toks = reg.counter("dtx_serving_tenant_tokens_total",
                             "Tokens per tenant by direction (in = "
                             "prompt, out = generated).")
        t_blocks = reg.gauge("dtx_serving_tenant_kv_blocks",
                             "Live paged KV blocks held by the tenant's "
                             "in-flight sessions.")
        t_res = reg.gauge("dtx_serving_tenant_adapters_resident",
                          "The tenant's adapters currently resident in "
                          "the pool.")
        t_tier = reg.gauge("dtx_serving_tenant_tier",
                           "Tenant tier, one-hot by label "
                           "(pinned / standard / bulk).")
        for m in (t_reqs, t_toks, t_blocks, t_res, t_tier):
            m.clear()
        for tname, row in sorted(usage.items()):
            lbl = {"tenant": tname}
            t_reqs.set(row.get("requests", 0), lbl)
            t_toks.set(row.get("tokens_in", 0),
                       {"tenant": tname, "direction": "in"})
            t_toks.set(row.get("tokens_out", 0),
                       {"tenant": tname, "direction": "out"})
            if "kv_blocks" in row:
                t_blocks.set(row["kv_blocks"], lbl)
            if "adapters_resident" in row:
                t_res.set(row["adapters_resident"], lbl)
            if row.get("tier"):
                t_tier.set(1, {"tenant": tname, "tier": row["tier"]})
    host_fn = getattr(getattr(eng, "adapter_registry", None),
                      "host_tier_stats", None)
    host = host_fn() if callable(host_fn) else None
    if host is not None:
        h_hits = reg.counter("dtx_serving_adapter_host_hits_total",
                             "Adapter loads served from the host-RAM "
                             "tier (no orbax read).")
        h_orbax = reg.counter("dtx_serving_adapter_orbax_loads_total",
                              "Adapter loads that paid the orbax "
                              "checkpoint read.")
        h_evict = reg.counter("dtx_serving_adapter_host_evictions_total",
                              "Host-tier entries evicted to fit newer "
                              "weights under the byte budget.")
        h_bytes = reg.gauge("dtx_serving_adapter_host_bytes",
                            "Bytes of adapter weights cached in the "
                            "host-RAM tier.")
        h_entries = reg.gauge("dtx_serving_adapter_host_entries",
                              "Adapters cached in the host-RAM tier.")
        for m in (h_hits, h_orbax, h_evict, h_bytes, h_entries):
            m.clear()
        h_hits.set(host.get("host_hits", 0))
        h_orbax.set(host.get("orbax_loads", 0))
        h_evict.set(host.get("evictions", 0))
        h_bytes.set(host.get("bytes", 0))
        h_entries.set(host.get("entries", 0))
    # per-adapter demand: prefer the occupancy doc's LOCK-GUARDED copy
    # (dynamic engines); static engines snapshot under the engine's own
    # lock — copying the live dict bare would race a concurrent submit
    reqs = (occ or {}).get("requests")
    if reqs is None:
        raw = getattr(eng, "adapter_requests", None)
        if raw:
            lock = getattr(eng, "_adapter_req_lock", None)
            if lock is not None:
                with lock:
                    reqs = dict(raw)
            else:
                reqs = dict(raw)
    for name, n in sorted((reqs or {}).items()):
        a_reqs.set(n, {"adapter": name})
    return reg.expose(with_exemplars=with_exemplars)




class Handler(BaseHTTPRequestHandler):
    # the served state; ``start(args, state=...)`` binds a handler class to
    # another, so that one process can serve two engines
    state = STATE

    def _json(self, code: int, payload: dict):
        # counted BEFORE the body goes out, so a scrape racing the response
        # sees its own request
        self.state.registry.counter(
            "dtx_serving_requests_total",
            "Requests by terminal HTTP code (gateway-parity naming).").inc(
            {"code": str(code)})
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        trace = self.headers.get("X-DTX-Trace-Id")
        if trace:
            self.send_header("X-DTX-Trace-Id", trace)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            if self.state.engine is not None:
                self._json(200, {"status": "HEALTHY",
                                 "model": self.state.model_path})
            elif self.state.error:
                self._json(500, {"status": "FAILED", "error": self.state.error})
            else:
                self._json(503, {"status": "LOADING"})
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.state.model_path, "object": "model"}]})
        elif self.path == "/admin/adapters":
            self._adapters_get()
        elif self.path.split("?")[0] == "/metrics":
            self._metrics()
        elif self.path == "/debug/slo":
            self._json(200, slo_evaluator(self.state).report(
                plane="serving"))
        elif self.path.startswith("/debug/trace/"):
            self._debug_trace(self.path[len("/debug/trace/"):])
        else:
            self._json(404, {"error": "not found"})

    def _metrics(self):
        """The Prometheus exposition of the shared registry; exemplar
        annotations only on the ``?exemplars=1`` view (classic parsers
        reject the tail)."""
        body = metrics_text(
            with_exemplars=exemplars_requested(getattr(self, "path", "")),
            state=self.state).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # ----------------------------------------------------------- debugging
    def _debug_trace(self, trace_id: str):
        """A request's span from the engine's trace ring (the replica half
        of the gateway's ``GET /debug/trace/<id>`` merge)."""
        store = getattr(self.state.engine, "trace_store", None)
        doc = store.get(trace_id) if store is not None and trace_id else None
        if doc is None:
            self._json(404, {"error": f"no trace {trace_id!r}"})
        else:
            self._json(200, doc)

    def _debug_profile(self, req: dict):
        """Open a ``torch.profiler`` window of ``seconds`` over the process
        (one at a time). The engine's ticks run inside ``dtx_engine_*``
        ranges, so the Chrome trace at ``<dir>/trace.json`` reads like the
        scheduler's own timeline, with the kernels under them."""
        from datatunerx_tpu_torch.obs.profiling import (
            process_profiler,
            resolve_profile_dir,
        )

        try:
            seconds = float(req.get("seconds", 2.0))
        except (TypeError, ValueError):
            self._json(400, {"error": "seconds must be a number"})
            return
        try:
            log_dir = resolve_profile_dir(str(req.get("dir") or ""))
        except ValueError as e:  # dir escapes the allowed root
            self._json(400, {"error": str(e)})
            return
        try:
            effective = process_profiler().start(log_dir, seconds)
        except Exception as e:  # noqa: BLE001 — profiler fault ≠ server fault
            self._json(500, {"error": f"profiler failed to start: {e}"})
            return
        if effective is None:
            self._json(409, {"error": "a profile capture is already running",
                             "active": process_profiler().status()})
            return
        # echo the CLAMPED window, not the request — what will actually run
        self._json(202, {"profiling": log_dir, "seconds": effective})

    # ---------------------------------------- session migration, fleet plane
    def _read_json(self) -> Optional[dict]:
        """The request's JSON body, or None after answering 400."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"invalid JSON body: {e}"})
            return None

    def _engine_fn(self, attr: str):
        """The engine's ``attr`` method, or None after answering 503 (no
        model) or 501 (an engine without the surface)."""
        eng = self.state.engine
        if eng is None:
            self._json(503, {"error": "model not loaded"})
            return None
        fn = getattr(eng, attr, None)
        if not callable(fn):
            self._json(501, {"error": f"engine has no {attr}"})
            return None
        return fn

    def _fleet_admin(self, attr: str, kwargs: dict, refusals=True):
        """One engine call of the session/fleet surface: a refusal
        (ValueError, KeyError) answers 409 where ``refusals`` (else 500, as
        the reference's export route), a timeout 503."""
        fn = self._engine_fn(attr)
        if fn is None:
            return
        try:
            self._json(200, fn(**kwargs))
        except (ValueError, KeyError) as e:
            self._json(409 if refusals else 500, {"error": str(e)})
        except TimeoutError as e:
            self._json(503, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — serving must answer
            self._json(500, {"error": str(e)})

    def _sessions_export(self, req: dict):
        """``{"slots": [..]?, "wire": "bf16"|"int8"?, "prefill": bool?}``:
        serialize (and finish) in-flight sessions; ``prefill`` ships
        mid-chunked-prefill slots too."""
        kw = {"slots": req.get("slots"),
              "wire_quant": req.get("wire") or None}
        if req.get("prefill"):
            kw["include_prefill"] = True
        self._fleet_admin("export_sessions", kw, refusals=False)

    def _sessions_hold(self, req: dict):
        """``{"max_sessions", "hold_s"}``: lease parked sessions for a peer
        spill (phase 1)."""
        self._fleet_admin("hold_parked", {
            "max_sessions": int(req.get("max_sessions", 4)),
            "hold_s": float(req.get("hold_s", 10.0))})

    def _sessions_drop(self, req: dict):
        """``{"trace_ids"}``: the spilled sessions landed on a peer."""
        self._fleet_admin("drop_parked", {
            "trace_ids": list(req.get("trace_ids") or [])})

    def _sessions_release(self, req: dict):
        """``{"trace_ids"}``: the spill failed; resume them here."""
        self._fleet_admin("release_parked", {
            "trace_ids": list(req.get("trace_ids") or [])})

    def _prefix_export(self, req: dict):
        """``{"max_entries", "exclude": [fingerprint..], "wire"?}``: the
        prefix-cache entries to publish to the fleet's prefix tier."""
        self._fleet_admin("export_prefix_entries", {
            "exclude": req.get("exclude") or None,
            "max_entries": int(req.get("max_entries", 4)),
            "wire_quant": req.get("wire") or None})

    def _prefix_import(self, req: dict):
        """A dtx-kv-prefix payload: install it in the prefix cache."""
        self._fleet_admin("import_prefix_entry", {"payload": dict(req)})

    def _sessions_import(self, req: dict):
        """A dtx-kv-session payload: admit it and resume its decode. SSE by
        default (``{"imported": meta}``, then ``{"delta": text}`` past the
        migrated tail, then ``[DONE]``); ``"stream": false`` waits for the
        session and answers ``{"imported": meta}`` with its ``text`` and
        ``error``."""
        fn = self._engine_fn("import_session")
        if fn is None:
            return
        stream = bool(req.pop("stream", True))
        try:
            meta = dict(fn(req))
        except (ValueError, KeyError) as e:
            self._json(409, {"error": str(e)})
            return
        except TimeoutError as e:
            self._json(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — serving must answer
            self._json(500, {"error": str(e)})
            return
        eng = self.state.engine
        handle = meta.pop("_request", None)
        if not stream:
            if handle is not None:
                handle.done.wait(300)
                meta["error"] = handle.error
                meta["text"] = eng.tokenizer.decode(
                    handle.tokens, skip_special_tokens=True)
            self._json(200, {"imported": meta})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def event(payload: dict):
            self.wfile.write(b"data: " + json.dumps(payload).encode()
                             + b"\n\n")
            self.wfile.flush()

        try:
            event({"imported": meta})
            try:
                if handle is not None:
                    for delta in eng.resume_stream(handle):
                        event({"delta": delta})
            except Exception as e:  # noqa: BLE001 — headers already sent
                event({"error": {"message": str(e)}})
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass

    # ------------------------------------------------- dynamic adapter plane
    def _adapters_get(self):
        """The replica's adapters: registered names, the resident set and
        pool occupancy with load/evict/hit/miss stats. An engine without a
        pool reports its fixed names."""
        eng = self.state.engine
        if eng is None:
            self._json(503, {"error": "model not loaded"})
            return
        occ_fn = getattr(eng, "adapter_occupancy", None)
        occ = occ_fn() if callable(occ_fn) else None
        if occ is None:
            ids = getattr(eng, "adapter_ids", None)
            names = sorted(n for n in (ids or {}) if n)
            self._json(200, {"dynamic": False, "registered": names,
                             "resident": names})
            return
        self._json(200, {
            "dynamic": True,
            "registered": occ.pop("registered_adapters", []),
            "resident": occ.pop("resident_adapters", []),
            "pool": occ,
        })

    def _adapters_post(self, req: dict):
        """POST /admin/adapters {"name", "checkpoint"[, "load": bool]}:
        register an adapter at runtime, warmed into a pool slot unless
        ``load`` is false. 400 on a geometry violation or a bad checkpoint,
        409 on a live-name conflict or an exhausted pool, 501 on an engine
        without a pool."""
        from datatunerx_tpu_torch.adapters import AdapterPinnedError

        eng = self.state.engine
        if eng is None:
            self._json(503, {"error": "model not loaded"})
            return
        name = str(req.get("name") or "")
        ckpt = str(req.get("checkpoint") or "")
        if not name or not ckpt:
            self._json(400, {"error": "name and checkpoint are required"})
            return
        loader = getattr(eng, "load_adapter", None)
        if not callable(loader):
            self._json(501, {"error": "engine has no dynamic adapter pool"})
            return
        try:
            self._json(200, loader(name, ckpt,
                                   preload=bool(req.get("load", True))))
        except NotImplementedError as e:  # a static stack
            self._json(501, {"error": str(e)})
        except (AdapterPinnedError, RuntimeError) as e:  # retryable
            self._json(409, {"error": str(e)})
        except (ValueError, FileNotFoundError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — serving must answer
            self._json(500, {"error": str(e)})

    def _adapters_delete(self, name: str):
        """DELETE /admin/adapters/<name>: evict and unregister; 404 for an
        unknown name, 409 while in-flight requests pin it."""
        from datatunerx_tpu_torch.adapters import AdapterPinnedError

        eng = self.state.engine
        if eng is None:
            self._json(503, {"error": "model not loaded"})
            return
        unloader = getattr(eng, "unload_adapter", None)
        if not callable(unloader):
            self._json(501, {"error": "engine has no dynamic adapter pool"})
            return
        try:
            if unloader(name):
                self._json(200, {"unloaded": name})
            else:
                self._json(404, {"error": f"no adapter {name!r}"})
        except NotImplementedError as e:
            self._json(501, {"error": str(e)})
        except AdapterPinnedError as e:
            self._json(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            self._json(500, {"error": str(e)})

    def do_DELETE(self):
        if self.path.startswith("/admin/adapters/"):
            self._adapters_delete(self.path[len("/admin/adapters/"):])
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path == "/perplexity":
            self._perplexity()
            return
        admin = {
            "/admin/sessions/export": self._sessions_export,
            "/admin/sessions/import": self._sessions_import,
            "/admin/sessions/hold": self._sessions_hold,
            "/admin/sessions/drop": self._sessions_drop,
            "/admin/sessions/release": self._sessions_release,
            "/admin/prefix/export": self._prefix_export,
            "/admin/prefix/import": self._prefix_import,
            "/admin/adapters": self._adapters_post,
            "/debug/profile": self._debug_profile,
        }
        if self.path in admin:
            req = self._read_json()
            if req is None:
                return
            try:
                admin[self.path](req)
            except (AttributeError, TypeError, ValueError) as e:
                # a body that is no object, or a field of the wrong type,
                # fails before the route answers
                self._json(400, {"error": f"malformed request: {e}"})
            return
        if self.path not in ("/chat/completions", "/v1/chat/completions"):
            self._json(404, {"error": "not found"})
            return
        if self.state.engine is None:
            self._json(503, {"error": "model not loaded"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._json(400, {"error": f"invalid JSON body: {e}"})
                return
            messages = req.get("messages")
            if not isinstance(messages, list) or not messages:
                self._json(400, {"error": "messages must be a non-empty list"})
                return
            kwargs = dict(
                max_new_tokens=int(req.get("max_tokens", 128)),
                temperature=float(req.get("temperature", 0.0)),
                top_p=float(req.get("top_p", 1.0)),
            )
            # "model" names an adapter; the served model's own path is
            # the base model
            model = req.get("model") or ""
            try:
                kwargs["adapter"] = self.state.engine.adapter_for(
                    "" if model == self.state.model_path else model)
            except KeyError:
                self._json(400, {"error": f"unknown model/adapter {model!r}"})
                return
            kwargs["trace_id"] = self.headers.get("X-DTX-Trace-Id") or ""
            # the tenant goes only to engines running a directory
            tenant = self.headers.get("X-DTX-Tenant") or ""
            if tenant and getattr(self.state.engine, "tenants", None) is not None:
                kwargs["tenant"] = tenant
            usage = self._prompt_usage(messages)
            if req.get("stream"):
                self._stream_chat(messages, kwargs, usage=usage)
                return
            text = self.state.engine.chat(messages, **kwargs)
            body = {
                "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.state.model_path,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": "stop",
                }],
            }
            if usage is not None:
                usage["completion_tokens"] = self._count_tokens(text)
                usage["total_tokens"] = (usage["prompt_tokens"]
                                         + usage["completion_tokens"])
                body["usage"] = usage
            self._json(200, body)
        except Exception as e:  # noqa: BLE001 - serving must answer, not die
            self._json(500, {"error": str(e)})

    def _perplexity(self):
        """POST {"prompt": str, "completion": str[, "model": adapter]} →
        the completion's NLL and perplexity under the served model."""
        if self.state.engine is None:
            self._json(503, {"error": "model not loaded"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            prompt = req.get("prompt") or ""
            completion = req.get("completion") or ""
            if not completion:
                self._json(400, {"error": "completion is required"})
                return
            tok = self.state.engine.tokenizer
            p_ids = tok.encode(prompt) if prompt else []
            c_ids = tok.encode(completion, add_special_tokens=False)
            model = req.get("model") or ""
            try:
                adapter = self.state.engine.adapter_for(model)
            except KeyError:
                self._json(400, {"error": f"unknown model/adapter {model!r}"})
                return
            self._json(200, self.state.engine.perplexity(p_ids, c_ids,
                                                    adapter=adapter))
        except Exception as e:  # noqa: BLE001
            self._json(500, {"error": str(e)})

    def _prompt_usage(self, messages) -> Optional[dict]:
        """Replica-side tokenized prompt length."""
        try:
            return {"prompt_tokens": len(self.state.engine._encode_chat(messages)[0])}
        except Exception:  # noqa: BLE001 — usage is advisory
            return None

    def _count_tokens(self, text: str) -> int:
        if not text:
            return 0
        return len(self.state.engine.tokenizer.encode(text,
                                                 add_special_tokens=False))

    def _stream_chat(self, messages, kwargs, usage=None):
        """SSE: one ``data: {chat.completion.chunk}`` event per text delta,
        then a terminal chunk (carrying ``usage``) and ``data: [DONE]``."""
        stream_fn = self.state.engine.chat_stream
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        trace = self.headers.get("X-DTX-Trace-Id")
        if trace:
            self.send_header("X-DTX-Trace-Id", trace)
        self.end_headers()

        def event(payload: dict):
            self.wfile.write(b"data: " + json.dumps(payload).encode() + b"\n\n")
            self.wfile.flush()

        try:
            try:
                for delta in stream_fn(messages, **kwargs):
                    event({
                        "id": rid, "object": "chat.completion.chunk",
                        "created": int(time.time()), "model": self.state.model_path,
                        "choices": [{"index": 0,
                                     "delta": {"content": delta},
                                     "finish_reason": None}],
                    })
                terminal = {
                    "id": rid, "object": "chat.completion.chunk",
                    "created": int(time.time()), "model": self.state.model_path,
                    "choices": [{"index": 0, "delta": {},
                                 "finish_reason": "stop"}],
                }
                if usage is not None:
                    terminal["usage"] = usage
                event(terminal)
            except Exception as e:  # noqa: BLE001 — headers already sent:
                # errors become a terminal SSE event instead
                event({"error": {"message": str(e)}})
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass

    def log_message(self, *a):
        pass


def load_engine_async(model_path, template="llama2", max_seq_len=1024,
                      quantization="", slots=4, decode_chunk=8, kv_quant="",
                      prefix_cache=0, kv_block_size=0, kv_blocks=0,
                      kv_overcommit="off", prefill_chunk=256,
                      prefill_token_budget=0, paged_kernel="auto",
                      sampling_epilogue="auto", device="cuda", seed=0,
                      spec_draft="", spec_k=4, spec_mode="auto",
                      spec_tree="",
                      checkpoint_path="", adapters=None, adapter_pool=0,
                      adapter_rank_max=8, adapter_targets=None,
                      tenants_config="", host_adapter_cache_mb=0.0,
                      trace_ring=256, trace_log_path="", state=None):
    """Build the engine on a background thread into ``state`` (default: the
    module's ``STATE``); ``/healthz`` flips to 200 when it is ready (or to
    500 with the error). ``slots > 1`` without ``quantization`` builds the
    batched engine, anything else the single-request engine (the JAX
    server's rule)."""
    state = state or STATE

    def _load():
        try:
            state.model_path = model_path
            batched = slots > 1 and not quantization
            # refusing beats serving the base model under an adapter's name
            for flag, val in (("--adapters", adapters),
                              ("--adapter_pool", adapter_pool),
                              ("--prefix_cache", prefix_cache),
                              ("--kv_quant", kv_quant),
                              ("--kv_block_size", kv_block_size),
                              ("--kv_overcommit", kv_overcommit == "on"),
                              # only "on" demands the batched paged engine
                              ("--paged_kernel", paged_kernel == "on"),
                              ("--spec_draft_config", spec_draft),
                              ("--spec_tree", spec_tree),
                              # the single-request engine samples plainly
                              ("--sampling_epilogue",
                               sampling_epilogue == "on"),
                              ("--tenants_config", tenants_config),
                              ("--host_adapter_cache_mb",
                               host_adapter_cache_mb)):
                if val and not batched:
                    raise ValueError(
                        f"{flag} requires the batched engine "
                        "(--slots > 1, no --quantization)")
            if batched:
                from datatunerx_tpu_torch.serving.batched_engine import (
                    BatchedEngine,
                )

                state.engine = BatchedEngine(
                    model_path, checkpoint_path or None, adapters=adapters,
                    adapter_pool=adapter_pool,
                    adapter_rank_max=adapter_rank_max,
                    adapter_targets=adapter_targets or None,
                    tenants=tenants_config or None,
                    host_adapter_cache_mb=host_adapter_cache_mb or 0.0,
                    template=template, max_seq_len=max_seq_len,
                    slots=slots, decode_chunk=decode_chunk,
                    kv_quant=kv_quant or None, prefix_cache=prefix_cache,
                    kv_block_size=kv_block_size, kv_blocks=kv_blocks or None,
                    kv_overcommit=kv_overcommit or "off",
                    paged_kernel=paged_kernel or "auto",
                    sampling_epilogue=sampling_epilogue or "auto",
                    spec_draft=spec_draft or None, spec_k=spec_k,
                    spec_mode=spec_mode or "auto",
                    spec_tree=spec_tree or None,
                    prefill_chunk=prefill_chunk,
                    prefill_token_budget=prefill_token_budget,
                    # the server's registry: the engine's histograms land
                    # in the same /metrics exposition
                    registry=state.registry, trace_ring=trace_ring,
                    trace_log_path=trace_log_path or None,
                    device=device, seed=seed)
            else:
                from datatunerx_tpu_torch.serving.engine import (
                    InferenceEngine,
                )

                state.engine = InferenceEngine(
                    model_path, checkpoint_path or None, template=template,
                    max_seq_len=max_seq_len,
                    quantization=quantization or None, device=device,
                    seed=seed)
        except Exception as e:  # noqa: BLE001
            state.error = str(e)

    t = threading.Thread(target=_load, daemon=True)
    t.start()
    return t


def parse_adapters(spec: str) -> dict:
    """``--adapters name=ckpt_path[,name=path...]`` → {name: path}."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, path = part.partition("=")
        if not name or not path:
            raise ValueError(f"bad adapter spec {part!r}; want name=path")
        out[name] = path
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="datatunerx-tpu-torch-serving")
    p.add_argument("--model_path", required=True)
    p.add_argument("--checkpoint_path", default="")
    p.add_argument("--template", default="llama2")
    p.add_argument("--max_seq_len", type=int, default=1024)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (cuda unless the "
                        "caller asks for the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of a preset model's random weights")
    p.add_argument("--quantization", default="",
                   choices=["", "int8", "int4", "nf4"])
    p.add_argument("--slots", type=int, default=4,
                   help="continuous-batching cache slots (1 = the "
                        "single-request engine)")
    p.add_argument("--decode_chunk", type=int, default=8,
                   help="tokens per decode chunk (admission latency bound)")
    p.add_argument("--adapters", default="",
                   help="named LoRA adapters: name=ckpt[,name=ckpt...]; a "
                        "request selects one in its 'model' field")
    p.add_argument("--adapter_pool", type=int, default=0,
                   help="pooled adapters: N device slots that adapters load "
                        "into at runtime (load on miss, LRU eviction, "
                        "/admin/adapters); 0 = the static --adapters stack")
    p.add_argument("--adapter_rank_max", type=int, default=8,
                   help="pool rank ceiling; lower ranks are zero-padded, "
                        "higher ones refused")
    p.add_argument("--adapter_targets", default="",
                   help="pool LoRA targets, comma-separated (default "
                        "q_proj,v_proj)")
    p.add_argument("--kv_quant", default="", choices=["", "int8"],
                   help="KV cache quantization: int8 stores K/V as int8 with "
                        "an f32 scale per head vector (about half the cache "
                        "bytes per token)")
    p.add_argument("--prefix_cache", type=int, default=0,
                   help="LRU entries of reusable prefilled prompts")
    p.add_argument("--kv_block_size", type=int, default=0,
                   help="paged KV cache block size in tokens (0 = the dense "
                        "per-slot cache)")
    p.add_argument("--kv_blocks", type=int, default=0,
                   help="total blocks in the paged pool (default "
                        "slots × max_seq_len / kv_block_size)")
    p.add_argument("--kv_overcommit", default="off", choices=["off", "on"])
    p.add_argument("--paged_kernel", default="auto",
                   choices=["auto", "on", "off"],
                   help="paged attention CUDA kernels: auto = on under CUDA, "
                        "on = force (their plain versions on the CPU), off = "
                        "the gather path")
    p.add_argument("--spec_draft_config", default="",
                   help="speculative decoding draft: a model path, "
                        "preset:<name> (the target's vocabulary), or take:N "
                        "(the target's first N layers); empty = off")
    p.add_argument("--spec_k", type=int, default=4,
                   help="draft proposals per verify step (the adaptive "
                        "controller's ceiling)")
    p.add_argument("--spec_mode", default="auto",
                   choices=["auto", "on", "off"],
                   help="auto = adaptive (shrink k, fall back to plain "
                        "decode when acceptance collapses), on = always "
                        "draft, off = the plain decode path")
    p.add_argument("--spec_tree", default="",
                   help="tree drafts 'WxD' (branch width x depth, e.g. 2x3) "
                        "verified in one forward; needs "
                        "--spec_draft_config")
    p.add_argument("--sampling_epilogue", default="auto",
                   choices=["auto", "on", "off"],
                   help="fused sampling CUDA kernel: auto = on under CUDA, "
                        "on = force (its plain version on the CPU), off = "
                        "the legacy sampler")
    p.add_argument("--prefill_chunk", type=int, default=256)
    p.add_argument("--prefill_token_budget", type=int, default=0)
    p.add_argument("--role", default="mixed",
                   choices=["prefill", "decode", "mixed"],
                   help="disaggregation role declared to the fleet: prefill "
                        "(a long-prompt specialist whose finished prefills a "
                        "handoff coordinator moves to decode replicas), "
                        "decode, or mixed (role-less). Shown on /metrics as "
                        "the dtx_serving_role gauge, which a gateway's "
                        "role-aware routing scrapes")
    p.add_argument("--tenants_config", default="",
                   help="tenant directory: a JSON file or inline JSON "
                        "{tenant: {tier: pinned|standard|bulk, adapters, "
                        "share, kv_block_quota, ttft_p95_ms}}; empty = off")
    p.add_argument("--host_adapter_cache_mb", type=float, default=0.0,
                   help="host-RAM budget for evicted pool adapters (MB); 0 "
                        "= off")
    p.add_argument("--trace_ring", type=int, default=256,
                   help="completed request traces kept for "
                        "GET /debug/trace/<id>")
    p.add_argument("--trace_log", default="",
                   help="append every completed request span as one JSON "
                        "line to this file")
    p.add_argument("--slo_config", default="",
                   help="SLO specs (obs/slo.py format) judged at GET "
                        "/debug/slo: a JSON file or inline JSON; default "
                        "the built-in serving objectives")
    p.add_argument("--slo_sample_s", type=float, default=15.0,
                   help="background SLO sampling interval (0 = sample only "
                        "on /debug/slo and /metrics)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the JAX server's flags."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.paged_kernel == "on" and args.kv_block_size <= 0:
        p.error("--paged_kernel on requires the paged KV cache "
                "(--kv_block_size > 0)")
    try:
        args.adapters = parse_adapters(args.adapters)
    except ValueError as e:
        p.error(str(e))
    args.adapter_targets = [t.strip() for t in args.adapter_targets.split(",")
                            if t.strip()]
    return args


def start(args: argparse.Namespace,
          state: Optional[ServingState] = None) -> ThreadingHTTPServer:
    """Start loading the engine and return the bound (not yet serving) HTTP
    server; ``serve_forever`` is the caller's. ``state`` (default: the
    module's ``STATE``) holds the engine; a fresh one lets a process serve
    a second engine on another port. With ``--slo_sample_s`` above 0 the
    SLO sampler thread starts here; ``state.slo.stop()`` ends it."""
    from datatunerx_tpu_torch.obs.slo import load_slos

    state = state or STATE
    state.role = args.role
    if args.slo_config:
        with state.slo_lock:
            state.slo = SLOEvaluator(state.registry,
                                     load_slos(args.slo_config))
    if args.slo_sample_s > 0:
        slo_evaluator(state).start(args.slo_sample_s)
    load_engine_async(
        args.model_path, template=args.template, max_seq_len=args.max_seq_len,
        quantization=args.quantization, slots=args.slots,
        decode_chunk=args.decode_chunk, kv_quant=args.kv_quant,
        prefix_cache=args.prefix_cache, kv_block_size=args.kv_block_size,
        kv_blocks=args.kv_blocks, kv_overcommit=args.kv_overcommit,
        prefill_chunk=args.prefill_chunk,
        prefill_token_budget=args.prefill_token_budget,
        paged_kernel=args.paged_kernel,
        sampling_epilogue=args.sampling_epilogue,
        spec_draft=args.spec_draft_config, spec_k=args.spec_k,
        spec_mode=args.spec_mode, spec_tree=args.spec_tree,
        device=args.device, seed=args.seed,
        checkpoint_path=args.checkpoint_path, adapters=args.adapters,
        adapter_pool=args.adapter_pool,
        adapter_rank_max=args.adapter_rank_max,
        adapter_targets=args.adapter_targets,
        tenants_config=args.tenants_config,
        host_adapter_cache_mb=args.host_adapter_cache_mb,
        trace_ring=args.trace_ring, trace_log_path=args.trace_log,
        state=state)
    handler = (Handler if state is STATE else
               type("BoundHandler", (Handler,), {"state": state}))
    return ThreadingHTTPServer((args.host, args.port), handler)


def main(argv=None):
    args = parse_args(argv)
    srv = start(args)
    print(f"[serving] listening on {args.host}:{srv.server_address[1]} "
          "(model loading async)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if STATE.slo is not None:
            STATE.slo.stop()
        if STATE.engine is not None:
            STATE.engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
