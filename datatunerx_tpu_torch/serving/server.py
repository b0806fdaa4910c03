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
``--role`` declares the replica's disaggregation role. ``GET /metrics``
carries the fleet gauges a gateway scrapes (busy slots, free KV blocks,
parked sessions, the role), under the JAX server's names.

Run::

    python -m datatunerx_tpu_torch.serving.server \\
        --model_path preset:tinyllama-1.1b --kv_block_size 16 \\
        --prefix_cache 8 --kv_overcommit on

The flag names are the JAX server's. Flags whose feature is not ported yet
are refused at startup with the ROADMAP item they wait for.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class ServingState:
    def __init__(self):
        self.engine = None
        self.error: Optional[str] = None
        self.model_path = ""
        # the disaggregation role this replica declares to the fleet
        self.role = "mixed"


STATE = ServingState()


class Handler(BaseHTTPRequestHandler):
    # the served state; ``start(args, state=...)`` binds a handler class to
    # another, so that one process can serve two engines
    state = STATE

    def _json(self, code: int, payload: dict):
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
        else:
            self._json(404, {"error": "not found"})

    def _metrics(self):
        """The fleet gauges of ``/metrics``, under the JAX server's names:
        what a gateway's ``HTTPReplica`` scrapes to place sessions (busy
        slots, free KV blocks, parked sessions and the declared role). The
        rest of the JAX server's exposition waits for ROADMAP Queue 1 item
        12."""
        eng = self.state.engine
        gauges = []
        if eng is not None and hasattr(eng, "_slot_req"):
            gauges += [
                ("slots_busy", "Cache slots holding an in-flight request.",
                 sum(1 for r in eng._slot_req if r is not None)),
                ("slots_capacity", "Configured cache slots.", eng.slots)]
        if eng is not None and getattr(eng, "total_kv_blocks", None):
            gauges += [
                ("kv_blocks_free", "Free paged KV-cache blocks.",
                 eng.free_kv_blocks),
                ("kv_blocks_capacity", "Total paged KV-cache blocks.",
                 eng.total_kv_blocks),
                ("kv_block_size", "Tokens per paged KV block.",
                 getattr(eng, "block_size", 0) or 0)]
        gauges.append(("sessions_parked", "Preemption-parked sessions "
                       "awaiting resume.",
                       int(getattr(eng, "parked_sessions", 0) or 0)))
        lines = []
        for name, doc, value in gauges:
            lines += [f"# HELP dtx_serving_{name} {doc}",
                      f"# TYPE dtx_serving_{name} gauge",
                      f"dtx_serving_{name} {value}"]
        lines += ["# HELP dtx_serving_role Replica disaggregation role, "
                  "one-hot by label (prefill / decode / mixed).",
                  "# TYPE dtx_serving_role gauge",
                  f'dtx_serving_role{{role="{self.state.role}"}} 1']
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
                      state=None):
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


# flag → (value that means "feature off", ROADMAP Queue 1 item it waits for)
_REFUSED = {
    "trace_log": ("", "item 12 (tooling)"),
    "slo_config": ("", "item 12 (tooling)"),
}


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
    p.add_argument("--trace_ring", type=int, default=256)
    p.add_argument("--trace_log", default="")
    p.add_argument("--slo_config", default="")
    p.add_argument("--slo_sample_s", type=float, default=15.0)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the JAX server's flags; refuse those whose feature the port
    does not carry yet."""
    p = build_parser()
    args = p.parse_args(argv)
    for flag, (off, item) in _REFUSED.items():
        if getattr(args, flag) != off:
            p.error(f"--{flag} is not ported to the PyTorch server yet "
                    f"(ROADMAP Queue 1 {item})")
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
    a second engine on another port."""
    state = state or STATE
    state.role = args.role
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
        host_adapter_cache_mb=args.host_adapter_cache_mb, state=state)
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
        if STATE.engine is not None:
            STATE.engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
