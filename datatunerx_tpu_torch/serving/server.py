"""Serving HTTP server: OpenAI-ish ``/chat/completions`` + health gating, the
port of ``datatunerx_tpu/serving/server.py`` (its chat surface).

``/healthz`` answers 503 until the model is loaded, then 200 (500 with the
error when loading failed). ``/chat/completions`` and
``/v1/chat/completions`` answer with the same keys as the JAX server, as JSON
or, with ``"stream": true``, as SSE ``chat.completion.chunk`` events ending in
``data: [DONE]``. The engine is the port's paged ``BatchedEngine`` on CUDA
unless ``--device cpu`` is given.

Run::

    python -m datatunerx_tpu_torch.serving.server \\
        --model_path preset:tinyllama-1.1b --kv_block_size 16

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


STATE = ServingState()


class Handler(BaseHTTPRequestHandler):
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
            if STATE.engine is not None:
                self._json(200, {"status": "HEALTHY",
                                 "model": STATE.model_path})
            elif STATE.error:
                self._json(500, {"status": "FAILED", "error": STATE.error})
            else:
                self._json(503, {"status": "LOADING"})
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": STATE.model_path, "object": "model"}]})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path not in ("/chat/completions", "/v1/chat/completions"):
            self._json(404, {"error": "not found"})
            return
        if STATE.engine is None:
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
            adapter = req.get("model") or ""
            if adapter and adapter != STATE.model_path:
                if adapter not in STATE.engine.adapter_ids:
                    self._json(400, {"error":
                                     f"unknown model/adapter {adapter!r}"})
                    return
                kwargs["adapter"] = adapter
            trace = self.headers.get("X-DTX-Trace-Id") or ""
            if trace:
                kwargs["trace_id"] = trace
            usage = self._prompt_usage(messages)
            if req.get("stream"):
                self._stream_chat(messages, kwargs, usage=usage)
                return
            text = STATE.engine.chat(messages, **kwargs)
            body = {
                "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": STATE.model_path,
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

    @staticmethod
    def _prompt_usage(messages) -> Optional[dict]:
        """Replica-side tokenized prompt length."""
        try:
            return {"prompt_tokens": len(STATE.engine._encode_chat(messages)[0])}
        except Exception:  # noqa: BLE001 — usage is advisory
            return None

    @staticmethod
    def _count_tokens(text: str) -> int:
        if not text:
            return 0
        return len(STATE.engine.tokenizer.encode(text,
                                                 add_special_tokens=False))

    def _stream_chat(self, messages, kwargs, usage=None):
        """SSE: one ``data: {chat.completion.chunk}`` event per text delta,
        then a terminal chunk (carrying ``usage``) and ``data: [DONE]``."""
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
                for delta in STATE.engine.chat_stream(messages, **kwargs):
                    event({
                        "id": rid, "object": "chat.completion.chunk",
                        "created": int(time.time()), "model": STATE.model_path,
                        "choices": [{"index": 0,
                                     "delta": {"content": delta},
                                     "finish_reason": None}],
                    })
                terminal = {
                    "id": rid, "object": "chat.completion.chunk",
                    "created": int(time.time()), "model": STATE.model_path,
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
                      slots=4, decode_chunk=8, kv_block_size=0, kv_blocks=0,
                      prefill_chunk=256, prefill_token_budget=0,
                      paged_kernel="auto", sampling_epilogue="auto",
                      device="cuda", seed=0):
    """Build the engine on a background thread; ``/healthz`` flips to 200
    when it is ready (or to 500 with the error)."""
    def _load():
        try:
            from datatunerx_tpu_torch.serving.batched_engine import (
                BatchedEngine,
            )

            STATE.model_path = model_path
            STATE.engine = BatchedEngine(
                model_path, template=template, max_seq_len=max_seq_len,
                slots=slots, decode_chunk=decode_chunk,
                kv_block_size=kv_block_size, kv_blocks=kv_blocks or None,
                paged_kernel=paged_kernel or "auto",
                sampling_epilogue=sampling_epilogue or "auto",
                prefill_chunk=prefill_chunk,
                prefill_token_budget=prefill_token_budget,
                device=device, seed=seed)
        except Exception as e:  # noqa: BLE001
            STATE.error = str(e)

    t = threading.Thread(target=_load, daemon=True)
    t.start()
    return t


# flag → (value that means "feature off", ROADMAP Queue 1 item it waits for)
_REFUSED = {
    "checkpoint_path": ("", "item 3 (adapters and tenancy)"),
    "quantization": ("", "item 9 (QLoRA and serve-time quantization)"),
    "adapters": ("", "item 3 (adapters and tenancy)"),
    "adapter_pool": (0, "item 3 (adapters and tenancy)"),
    "adapter_targets": ("", "item 3 (adapters and tenancy)"),
    "kv_quant": ("", "item 4 (int8 KV cache)"),
    "prefix_cache": (0, "item 2 (prefix cache and KV overcommit)"),
    "kv_overcommit": ("off", "item 2 (prefix cache and KV overcommit)"),
    "spec_draft_config": ("", "item 5 (speculative decoding)"),
    "spec_tree": ("", "item 5 (speculative decoding)"),
    "role": ("mixed", "item 6 (migration and the fleet plane)"),
    "tenants_config": ("", "item 3 (adapters and tenancy)"),
    "host_adapter_cache_mb": (0.0, "item 3 (adapters and tenancy)"),
    "trace_log": ("", "item 12 (tooling)"),
    "slo_config": ("", "item 12 (tooling)"),
}


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
                   help="continuous-batching cache slots (>= 2)")
    p.add_argument("--decode_chunk", type=int, default=8,
                   help="tokens per decode chunk (admission latency bound)")
    p.add_argument("--adapters", default="")
    p.add_argument("--adapter_pool", type=int, default=0)
    p.add_argument("--adapter_rank_max", type=int, default=8)
    p.add_argument("--adapter_targets", default="")
    p.add_argument("--kv_quant", default="", choices=["", "int8"])
    p.add_argument("--prefix_cache", type=int, default=0)
    p.add_argument("--kv_block_size", type=int, default=0,
                   help="paged KV cache block size in tokens (required: the "
                        "dense cache is not ported yet)")
    p.add_argument("--kv_blocks", type=int, default=0,
                   help="total blocks in the paged pool (default "
                        "slots × max_seq_len / kv_block_size)")
    p.add_argument("--kv_overcommit", default="off", choices=["off", "on"])
    p.add_argument("--paged_kernel", default="auto",
                   choices=["auto", "on", "off"],
                   help="paged attention CUDA kernels: auto = on under CUDA, "
                        "on = force (their plain versions on the CPU), off = "
                        "the gather path")
    p.add_argument("--spec_draft_config", default="")
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--spec_mode", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--spec_tree", default="")
    p.add_argument("--sampling_epilogue", default="auto",
                   choices=["auto", "on", "off"],
                   help="fused sampling CUDA kernel: auto = on under CUDA, "
                        "on = force (its plain version on the CPU), off = "
                        "the legacy sampler")
    p.add_argument("--prefill_chunk", type=int, default=256)
    p.add_argument("--prefill_token_budget", type=int, default=0)
    p.add_argument("--role", default="mixed",
                   choices=["prefill", "decode", "mixed"])
    p.add_argument("--tenants_config", default="")
    p.add_argument("--host_adapter_cache_mb", type=float, default=0.0)
    p.add_argument("--trace_ring", type=int, default=256)
    p.add_argument("--trace_log", default="")
    p.add_argument("--slo_config", default="")
    p.add_argument("--slo_sample_s", type=float, default=15.0)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the JAX server's flags; refuse those whose feature the port
    does not carry yet, and a single-slot server (the dense single-request
    engine is not ported)."""
    p = build_parser()
    args = p.parse_args(argv)
    for flag, (off, item) in _REFUSED.items():
        if getattr(args, flag) != off:
            p.error(f"--{flag} is not ported to the PyTorch server yet "
                    f"(ROADMAP Queue 1 {item})")
    if args.slots < 2:
        p.error("--slots < 2 selects the single-request engine, which is not "
                "ported yet (ROADMAP Queue 1 item 1 (dense cache))")
    if args.kv_block_size <= 0:
        p.error("--kv_block_size 0 selects the dense cache, which is not "
                "ported yet (ROADMAP Queue 1 item 1 (dense cache)); serve "
                "with --kv_block_size 16")
    return args


def start(args: argparse.Namespace) -> ThreadingHTTPServer:
    """Start loading the engine and return the bound (not yet serving) HTTP
    server; ``serve_forever`` is the caller's."""
    load_engine_async(
        args.model_path, template=args.template, max_seq_len=args.max_seq_len,
        slots=args.slots, decode_chunk=args.decode_chunk,
        kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
        prefill_chunk=args.prefill_chunk,
        prefill_token_budget=args.prefill_token_budget,
        paged_kernel=args.paged_kernel,
        sampling_epilogue=args.sampling_epilogue,
        device=args.device, seed=args.seed)
    return ThreadingHTTPServer((args.host, args.port), Handler)


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
