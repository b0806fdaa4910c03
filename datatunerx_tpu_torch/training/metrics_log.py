"""Training metrics: jsonl logs + Prometheus remote-write (the port of
``datatunerx_tpu/training/metrics_log.py``).

``MetricsLogger`` writes ``<output_dir>/watch/trainer_log.jsonl`` and
``eval_log.jsonl`` with the reference's record keys (``current_steps``,
``total_steps``, ``percentage``, ``elapsed_time``, ``eta`` plus the step's
metrics) and echoes each record to stdout. Each record is also re-stated as
``dtx_train_*`` / ``dtx_eval_*`` gauges in the port's registry
(obs/metrics.py), whose exposition lands in ``watch/metrics.prom``, and,
with ``--metrics_export_address``, POSTed as a snappy-compressed protobuf
WriteRequest to ``{addr}/api/v1/write`` with the run UID as a label. Each
metric is a real timeseries ``dtx_train_<name>{uid=...} value``.

The prefetch-depth advisory watches the logged ``pipe_step_wait_ms``: once
per run, when its p95 over the last records says the step loop waits on the
input pipeline, it suggests a deeper ``--prefetch_depth`` and resizes the
live ``HostPrefetcher`` (``attach_prefetcher``).

Dependency-free wire encoding: a minimal protobuf writer and a literal-only
snappy block encoding (the snappy format allows all-literal streams; any
compliant decompressor accepts it).
"""

from __future__ import annotations

import json
import math
import os
import re
import struct
import time
import urllib.request
from typing import Dict, Optional

from datatunerx_tpu_torch.obs.metrics import (
    Registry,
    sample_percentile,
    set_build_info,
)

# ------------------------------------------------------------------ protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(tag: int, wire: int) -> bytes:
    return _varint((tag << 3) | wire)


def _len_delim(tag: int, payload: bytes) -> bytes:
    return _field(tag, 2) + _varint(len(payload)) + payload


def _label(name: str, value: str) -> bytes:
    return _len_delim(1, name.encode()) + _len_delim(2, value.encode())


def _sample(value: float, ts_ms: int) -> bytes:
    out = _field(1, 1) + struct.pack("<d", value)
    # sint64? Prometheus Sample.timestamp is int64 (not zigzag)
    out += _field(2, 0) + _varint(ts_ms & 0xFFFFFFFFFFFFFFFF)
    return out


def encode_write_request(
    metrics: Dict[str, float], labels: Dict[str, str], ts_ms: Optional[int] = None
) -> bytes:
    """Prometheus WriteRequest: one TimeSeries per metric."""
    ts_ms = ts_ms if ts_ms is not None else int(time.time() * 1000)
    body = b""
    for name, value in metrics.items():
        if value is None or (isinstance(value, float) and math.isnan(value)):
            continue
        series = _len_delim(1, _label("__name__", name))
        for k, v in sorted(labels.items()):
            series += _len_delim(1, _label(k, str(v)))
        series += _len_delim(2, _sample(float(value), ts_ms))
        body += _len_delim(1, series)
    return body


def snappy_compress_literal(data: bytes) -> bytes:
    """Snappy block format with literal-only elements (spec-valid, uncompacted)."""
    out = bytearray(_varint(len(data)))
    i = 0
    while i < len(data):
        chunk = data[i : i + 60]  # literal length <= 60 fits the tag byte
        out.append((len(chunk) - 1) << 2)  # tag 00 = literal
        out += chunk
        i += len(chunk)
    return bytes(out)


def push_remote_write(
    address: str,
    metrics: Dict[str, float],
    labels: Dict[str, str],
    timeout: float = 5.0,
) -> bool:
    """POST to {address}/api/v1/write with the remote-write headers; False
    (never an exception) when the address is unreachable or refuses."""
    payload = snappy_compress_literal(encode_write_request(metrics, labels))
    req = urllib.request.Request(
        address.rstrip("/") + "/api/v1/write",
        data=payload,
        headers={
            "Content-Encoding": "snappy",
            "Content-Type": "application/x-protobuf",
            "X-Prometheus-Remote-Write-Version": "0.1.0",
            "User-Agent": "datatunerx-tpu/0.1",
        },
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return 200 <= resp.status < 300
    except Exception:
        return False  # metrics export must never kill training


# ------------------------------------------------------------------ callback

class MetricsLogger:
    """Per-step logging: stdout + watch/*.jsonl + optional remote-write.

    jsonl field names are the JAX package's: loss, lr, epoch, percentage,
    current_steps, total_steps, elapsed_time, eta;
    eval: eval_loss, perplexity (+ generative rouge/bleu when scored).
    """

    def __init__(
        self,
        output_dir: str,
        total_steps: int,
        metrics_export_address: Optional[str] = None,
        uid: Optional[str] = None,
        registry: Optional[Registry] = None,
        prefetch_depth: Optional[int] = None,
    ):
        self.output_dir = output_dir
        self.total_steps = max(total_steps, 1)
        self.address = metrics_export_address
        self.uid = uid
        self.start = time.time()
        self.watch_dir = os.path.join(output_dir, "watch")
        os.makedirs(self.watch_dir, exist_ok=True)
        # prefetch-depth advisory: watch the logged pipe_step_wait_ms signal
        # and, once per run, suggest a deeper --prefetch_depth when its p95
        # says the step loop is waiting on the input pipeline
        self.prefetch_depth = prefetch_depth
        self.prefetch_advisory: Optional[dict] = None
        self._pipe_waits: list = []
        self._advise_after = int(
            os.environ.get("DTX_PREFETCH_ADVISE_RECORDS", "20"))
        self._advise_ms = float(
            os.environ.get("DTX_PREFETCH_ADVISE_MS", "5.0"))
        # in-run retuning: when the live HostPrefetcher is attached, the
        # advisory doesn't just print — it RESIZES the running prefetcher's
        # bounded queue to the suggested depth (DTX_PREFETCH_RETUNE=0
        # reverts to advise-only)
        self._prefetcher = None
        self._retune = os.environ.get("DTX_PREFETCH_RETUNE", "1") != "0"
        # Shared-registry mirror of the training plane (obs/metrics.py):
        # every logged record re-states dtx_train_*/dtx_eval_* gauges —
        # including the pipeline-health signals pipe_step_wait_ms and
        # pipe_queue_depth (prefetch occupancy) — and the exposition is
        # written to watch/metrics.prom for node-exporter-textfile-style
        # scraping. Purely additive: jsonl,
        # stdout, and remote-write behavior are unchanged.
        self.registry = registry if registry is not None else Registry()
        self._expo_path = os.path.join(self.watch_dir, "metrics.prom")

    def _mirror(self, prefix: str, step: int, metrics: Dict[str, float]):
        set_build_info(self.registry, "training")
        labels = {"uid": self.uid} if self.uid else None
        self.registry.gauge(
            f"{prefix}_step", "Steps completed at the last logged record."
        ).set(step, labels)
        for k, v in metrics.items():
            f = _f(v)
            if math.isnan(f):
                continue
            # jsonl keys like "rouge-1" are not valid metric-name chars
            name = re.sub(r"[^a-zA-Z0-9_]", "_", f"{prefix}_{k}")
            self.registry.gauge(name).set(f, labels)
        # atomic replace: a scraper never reads a half-written exposition
        tmp = self._expo_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(self.registry.expose())
            os.replace(tmp, self._expo_path)
        except OSError:
            pass  # metrics export must never kill training

    def _common(self, step: int) -> Dict:
        elapsed = time.time() - self.start
        rate = elapsed / max(step, 1)
        return {
            "current_steps": step,
            "total_steps": self.total_steps,
            "percentage": round(step / self.total_steps * 100, 2),
            "elapsed_time": round(elapsed, 3),
            "eta": round(rate * max(self.total_steps - step, 0), 3),
        }

    def _write(self, filename: str, record: Dict):
        with open(os.path.join(self.watch_dir, filename), "a") as f:
            f.write(json.dumps(record) + "\n")

    def attach_prefetcher(self, prefetcher) -> None:
        """Hand the logger the LIVE HostPrefetcher (anything with a
        ``resize(depth)``) so the advisory can act in-run instead of only
        suggesting a flag for next time. Re-attach per epoch — the trainer
        rebuilds its prefetcher at epoch boundaries; the current effective
        depth carries over via ``effective_prefetch_depth``."""
        self._prefetcher = prefetcher

    def effective_prefetch_depth(self) -> Optional[int]:
        """The depth the NEXT prefetcher should be built with: the retuned
        value once retuning acted, else the configured depth."""
        adv = self.prefetch_advisory
        if adv and adv.get("retuned"):
            return adv["suggested_prefetch_depth"]
        return self.prefetch_depth

    def _maybe_advise_prefetch(self, metrics: Dict[str, float]):
        """Once per run: when dtx_train_pipe_step_wait_ms p95 over the last
        DTX_PREFETCH_ADVISE_RECORDS logged records exceeds
        DTX_PREFETCH_ADVISE_MS, log a suggested --prefetch_depth (double
        the current depth; 2 when the pipeline ran at an unknown depth)."""
        if self.prefetch_advisory is not None:
            return
        wait = metrics.get("pipe_step_wait_ms")
        if wait is None:
            return
        w = _f(wait)
        if math.isnan(w):
            return
        self._pipe_waits.append(w)
        if len(self._pipe_waits) < self._advise_after:
            return
        window = self._pipe_waits[-self._advise_after:]
        p95 = sample_percentile(window, 0.95)
        if p95 <= self._advise_ms:
            self._pipe_waits = self._pipe_waits[-self._advise_after:]
            return
        depth = self.prefetch_depth
        suggested = depth * 2 if depth else 2
        self.prefetch_advisory = {
            "pipe_step_wait_ms_p95": round(p95, 3),
            "threshold_ms": self._advise_ms,
            "records": len(window),
            "prefetch_depth": depth,
            "suggested_prefetch_depth": suggested,
            "retuned": False,
        }
        # act, don't just advise: resize the live prefetcher's queue to the
        # suggested depth (this epoch benefits; effective_prefetch_depth
        # carries it into the next epoch's prefetcher)
        retuned = False
        if self._retune and self._prefetcher is not None:
            try:
                self._prefetcher.resize(suggested)
                retuned = True
            except Exception:  # noqa: BLE001 — advisory must never kill a run
                pass
        self.prefetch_advisory["retuned"] = retuned
        self.registry.gauge(
            "dtx_train_prefetch_depth_suggested",
            "Advisory: a deeper --prefetch_depth would likely hide input "
            "stalls (0 = no advisory fired).").set(
            suggested, {"uid": self.uid} if self.uid else None)
        acted = (f"; retuned the live prefetcher to depth {suggested}"
                 if retuned else
                 f"; try --prefetch_depth {suggested}")
        print(
            f"[advice] input pipeline stalls: pipe_step_wait_ms p95="
            f"{p95:.1f}ms over the last {len(window)} records exceeds "
            f"{self._advise_ms:g}ms — the step loop is waiting on the "
            f"input path{acted}"
            + (f" (configured {depth})" if depth else ""),
            flush=True)

    def log_train(self, step: int, metrics: Dict[str, float]):
        rec = {**self._common(step), **{k: _f(v) for k, v in metrics.items()}}
        self._write("trainer_log.jsonl", rec)
        self._mirror("dtx_train", step, metrics)
        self._maybe_advise_prefetch(metrics)
        print(f"[train] {json.dumps(rec)}", flush=True)
        if self.address:
            push_remote_write(
                self.address,
                {f"dtx_train_{k}": _f(v) for k, v in metrics.items()},
                {"uid": self.uid or "", "phase": "train"},
            )

    def log_eval(self, step: int, metrics: Dict[str, float]):
        rec = {**self._common(step), **{k: _f(v) for k, v in metrics.items()}}
        self._write("eval_log.jsonl", rec)
        self._mirror("dtx_eval", step, metrics)
        print(f"[eval] {json.dumps(rec)}", flush=True)
        if self.address:
            push_remote_write(
                self.address,
                {f"dtx_eval_{k}": _f(v) for k, v in metrics.items()},
                {"uid": self.uid or "", "phase": "eval"},
            )


def _f(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")
