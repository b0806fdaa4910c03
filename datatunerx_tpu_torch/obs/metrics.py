"""Shared Prometheus metrics registry + correct text exposition (the
port's copy of ``datatunerx_tpu/obs/metrics.py``; the port imports nothing
of the JAX package, and ``expose()`` gives the reference's bytes).

One registry implementation for every plane — the serving server and the
training MetricsLogger build their /metrics (or ``watch/metrics.prom``)
exposition from the classes here, so the format invariants the scraper
relies on hold everywhere: one # TYPE line per metric name preceding all
its samples, no duplicate series, label values escaped per the exposition
spec (backslash, double-quote, newline).

Hot-path discipline: ``Histogram.observe`` and ``Metric.inc`` never read
device tensors — callers observe plain host floats that already crossed
at a designed sync point (token arrival on the engine's host queue, a
perf_counter delta). Recording is a short uncontended lock around dict/int
arithmetic; exposition (the expensive string work) happens only at scrape
time.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, float("inf"))

# Millisecond-scale buckets for the serving latency histograms
# (dtx_serving_ttft_ms / dtx_serving_tpot_ms / dtx_gateway_queue_wait_ms /
# dtx_serving_prefill_chunk_ms). Spans sub-ms decode ticks up to
# multi-second cold prefills; fixed edges so replicas aggregate.
MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0, 30000.0, float("inf"))


def sample_percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over RAW samples (0.0 on empty) — the one
    implementation for every rolling-window quantile (replica outcome
    windows, the prefetch advisory). ``Histogram.percentile`` stays the
    bucketed flavor for exported histograms; this is for in-memory sample
    lists where exactness is free."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
    return s[idx]


def annotation_start(line: str) -> int:
    """Index where a `` # …`` annotation tail (exemplar or unknown) begins
    on an exposition line, QUOTE-AWARE — a ``' # '`` inside a label value
    is data, not an annotation. -1 when the line has none. The ONE scanner
    shared by the gateway's replica scrape parser and the test/lint
    exposition parser, so the two can't drift on the grammar."""
    in_quotes = False
    i = 0
    n = len(line)
    while i < n:
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "#" and i >= 1 and line[i - 1] == " ":
            return i - 1
        i += 1
    return -1


def exemplars_requested(path: str) -> bool:
    """Did the HTTP request path opt in to exemplar annotations with an
    exact ``exemplars=1`` query parameter? Parsed, not substring-matched:
    ``?no_exemplars=1`` must NOT enable the classic-parser-breaking tails."""
    from urllib.parse import parse_qs, urlsplit

    q = parse_qs(urlsplit(path or "").query)
    return q.get("exemplars", ["0"])[-1] == "1"


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def format_sample(name: str, labels: Optional[dict], value) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


class Metric:
    def __init__(self, name: str, mtype: str, help_text: str = ""):
        self.name = name
        self.mtype = mtype
        self.help_text = help_text
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def _key(self, labels: Optional[dict]):
        return tuple(sorted((labels or {}).items()))

    def inc(self, labels: Optional[dict] = None, by: float = 1.0):
        with self._lock:
            k = self._key(labels)
            self._series[k] = self._series.get(k, 0.0) + by

    def set(self, value: float, labels: Optional[dict] = None):
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def get(self, labels: Optional[dict] = None) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def series(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Snapshot of every series (label-tuple key → value) — the SLO
        evaluator samples counters through this instead of groping
        ``_series`` under someone else's lock discipline."""
        with self._lock:
            return dict(self._series)

    def clear(self):
        """Drop all series (per-replica gauges are re-stated each scrape so
        removed replicas don't linger as stale series)."""
        with self._lock:
            self._series.clear()

    def replace(self, values: "Sequence[Tuple[Optional[dict], float]]"):
        """Swap the FULL series set atomically ([(labels, value), …]) — the
        restate-at-sample-time path (SLO gauges) uses this instead of
        clear()+set() so a concurrent expose() sees either the old or the
        new complete set, never a half-restated one."""
        new = {self._key(labels): float(v) for labels, v in values}
        with self._lock:
            self._series = new

    def expose(self) -> List[str]:
        lines = []
        if self.help_text:
            lines.append(f"# HELP {self.name} {self.help_text}")
        lines.append(f"# TYPE {self.name} {self.mtype}")
        with self._lock:
            for key, value in sorted(self._series.items()):
                fv = int(value) if float(value).is_integer() else value
                lines.append(format_sample(self.name, dict(key), fv))
        return lines


class Histogram:
    """Cumulative-bucket histogram (classic Prometheus shape).

    ``observe(value, trace_id=...)`` additionally keeps the LAST exemplar
    per bucket — an OpenMetrics-style ``# {trace_id="dtx-…"} value ts``
    annotation on the bucket line — so a p99 bucket links straight to the
    request trace behind it (``GET /debug/trace/<id>``). With no trace id
    the observe path is byte-identical to before: no allocation, no extra
    branch work beyond one falsy check."""

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.name = name
        self.help_text = help_text
        self.buckets = tuple(buckets)
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._total = 0
        # bucket index → (trace_id, observed value, unix ts); populated
        # lazily — a histogram that never sees a trace id never pays for it
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None):
        with self._lock:
            self._sum += value
            self._total += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self._counts[i] += 1
                    if trace_id:
                        self._exemplars[i] = (trace_id, value, time.time())
                    break

    def percentile(self, q: float) -> float:
        """Approximate quantile from bucket upper edges (the autoscale
        signal's p95; the +inf bucket reports the largest finite edge)."""
        with self._lock:
            if self._total == 0:
                return 0.0
            target = q * self._total
            run = 0
            for i, edge in enumerate(self.buckets):
                run += self._counts[i]
                if run >= target:
                    if edge == float("inf"):
                        return self.buckets[-2] if len(self.buckets) > 1 else 0.0
                    return edge
            return self.buckets[-2]

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Snapshot of (upper edge, CUMULATIVE count) pairs plus implicit
        total — the SLO evaluator's windowed good/total deltas come from
        subtracting two of these."""
        with self._lock:
            out = []
            cumulative = 0
            for i, edge in enumerate(self.buckets):
                cumulative += self._counts[i]
                out.append((edge, cumulative))
            return out

    def exemplars(self) -> Dict[float, Tuple[str, float, float]]:
        """Upper edge → (trace_id, observed value, unix ts) for every bucket
        holding an exemplar."""
        with self._lock:
            return {self.buckets[i]: ex for i, ex in self._exemplars.items()}

    def expose(self, with_exemplars: bool = True) -> List[str]:
        """``with_exemplars=False`` emits the classic 0.0.4 exposition.
        The HTTP servers default the WIRE to False (an exemplar tail is a
        parse error to a classic Prometheus parser, which would fail the
        whole scrape) and include exemplars only on the explicit
        ``/metrics?exemplars=1`` debug view."""
        lines = []
        if self.help_text:
            lines.append(f"# HELP {self.name} {self.help_text}")
        lines.append(f"# TYPE {self.name} histogram")
        with self._lock:
            cumulative = 0
            for i, edge in enumerate(self.buckets):
                cumulative += self._counts[i]
                le = "+Inf" if edge == float("inf") else repr(edge)
                line = format_sample(
                    f"{self.name}_bucket", {"le": le}, cumulative)
                ex = self._exemplars.get(i) if with_exemplars else None
                if ex is not None:
                    tid, val, ts = ex
                    line += (f' # {{trace_id="{escape_label_value(tid)}"}} '
                             f"{val} {round(ts, 3)}")
                lines.append(line)
            lines.append(f"{self.name}_sum {self._sum}")
            lines.append(f"{self.name}_count {self._total}")
        return lines


class Registry:
    def __init__(self):
        self._metrics: "Dict[str, object]" = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Metric:
        return self._register(name, "counter", help_text)

    def gauge(self, name: str, help_text: str = "") -> Metric:
        return self._register(name, "gauge", help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_text, buckets)
                self._metrics[name] = m
            return m

    def _register(self, name: str, mtype: str, help_text: str) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Metric(name, mtype, help_text)
                self._metrics[name] = m
            return m

    def get(self, name: str):
        """The registered metric object, or None — for read-only consumers
        (the SLO evaluator) that must not implicitly declare a series just
        by asking about it."""
        with self._lock:
            return self._metrics.get(name)

    def expose(self, with_exemplars: bool = True) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if isinstance(m, Histogram):
                lines.extend(m.expose(with_exemplars=with_exemplars))
            else:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


def serving_latency_histograms(
        registry: Registry) -> Tuple[Histogram, Histogram, Histogram]:
    """The serving plane's (ttft, tpot, prefill_chunk) histograms,
    declared ONCE here: the engine records into them and the serving
    server pre-declares them at scrape time, and Registry keeps the first
    registration — two call sites with their own HELP text would make the
    exposition depend on whether the first scrape beats the engine load."""
    return (
        registry.histogram(
            "dtx_serving_ttft_ms",
            "Per-request time to first streamed token (queue + prefill + "
            "first decode chunk).", buckets=MS_BUCKETS),
        registry.histogram(
            "dtx_serving_tpot_ms",
            "Per-request mean inter-token time after the first token.",
            buckets=MS_BUCKETS),
        registry.histogram(
            "dtx_serving_prefill_chunk_ms",
            "Wall time per chunked-prefill program as seen by the "
            "scheduler (dispatch + any queue drain on async backends).",
            buckets=MS_BUCKETS),
    )


def adapter_load_histogram(registry: Registry) -> Histogram:
    """The adapter plane's load-latency histogram (checkpoint read +
    pad + pool insert on a load-on-miss), declared once here for the same
    reason as ``serving_latency_histograms``: the engine's registry
    observer and the serving server's scrape-time pre-declaration must
    share one object."""
    return registry.histogram(
        "dtx_serving_adapter_load_ms",
        "Wall time to materialise an adapter into a pool slot "
        "(checkpoint load + rank-pad + device insert) on a load-on-miss.",
        buckets=MS_BUCKETS)


def spec_accept_len_histogram(registry: Registry) -> Histogram:
    """Accepted-draft-length histogram of the speculative decode plane
    (``dtx_serving_spec_accept_len``): one observation per drafting row per
    verify step, value = tokens of the proposal prefix the target accepted
    (0..k). Declared once here — the engine observes into it and the
    serving server pre-declares it at scrape time — like
    ``serving_latency_histograms``. Buckets are token counts, not time, so
    no unit suffix."""
    return registry.histogram(
        "dtx_serving_spec_accept_len",
        "Draft tokens accepted per verify-k step (before the corrected/"
        "bonus token).", buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))


# ------------------------------------------------------------ process plumbing

_PROCESS_START = time.monotonic()


def set_build_info(registry: Registry, plane: str):
    """State the ``dtx_build_info`` gauge: value 1, the interesting bits in
    labels (the node_exporter idiom — joinable against any other series)."""
    from datatunerx_tpu_torch import __version__

    registry.gauge(
        "dtx_build_info",
        "Build/version identity; value is always 1, the payload is the "
        "labels.").set(1, {"version": __version__, "plane": plane})


def set_uptime(registry: Registry, plane: str,
               started_at: Optional[float] = None):
    """Re-state the per-plane uptime gauge (call at scrape time).
    ``started_at`` is a ``time.monotonic()`` stamp; default = process start."""
    t0 = _PROCESS_START if started_at is None else started_at
    registry.gauge(
        f"dtx_{plane}_uptime_seconds",
        "Seconds since this server process started.").set(
        round(time.monotonic() - t0, 3))
