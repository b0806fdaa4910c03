"""Unified observability plane (the port of ``datatunerx_tpu/obs``; stdlib
only but for ``profiling``, which opens ``torch.profiler`` when asked).

  obs.metrics    — the shared Prometheus registry (counters / gauges /
                   fixed-bucket histograms, one exposition encoder) behind
                   the serving server's /metrics and the training logger's
                   ``watch/metrics.prom``.
  obs.trace      — Dapper-style spans over the gateway's X-DTX-Trace-Id:
                   context-propagated tracer, bounded trace ring behind
                   ``GET /debug/trace/<id>``, and the engine bridge that
                   folds scheduler timelines into per-request spans with
                   true TTFT/TPOT.
  obs.profiling  — on-demand N-second ``torch.profiler`` windows behind
                   ``POST /debug/profile``, written as Chrome traces.
  obs.slo        — declarative objectives over the registry's histograms
                   and counters: multi-window burn-rate evaluation behind
                   ``GET /debug/slo``.
"""

from datatunerx_tpu_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS,
    MS_BUCKETS,
    Histogram,
    Metric,
    Registry,
    serving_latency_histograms,
    set_build_info,
    set_uptime,
)
from datatunerx_tpu_torch.obs.profiling import (  # noqa: F401
    Profiler,
    process_profiler,
)
from datatunerx_tpu_torch.obs.slo import (  # noqa: F401
    SLO,
    SLOEvaluator,
    default_slos,
    load_slos,
    parse_slos,
    violations,
)
from datatunerx_tpu_torch.obs.trace import (  # noqa: F401
    Span,
    Tracer,
    TraceStore,
    build_request_span,
)
