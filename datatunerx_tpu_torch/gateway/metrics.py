"""The gateway's metric classes: a re-export of the port's shared
observability plane (``datatunerx_tpu_torch/obs/metrics.py``), so the
gateway, the serving server and the training logger build their
expositions from the same classes (the port's copy of
``datatunerx_tpu/gateway/metrics.py``).
"""

from datatunerx_tpu_torch.obs.metrics import (  # noqa: F401
    LATENCY_BUCKETS,
    MS_BUCKETS,
    Histogram,
    Metric,
    Registry,
    escape_label_value,
    format_sample,
)

__all__ = [
    "LATENCY_BUCKETS",
    "MS_BUCKETS",
    "Histogram",
    "Metric",
    "Registry",
    "escape_label_value",
    "format_sample",
]
