"""Inference gateway: multi-replica routing, admission control, failover
(the port's own copy of ``datatunerx_tpu/gateway/``, fronting port
replicas).

The operator deploys N `datatunerx_tpu_torch.serving.server` replicas
behind ONE gateway endpoint that spreads load, sheds overload with 429 +
Retry-After instead of OOMing a GPU replica, and survives a replica dying
mid-request. Plain Python — the gateway never touches the model or torch.

    replica_pool  — replica abstraction (in-process / HTTP), health checks,
                    per-replica circuit breaker, graceful drain
    router        — pluggable routing: least-busy-slots, round-robin,
                    session/prefix affinity, LoRA-adapter awareness
    admission     — bounded queue + prefill-token budget backpressure
    metrics       — Prometheus text exposition (counters/gauges/histograms)
    autoscale     — queue depth + p95 latency → replica-count hint the
                    operator consumes (operator/capacity.py)
    server        — the HTTP front-end + managed replica subprocess set
"""

from datatunerx_tpu_torch.gateway.admission import AdmissionController, Overloaded
from datatunerx_tpu_torch.gateway.replica_pool import (
    CircuitBreaker,
    HTTPReplica,
    InProcessReplica,
    NoReplicaAvailable,
    Replica,
    ReplicaError,
    ReplicaPool,
)
from datatunerx_tpu_torch.gateway.router import Router

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "HTTPReplica",
    "InProcessReplica",
    "NoReplicaAvailable",
    "Overloaded",
    "Replica",
    "ReplicaError",
    "ReplicaPool",
    "Router",
]
