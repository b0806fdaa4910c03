"""Trace-driven load replay + chaos harness (stdlib-only; the port's copy
of ``datatunerx_tpu/loadgen/``).

The standing proof behind the "heavy traffic from millions of users"
claims: generate production-shaped traffic (heavy-tail prompt/output
lengths, multi-turn sessions reusing prefixes, adapter-churning ``model``
fields), record it as a replayable JSONL trace, fire it at a gateway while
a chaos injector drives the existing control surfaces (``/admin/drain``,
adapter unload, replica kill, slice-pool shrink), and judge the run with
an SLO epilogue — the same ``obs/slo.py`` evaluator the gateway's
``GET /debug/slo`` serves — exiting nonzero NAMING any violated objective.

  loadgen.workload — the workload model + trace format
  loadgen.chaos    — scheduled fault injection over control surfaces
  loadgen.replay   — the runner, clients, SLO epilogue, and the
                     ``dtx-torch replay`` CLI

Entry points: ``dtx-torch replay`` and
``python -m datatunerx_tpu_torch.loadgen.replay``.
"""

from datatunerx_tpu_torch.loadgen.workload import (  # noqa: F401
    WorkloadModel,
    read_trace,
    write_trace,
)
from datatunerx_tpu_torch.loadgen.chaos import ChaosInjector  # noqa: F401
from datatunerx_tpu_torch.loadgen.replay import ReplayRunner  # noqa: F401
