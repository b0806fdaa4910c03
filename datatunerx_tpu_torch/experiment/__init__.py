"""The experiment plane's promotion half (the port's copy of
``datatunerx_tpu/experiment/{metrics,promotion}.py``): canary weight shift
with auto-rollback, driven by the gateway's ``/admin/promote``, and the
dtx_experiment_* metrics it records.

The rest of the reference plane (slice pool, scheduler, watcher, runner)
is not ported.
"""

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics
from datatunerx_tpu_torch.experiment.promotion import (
    PromotionConfig,
    PromotionController,
)

__all__ = [
    "ExperimentMetrics",
    "PromotionConfig",
    "PromotionController",
]
