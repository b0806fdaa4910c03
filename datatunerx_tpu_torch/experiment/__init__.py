"""Closed-loop experiment plane (the port's copy of
``datatunerx_tpu/experiment/``; the paper's FinetuneExperiment, live):

    shared slice pool → elastic N-job scheduling (preempt/resume from the
      trainer's checkpoints)
      → continuous scoring as eval checkpoints land (live leaderboard,
        early stop) → winner → canary replica behind the gateway →
        weighted traffic shift with auto-rollback → full rollout

Modules: ``pool`` (elastic slice inventory, mesh-shape gang fit),
``scheduler`` (fair-share + score-aware priorities, checkpoint-aware
preemption), ``watcher`` (leaderboard + early stop, scoring-controller
bridge), ``promotion`` (canary weight shift + rollback guard), ``runner``
(the loop + the ``dtx-torch experiment`` CLI), ``metrics`` (dtx_experiment_*).
"""

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics
from datatunerx_tpu_torch.experiment.pool import PoolSlice, SharedSlicePool
from datatunerx_tpu_torch.experiment.promotion import (
    PromotionConfig,
    PromotionController,
)
from datatunerx_tpu_torch.experiment.runner import ExperimentRunner
from datatunerx_tpu_torch.experiment.scheduler import ExperimentJob, SliceScheduler
from datatunerx_tpu_torch.experiment.watcher import (
    ContinuousScoringWatcher,
    Leaderboard,
)

__all__ = [
    "ContinuousScoringWatcher",
    "ExperimentJob",
    "ExperimentMetrics",
    "ExperimentRunner",
    "Leaderboard",
    "PoolSlice",
    "PromotionConfig",
    "PromotionController",
    "SharedSlicePool",
    "SliceScheduler",
]
