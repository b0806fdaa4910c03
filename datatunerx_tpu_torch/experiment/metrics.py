"""dtx_experiment_* metrics: the experiment plane's view of the closed loop
(the port's copy of ``datatunerx_tpu/experiment/metrics.py``; the port
runs only its promotion half, and the families and their help text stay
the reference's so the expositions agree byte for byte).

One ``ExperimentMetrics`` instance per experiment, wrapping a shared
``obs.metrics.Registry`` so the exposition obeys the same invariants the
gateway/serving/training planes hold (metrics_lint validates this plane the
same way). The scheduler, watcher and promotion controller record through
the methods here — no raw registry access from the loop code, so metric
names/labels live in exactly one place.
"""

from __future__ import annotations

from typing import Optional

from datatunerx_tpu_torch.obs.metrics import Registry, set_build_info

PROMOTION_PHASES = ("idle", "canary", "shifting", "completed", "rolled_back")


class ExperimentMetrics:
    def __init__(self, registry: Optional[Registry] = None,
                 experiment: str = ""):
        self.registry = registry if registry is not None else Registry()
        self.experiment = experiment
        set_build_info(self.registry, "experiment")
        g = self.registry.gauge
        c = self.registry.counter
        self._jobs = g("dtx_experiment_jobs",
                       "Jobs by scheduler state (pending/running/preempted/"
                       "succeeded/failed/stopped).")
        self._slices = g("dtx_experiment_pool_slices",
                         "Pool slices by occupancy (free/held).")
        self._preempt = c("dtx_experiment_preemptions_total",
                          "Jobs preempted off a slice (pool shrink or "
                          "priority eviction).")
        self._resume = c("dtx_experiment_resumes_total",
                         "Preempted jobs resumed from their latest orbax "
                         "checkpoint.")
        self._early = c("dtx_experiment_early_stops_total",
                        "Jobs stopped early by the continuous-scoring "
                        "watcher to free pool capacity.")
        self._evals = c("dtx_experiment_evals_total",
                        "Eval checkpoints scored by the watcher.")
        self._score = g("dtx_experiment_job_score",
                        "Latest leaderboard score per job.")
        self._best = g("dtx_experiment_best_score",
                       "Current leaderboard leader's score.")
        self._weight = g("dtx_experiment_canary_weight",
                         "Traffic fraction currently routed to the "
                         "promotion canary (0 = no active canary).")
        self._phase = g("dtx_experiment_promotion_phase",
                        "One-hot promotion state "
                        "(idle/canary/shifting/completed/rolled_back).")
        self._promotions = c("dtx_experiment_promotions_total",
                             "Finished promotions by outcome "
                             "(completed/rolled_back).")
        self._rollbacks = c("dtx_experiment_rollbacks_total",
                            "Promotions rolled back after a canary "
                            "regression (error rate or latency).")
        self.set_promotion_phase("idle")

    # ------------------------------------------------------------ scheduler
    def set_job_states(self, counts: dict) -> None:
        self._jobs.clear()
        for state, n in sorted(counts.items()):
            self._jobs.set(n, {"state": str(state).lower()})

    def set_pool(self, free: int, held: int) -> None:
        self._slices.set(free, {"state": "free"})
        self._slices.set(held, {"state": "held"})

    def preempted(self) -> None:
        self._preempt.inc()

    def resumed(self) -> None:
        self._resume.inc()

    def early_stopped(self) -> None:
        self._early.inc()

    # -------------------------------------------------------------- scoring
    def scored(self, job: str, score: float) -> None:
        self._evals.inc()
        self._score.set(score, {"job": job})

    def set_best(self, score: float) -> None:
        self._best.set(score)

    # ------------------------------------------------------------ promotion
    def set_canary_weight(self, weight: float) -> None:
        self._weight.set(weight)

    def set_promotion_phase(self, phase: str) -> None:
        for p in PROMOTION_PHASES:
            self._phase.set(1 if p == phase else 0, {"phase": p})

    def promotion_finished(self, outcome: str) -> None:
        self._promotions.inc({"outcome": outcome})
        if outcome == "rolled_back":
            self._rollbacks.inc()

    # ------------------------------------------------------------- scrape
    def expose(self) -> str:
        return self.registry.expose()
