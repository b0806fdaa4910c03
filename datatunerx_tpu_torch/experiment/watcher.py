"""Continuous scoring: a live leaderboard instead of a terminal verdict
(the port's copy of ``datatunerx_tpu/experiment/watcher.py``).

The operator's pipeline scores once, after a job finishes. The paper's loop
wants the opposite: every periodic eval checkpoint gets scored AS IT LANDS,
so the experiment carries a leaderboard while jobs still train — which is
what makes score-aware scheduling (leaders keep slices) and early-stop
(clear losers free capacity) possible at all.

Pieces:

- ``Leaderboard`` — per-job score history + current leader;
- ``ContinuousScoringWatcher`` — tick-driven: for each active job, list the
  eval checkpoints newer than the last scored one (``checkpoints_fn``),
  score each (``score_fn``), feed the board, the scheduler's priorities and
  the dtx_experiment_* metrics; flag clear losers for early stop;
- default providers for the real path: the trainer's
  ``training/checkpoint.checkpoint_steps`` lists a job's saved steps, and
  ``scoring_cr_score`` drives the EXISTING ``scoring/`` controller (a
  Scoring CR against a serving endpoint — the generative-eval path the
  serving engine already implements) and returns the numeric score.

Tests and the fake-backend CLI inject fake ``checkpoints_fn``/``score_fn``;
the contracts are one-call-per-checkpoint and a plain float score.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics
from datatunerx_tpu_torch.experiment.scheduler import (
    RUNNING,
    SUCCEEDED,
    ExperimentJob,
    SliceScheduler,
)


class ScoreEntry:
    __slots__ = ("job", "score", "step", "history")

    def __init__(self, job: str):
        self.job = job
        self.score: Optional[float] = None
        self.step: Optional[int] = None
        self.history: List[Tuple[int, float]] = []

    @property
    def evals(self) -> int:
        return len(self.history)

    def to_dict(self) -> dict:
        return {"job": self.job, "score": self.score, "step": self.step,
                "evals": self.evals, "history": list(self.history)}


class Leaderboard:
    """Thread-safe live standings; scores are floats, higher is better."""

    def __init__(self):
        self._entries: Dict[str, ScoreEntry] = {}
        self._lock = threading.Lock()

    def update(self, job: str, step: int, score: float) -> ScoreEntry:
        with self._lock:
            e = self._entries.get(job)
            if e is None:
                e = self._entries[job] = ScoreEntry(job)
            e.score = float(score)
            e.step = int(step)
            e.history.append((int(step), float(score)))
            return e

    def entry(self, job: str) -> Optional[ScoreEntry]:
        with self._lock:
            return self._entries.get(job)

    def standings(self) -> List[ScoreEntry]:
        with self._lock:
            entries = list(self._entries.values())
        return sorted(entries,
                      key=lambda e: (-(e.score if e.score is not None
                                       else float("-inf")), e.job))

    def leader(self) -> Optional[ScoreEntry]:
        standings = self.standings()
        return standings[0] if standings and standings[0].score is not None \
            else None

    def to_dict(self) -> dict:
        return {"standings": [e.to_dict() for e in self.standings()]}


# ------------------------------------------------------------ real providers

def scoring_cr_score(store, controller, name: str, endpoint: str,
                     namespace: str = "default",
                     probes: Optional[list] = None,
                     model: Optional[str] = None,
                     max_attempts: int = 3) -> Optional[float]:
    """Score one checkpoint by driving the EXISTING scoring controller: a
    Scoring CR pointed at the serving endpoint (the engine behind it does
    the generative eval), reconciled until ``status.score`` lands. Returns
    the score as float, or None when the endpoint stayed unreachable within
    ``max_attempts`` reconciles."""
    from datatunerx_tpu_torch.operator.api import ObjectMeta, Scoring
    from datatunerx_tpu_torch.operator.store import AlreadyExists

    spec: dict = {"inferenceService": endpoint}
    if probes:
        spec["probes"] = probes
    if model:
        spec["model"] = model
    scoring = Scoring(metadata=ObjectMeta(name=name, namespace=namespace),
                      spec=spec)
    try:
        store.create(scoring)
    except AlreadyExists:
        scoring = store.get(Scoring, name, namespace)
    for _ in range(max_attempts):
        scoring = store.get(Scoring, name, namespace)
        if scoring.status.get("score") is not None:
            break
        controller.reconcile(store, scoring)
    scoring = store.get(Scoring, name, namespace)
    raw = scoring.status.get("score")
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


# ------------------------------------------------------------------ watcher

class ContinuousScoringWatcher:
    """Tick-driven scorer of periodic eval checkpoints.

    ``checkpoints_fn(job) -> [step, ...]`` lists a job's saved eval
    checkpoints (ascending); ``score_fn(job, step) -> float`` evaluates
    one. Scores feed the leaderboard, the scheduler's priorities, and —
    when ``early_stop_margin`` is set — the early-stop verdicts: a job
    with ``min_evals`` scores trailing the leader (also at ``min_evals``)
    by more than the margin is stopped to free its slice.
    """

    def __init__(self, scheduler: SliceScheduler,
                 checkpoints_fn: Callable[[ExperimentJob], List[int]],
                 score_fn: Callable[[ExperimentJob, int], Optional[float]],
                 board: Optional[Leaderboard] = None,
                 metrics: Optional[ExperimentMetrics] = None,
                 early_stop_margin: Optional[float] = None,
                 min_evals: int = 2):
        self.scheduler = scheduler
        self.checkpoints_fn = checkpoints_fn
        self.score_fn = score_fn
        self.board = board if board is not None else Leaderboard()
        self.metrics = metrics
        self.early_stop_margin = early_stop_margin
        self.min_evals = max(1, int(min_evals))
        self._last_scored: Dict[str, int] = {}
        # checkpoints seen but not yet scored on the LAST tick (score_fn
        # returned None — endpoint warming). The runner reads this to keep
        # the training phase open until the final checkpoints' scores land
        # instead of picking a winner off stale mid-training scores.
        self.pending_scores = 0

    def tick(self) -> List[dict]:
        events: List[dict] = []
        pending = 0
        for job in self.scheduler.jobs():
            # succeeded jobs still get their FINAL checkpoint scored —
            # the terminal verdict rides the same path as the live ones
            if job.state not in (RUNNING, SUCCEEDED):
                continue
            last = self._last_scored.get(job.name, -1)
            for step in self.checkpoints_fn(job):
                if step <= last:
                    continue
                score = self.score_fn(job, step)
                if score is None:
                    pending += 1
                    continue  # endpoint not ready — retried next tick
                self._last_scored[job.name] = step
                self.board.update(job.name, step, score)
                self.scheduler.set_score(job.name, score)
                if self.metrics is not None:
                    self.metrics.scored(job.name, score)
                events.append({"event": "scored", "job": job.name,
                               "step": step, "score": score})
        self.pending_scores = pending
        leader = self.board.leader()
        if leader is not None and self.metrics is not None:
            self.metrics.set_best(leader.score)
        events.extend(self._early_stop(leader))
        return events

    def _early_stop(self, leader: Optional[ScoreEntry]) -> List[dict]:
        if (self.early_stop_margin is None or leader is None
                or leader.evals < self.min_evals):
            return []
        events: List[dict] = []
        for job in self.scheduler.jobs():
            if job.state != RUNNING or job.name == leader.job:
                continue
            e = self.board.entry(job.name)
            if (e is None or e.score is None or e.evals < self.min_evals
                    or leader.score - e.score <= self.early_stop_margin):
                continue
            if self.scheduler.stop(job.name, reason="early_stop"):
                events.append({"event": "early_stop", "job": job.name,
                               "score": e.score, "leader": leader.job,
                               "leader_score": leader.score})
        return events
