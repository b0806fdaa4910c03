"""Slice-pool scheduler: N experiment jobs running elastically on a
SharedSlicePool (the port's copy of ``datatunerx_tpu/experiment/
scheduler.py``; checkpoints are listed by the port's trainer).

The operator's FinetuneExperiment fan-out gives every job its own dedicated
resources and waits. This scheduler is the elastic version the paper's
closed loop needs: jobs queue for slices, gang-schedule by mesh shape
(``experiment/pool.py`` → ``capacity._mesh_shape_from``), get preempted when
the pool shrinks, and resume later **from their latest checkpoint** — the
trainer's existing ``--resume`` path (``training/checkpoint.py``) makes
a resubmission with the same ``--output_dir`` fast-forward instead of
restart, so preemption costs one checkpoint interval, not the run.

Priorities are fair-share + score-aware:

- a RUNNING job's priority is its latest leaderboard score (fed by the
  continuous-scoring watcher via ``set_score``) — early-leading jobs keep
  their slices; unscored jobs rank below any scored one;
- when the pool shrinks, the LOWEST-priority running job is preempted
  (ties: the job with the least runtime loses, it has the least sunk work);
- waiting jobs (pending or preempted) are admitted leaders-first, ties
  broken by least cumulative runtime (fair share), then FIFO.

Everything is tick-driven and synchronous: ``tick()`` polls the backend,
admits, and returns the events it caused — tests and the runner drive it
explicitly, no background threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from datatunerx_tpu_torch.experiment.metrics import ExperimentMetrics
from datatunerx_tpu_torch.experiment.pool import PoolSlice, SharedSlicePool
# the trainer's own listing: a step counts once its state.pt exists
from datatunerx_tpu_torch.training.checkpoint import checkpoint_probe

PENDING = "Pending"
RUNNING = "Running"
PREEMPTED = "Preempted"
SUCCEEDED = "Succeeded"
FAILED = "Failed"
STOPPED = "Stopped"

ACTIVE_STATES = (PENDING, RUNNING, PREEMPTED)
_NO_SCORE = float("-inf")


class ExperimentJob:
    """Scheduler-side record of one fine-tune job."""

    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = dict(spec)
        self.state = PENDING
        self.score: Optional[float] = None
        self.enqueued_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.runtime_s = 0.0  # accumulated across preemptions
        self.preemptions = 0
        self.resumes = 0
        self.resume_step: Optional[int] = None
        self.stop_reason = ""

    @property
    def parameters(self) -> dict:
        return self.spec.get("parameters") or {}

    def _accumulate_runtime(self):
        if self.started_at is not None:
            self.runtime_s += time.monotonic() - self.started_at
            self.started_at = None

    def to_dict(self) -> dict:
        return {
            "name": self.name, "state": self.state, "score": self.score,
            "preemptions": self.preemptions, "resumes": self.resumes,
            "resumeStep": self.resume_step,
            "stopReason": self.stop_reason,
            "runtimeS": round(self.runtime_s + (
                time.monotonic() - self.started_at
                if self.started_at is not None else 0.0), 3),
        }


class SliceScheduler:
    """Elastic gang scheduler over a SharedSlicePool + TrainingBackend."""

    def __init__(self, pool: SharedSlicePool, backend,
                 metrics: Optional[ExperimentMetrics] = None,
                 checkpoint_probe: Callable[[ExperimentJob], Optional[int]]
                 = checkpoint_probe):
        self.pool = pool
        self.backend = backend
        self.metrics = metrics
        self.checkpoint_probe = checkpoint_probe
        self._jobs: Dict[str, ExperimentJob] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- queries
    def jobs(self) -> List[ExperimentJob]:
        with self._lock:
            return list(self._jobs.values())

    def job(self, name: str) -> Optional[ExperimentJob]:
        with self._lock:
            return self._jobs.get(name)

    def active(self) -> List[ExperimentJob]:
        return [j for j in self.jobs() if j.state in ACTIVE_STATES]

    def done(self) -> bool:
        return not self.active()

    def succeeded(self) -> List[ExperimentJob]:
        return [j for j in self.jobs() if j.state == SUCCEEDED]

    # ------------------------------------------------------------ lifecycle
    def add_job(self, name: str, spec: dict) -> ExperimentJob:
        with self._lock:
            if name in self._jobs:
                raise ValueError(f"job {name!r} already in the experiment")
            job = self._jobs[name] = ExperimentJob(name, spec)
        return job

    def set_score(self, name: str, score: float) -> None:
        job = self.job(name)
        if job is not None:
            job.score = float(score)

    # ------------------------------------------------------------ priority
    @staticmethod
    def _priority(job: ExperimentJob) -> float:
        return job.score if job.score is not None else _NO_SCORE

    def _admission_order(self, waiting: List[ExperimentJob]
                         ) -> List[ExperimentJob]:
        return sorted(waiting, key=lambda j: (
            -self._priority(j), j.runtime_s, j.enqueued_at))

    def _victim(self, for_job: Optional[ExperimentJob] = None
                ) -> Optional[ExperimentJob]:
        """Lowest-priority RUNNING job; with ``for_job`` set, only victims
        whose HELD SLICE the contender's mesh shape actually tiles count —
        evicting a job whose slice the contender can't use would burn a
        checkpoint interval for nothing (and thrash forever)."""
        from datatunerx_tpu_torch.experiment.pool import mesh_fits

        running = [j for j in self.jobs() if j.state == RUNNING]
        if for_job is not None:
            usable = []
            for j in running:
                s = self.pool.assignment(j.name)
                if s is not None and mesh_fits(for_job.parameters, s.chips):
                    usable.append(j)
            running = usable
        if not running:
            return None
        return min(running, key=lambda j: (self._priority(j), j.runtime_s,
                                           j.name))

    # ---------------------------------------------------------------- tick
    def tick(self) -> List[dict]:
        """Poll terminal states, admit waiting jobs onto free slices.
        Returns the events performed (for logs/spans)."""
        events: List[dict] = []
        for job in self.jobs():
            if job.state != RUNNING:
                continue
            st = self.backend.status(job.name)
            if st == "Succeeded":
                self._terminate(job, SUCCEEDED)
                events.append({"event": "succeeded", "job": job.name})
            elif st in ("Failed", "NotFound"):
                self._terminate(job, FAILED)
                events.append({"event": "failed", "job": job.name})
        waiting = [j for j in self.jobs() if j.state in (PENDING, PREEMPTED)]
        for job in self._admission_order(waiting):
            s = self.pool.acquire(job.name, job.parameters)
            if s is None:
                # score-aware eviction: a displaced leader takes a slice
                # back from a STRICTLY lower-priority running job (both
                # scored — unscored contenders never evict anyone) whose
                # slice the leader's mesh actually fits, so a pool shrink
                # lands on the scoreboard's tail, not its head
                victim = self._victim(for_job=job)
                if (victim is not None and job.score is not None
                        and victim.score is not None
                        and self._priority(job) > self._priority(victim)):
                    self.preempt(victim.name)
                    events.append({"event": "evicted", "job": victim.name,
                                   "for": job.name})
                    s = self.pool.acquire(job.name, job.parameters)
                if s is None:
                    continue
            events.append(self._launch(job, s))
        self._update_gauges()
        return events

    def _launch(self, job: ExperimentJob, s: PoolSlice) -> dict:
        resumed = job.state == PREEMPTED
        spec = dict(job.spec)
        # fresh copy, never an alias into job.spec: writing the resume
        # marker through a shared dict would mutate the job's own spec and
        # leak a stale step into later submissions
        spec["env"] = dict(job.spec.get("env") or {})
        spec["slice"] = s.name
        spec["topology"] = s.topology
        spec["node_selector"] = s.node_selector
        if resumed and job.resume_step is not None:
            # informational: the trainer resumes from --output_dir's latest
            # step regardless; the env var lets logs/tests see what
            # the scheduler expected the restore path to find
            spec["env"]["DTX_RESUME_FROM_STEP"] = str(job.resume_step)
        else:
            spec["env"].pop("DTX_RESUME_FROM_STEP", None)
        self.backend.submit(job.name, spec)
        job.state = RUNNING
        job.started_at = time.monotonic()
        if resumed:
            job.resumes += 1
            if self.metrics is not None:
                self.metrics.resumed()
        return {"event": "resumed" if resumed else "started",
                "job": job.name, "slice": s.name,
                "resume_step": job.resume_step if resumed else None}

    def _terminate(self, job: ExperimentJob, state: str):
        job._accumulate_runtime()
        job.state = state
        self.pool.release(job.name)

    # ---------------------------------------------------------- preemption
    def preempt(self, name: str) -> Optional[int]:
        """Checkpoint-aware preemption: stop the job's processes, record
        the latest step it will resume from, free its slice. Returns
        the resume step (None = no checkpoint yet)."""
        job = self.job(name)
        if job is None or job.state != RUNNING:
            return None
        self.backend.delete(job.name)
        job._accumulate_runtime()
        job.resume_step = self.checkpoint_probe(job)
        job.state = PREEMPTED
        job.preemptions += 1
        self.pool.release(job.name)
        if self.metrics is not None:
            self.metrics.preempted()
        self._update_gauges()
        return job.resume_step

    def shrink(self, slice_name: str) -> Optional[str]:
        """Remove a slice from the pool, preempting its holder if any
        (the hardware is going away — whoever runs on it must checkpoint
        off). Returns the preempted job's name (None = the slice was free).
        The slice is removed FIRST and the preemption targets whoever
        remove_slice reports displaced — preempting a peeked holder before
        removal would race a concurrent tick() re-acquiring the just-freed
        slice, leaving that job running on reclaimed hardware.
        If the displaced job leads the scoreboard, the next ``tick`` gives
        it a slice back by evicting a lower-priority job (see tick's
        eviction pass) — leaders keep *a* slice, not a specific one."""
        holder = self.pool.remove_slice(slice_name)
        if holder is not None:
            self.preempt(holder)
        self._update_gauges()
        return holder

    def grow(self, s: PoolSlice) -> None:
        self.pool.add_slice(s)
        self._update_gauges()

    # ---------------------------------------------------------- early stop
    def stop(self, name: str, reason: str = "") -> bool:
        """Stop a job for good (continuous-scoring early stop): its slice
        frees for the remaining contenders and it will not resume."""
        job = self.job(name)
        if job is None or job.state not in ACTIVE_STATES:
            return False
        if job.state == RUNNING:
            self.backend.delete(job.name)
        job._accumulate_runtime()
        job.state = STOPPED
        job.stop_reason = reason
        self.pool.release(job.name)
        if self.metrics is not None and reason == "early_stop":
            self.metrics.early_stopped()
        self._update_gauges()
        return True

    # -------------------------------------------------------------- gauges
    def _update_gauges(self):
        if self.metrics is None:
            return
        counts: Dict[str, int] = {}
        for j in self.jobs():
            counts[j.state] = counts.get(j.state, 0) + 1
        self.metrics.set_job_states(counts)
        self.metrics.set_pool(self.pool.free_count(), self.pool.held_count())
