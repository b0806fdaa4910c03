"""FinetuneExperiment controller: batch fan-out + aggregation + best-version
selection (reference internal/controller/finetune/
finetuneexperiment_controller.go:54-227).

- spec.pending=True pauses the experiment: child jobs deleted, state=Pending
  (reference :86-114); flipping back resumes.
- fan-out: one FinetuneJob per spec.finetuneJobs entry, owner-referenced
  (reference :123-152).
- aggregation: child statuses mirrored BY NAME into status.jobsStatus —
  fixing the fragile index-based pairing (reference :168-190, SURVEY.md §7.5).
- all Successful → bestVersion = highest score (numeric parse, not the
  reference's atoi-or-0, util.go:24-30); any mix of terminal states with at
  least one success still selects; all failed → Failed (reference :199-220).
"""

from __future__ import annotations

import os

import time
from typing import Optional

from datatunerx_tpu_torch.operator.api import (
    FINETUNE_GROUP_FINALIZER,
    FinetuneExperiment,
    FinetuneJob,
    LLMCheckpoint,
    ObjectMeta,
)
from datatunerx_tpu_torch.operator.reconciler import Result
from datatunerx_tpu_torch.operator.store import AlreadyExists, NotFound, ObjectStore, set_owner

DEFAULT_POLL_S = 5.0


def parse_score(s) -> float:
    """Numeric score parse; unparseable → -inf so it never wins (the reference
    silently maps any non-integer to 0, util.go:24-30 — a bug we don't keep)."""
    try:
        return float(s)
    except (TypeError, ValueError):
        return float("-inf")


class FinetuneExperimentController:
    kind = FinetuneExperiment

    def __init__(self, poll_s: Optional[float] = None):
        # resolved at CONSTRUCTION, not import: tests and operators can set
        # DTX_EXPERIMENT_POLL_S (or pass poll_s) without reloading the
        # module — the old module-level read froze the env value for the
        # process lifetime
        self.poll_s = (float(os.environ.get("DTX_EXPERIMENT_POLL_S", "")
                             or DEFAULT_POLL_S)
                       if poll_s is None else float(poll_s))

    def reconcile(self, store: ObjectStore, exp: FinetuneExperiment) -> Optional[Result]:
        meta = exp.metadata

        if meta.deletion_timestamp:
            for entry in exp.spec.get("finetuneJobs", []):
                try:
                    store.delete(FinetuneJob, entry["name"], meta.namespace)
                except NotFound:
                    pass
            if FINETUNE_GROUP_FINALIZER in meta.finalizers:
                meta.finalizers.remove(FINETUNE_GROUP_FINALIZER)
                store.update(exp)
            return None

        if FINETUNE_GROUP_FINALIZER not in meta.finalizers:
            meta.finalizers.append(FINETUNE_GROUP_FINALIZER)
            store.update(exp)
            return Result(requeue_after=0)

        # pause switch (reference :86-114)
        if exp.spec.get("pending"):
            changed = False
            for entry in exp.spec.get("finetuneJobs", []):
                if store.try_get(FinetuneJob, entry["name"], meta.namespace):
                    try:
                        store.delete(FinetuneJob, entry["name"], meta.namespace)
                        changed = True
                    except NotFound:
                        pass
            if exp.status.get("state") != FinetuneExperiment.STATE_PENDING:
                exp.status["state"] = FinetuneExperiment.STATE_PENDING
                changed = True
            if changed:
                store.update(exp)
            return None

        if exp.status.get("state") in ("", FinetuneExperiment.STATE_PENDING, None):
            exp.status["state"] = FinetuneExperiment.STATE_PROCESSING
            store.update(exp)
            return Result(requeue_after=0)

        # fan-out (reference :123-152)
        created = False
        for entry in exp.spec.get("finetuneJobs", []):
            if store.try_get(FinetuneJob, entry["name"], meta.namespace) is None:
                job = FinetuneJob(
                    metadata=ObjectMeta(name=entry["name"], namespace=meta.namespace),
                    spec=entry.get("spec", {}),
                )
                set_owner(job, exp)
                try:
                    store.create(job)
                    created = True
                except AlreadyExists:
                    pass
        if created:
            return Result(requeue_after=self.poll_s)

        # aggregation by name (reference :154-197)
        jobs = []
        jobs_status = []
        for entry in exp.spec.get("finetuneJobs", []):
            job = store.try_get(FinetuneJob, entry["name"], meta.namespace)
            if job is not None:
                jobs.append(job)
                jobs_status.append({"name": entry["name"], "status": dict(job.status)})
        exp.status["jobsStatus"] = jobs_status

        states = [j.status.get("state") for j in jobs]
        n = len(exp.spec.get("finetuneJobs", []))
        all_terminal = len(jobs) == n and all(
            s in (FinetuneJob.STATE_SUCCESSFUL, FinetuneJob.STATE_FAILED) for s in states
        )
        if not all_terminal:
            store.update(exp)
            return Result(requeue_after=self.poll_s)

        successes = [j for j in jobs if j.status.get("state") == FinetuneJob.STATE_SUCCESSFUL]
        if not successes:
            exp.status["state"] = FinetuneExperiment.STATE_FAILED
            exp.status["stats"] = _now()
            store.update(exp)
            return None

        best = max(
            successes, key=lambda j: parse_score(j.status.get("result", {}).get("score"))
        )
        exp.status["bestVersion"] = self._best_version(store, best)
        exp.status["state"] = FinetuneExperiment.STATE_SUCCESS
        exp.status["stats"] = _now()
        store.update(exp)
        return None

    def _best_version(self, store: ObjectStore, job: FinetuneJob) -> dict:
        """Reference BestVersion{Score, Image, LLM, Hyperparameter, Dataset}
        (:209-215)."""
        ft_spec = job.spec.get("finetune", {}).get("finetuneSpec", {})
        return {
            "score": job.status.get("result", {}).get("score"),
            "image": job.status.get("result", {}).get("image"),
            "checkpointPath": job.status.get("result", {}).get("checkpointPath"),
            "llm": ft_spec.get("llm"),
            "hyperparameter": (ft_spec.get("hyperparameter") or {}).get("hyperparameterRef"),
            "dataset": ft_spec.get("dataset"),
        }


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
