"""FinetuneJob controller: the central pipeline state machine (reference
internal/controller/finetune/finetunejob_controller.go:71-560).

  Init → precondition (deps exist, back-reference bookkeeping :213-257)
       → create Finetune (:259-283, first pass → ErrRecalibrate 10s requeue)
       → mirror Finetune status (:285-355)
       → Finetune Successful → checkpoint-publish stage (replaces the
         privileged image-bake Job, :310-344 — TPU serving mounts the
         checkpoint URI directly, SURVEY.md §7.1; state name kept: BuildImage)
       → deploy serving, health-gate (:357-466)
       → create Scoring (built-in or plugin, :438-463)
       → score set → Successful + serving teardown (:468-511)
"""

from __future__ import annotations

import os

import time
from typing import Optional

from datatunerx_tpu_torch.operator.api import (
    Dataset,
    Finetune,
    FINETUNE_GROUP_FINALIZER,
    FinetuneJob,
    Hyperparameter,
    LLM,
    LLMCheckpoint,
    Scoring,
)
from datatunerx_tpu_torch.operator.errors import ErrRecalibrate
from datatunerx_tpu_torch.operator.generate import (
    generate_builtin_scoring,
    generate_finetune,
    generate_plugin_scoring,
    generate_serving_spec,
)
from datatunerx_tpu_torch.operator.reconciler import Result
from datatunerx_tpu_torch.operator.store import AlreadyExists, NotFound, ObjectStore

SERVE_POLL_S = float(os.environ.get("DTX_SERVE_POLL_S", "5.0"))


class FinetuneJobController:
    kind = FinetuneJob

    def __init__(self, serving_backend, slice_pool=None):
        self.serving = serving_backend
        # optional SlicePool: caps gateway scale-up at free slice inventory
        # (capacity.serving_replicas_for), same pool FinetuneController uses
        self.slice_pool = slice_pool

    # re-enter when owned Finetune / Scoring change (reference Watches wiring,
    # finetunejob_controller.go:162-206). Owner references already cover this
    # via the manager; serving state changes are polled.

    def reconcile(self, store: ObjectStore, job: FinetuneJob) -> Optional[Result]:
        meta = job.metadata

        if meta.deletion_timestamp:
            return self._cleanup(store, job)

        if FINETUNE_GROUP_FINALIZER not in meta.finalizers:
            meta.finalizers.append(FINETUNE_GROUP_FINALIZER)
            store.update(job)
            return Result(requeue_after=0)

        state = job.status.get("state", "")
        if state in (FinetuneJob.STATE_SUCCESSFUL, FinetuneJob.STATE_FAILED):
            return None

        if state == "":
            job.status["state"] = FinetuneJob.STATE_INIT
            store.update(job)
            return Result(requeue_after=0)

        self._reconcile_precondition(store, job)

        ft = self._reconcile_finetune_send(store, job)

        result = self._reconcile_by_finetune_status(store, job, ft)
        if result is not None:
            return result

        result = self._reconcile_serving(store, job)
        if result is not None:
            return result

        return self._reconcile_by_scoring_status(store, job)

    # ------------------------------------------------------- preconditions
    def _reconcile_precondition(self, store: ObjectStore, job: FinetuneJob):
        """Verify LLM/Hyperparameter/Dataset exist; append this job to their
        status.referenceFinetuneName (reference :213-257)."""
        ft_spec = job.spec.get("finetune", {}).get("finetuneSpec", {})
        refs = [
            (LLM, ft_spec.get("llm")),
            (Hyperparameter,
             (ft_spec.get("hyperparameter") or {}).get("hyperparameterRef")),
            (Dataset, ft_spec.get("dataset")),
        ]
        missing = []
        for kind, name in refs:
            if not name:
                missing.append(kind.kind)
                continue
            obj = store.try_get(kind, name, job.metadata.namespace)
            if obj is None:
                missing.append(f"{kind.kind}/{name}")
                continue
            back = obj.status.setdefault("referenceFinetuneName", [])
            if job.metadata.name not in back:
                back.append(job.metadata.name)
                store.update(obj)
        if missing:
            raise ErrRecalibrate(
                f"{job.metadata.namespace}/{job.metadata.name}: missing {missing}"
            )

    def _reconcile_finetune_send(self, store: ObjectStore, job: FinetuneJob) -> Finetune:
        """Create the Finetune child on first pass (reference :259-283)."""
        ft = generate_finetune(job)
        existing = store.try_get(Finetune, ft.metadata.name, ft.metadata.namespace)
        if existing is None:
            store.create(ft)
            raise ErrRecalibrate("finetune created; waiting for status")
        return existing

    # ----------------------------------------------------- finetune status
    def _reconcile_by_finetune_status(
        self, store: ObjectStore, job: FinetuneJob, ft: Finetune
    ) -> Optional[Result]:
        ft_state = ft.status.get("state", "")
        job.status["finetuneStatus"] = dict(ft.status)

        if ft_state in ("", Finetune.STATE_INIT, Finetune.STATE_PENDING,
                        Finetune.STATE_RUNNING):
            if job.status.get("state") != FinetuneJob.STATE_FINETUNE:
                job.status["state"] = FinetuneJob.STATE_FINETUNE
            store.update(job)
            return Result(requeue_after=SERVE_POLL_S)

        if ft_state == Finetune.STATE_FAILED:
            job.status["state"] = FinetuneJob.STATE_FAILED
            store.update(job)
            return None

        # Successful → checkpoint-publish stage (reference BuildImage, :296-344)
        if job.status.get("state") == FinetuneJob.STATE_FINETUNE:
            ckpt_info = ft.status.get("llmCheckpoint") or {}
            ref = ckpt_info.get("llmCheckpointRef")
            ckpt = store.try_get(LLMCheckpoint, ref, job.metadata.namespace) if ref else None
            if ckpt is None:
                return Result(requeue_after=SERVE_POLL_S)
            # record the serving artifact pointers (reference fills
            # CheckpointImage{Name, CheckPointPath, LLMPath}, :328-336)
            ckpt.spec["checkpointImage"] = {
                "name": f"ckpt-{job.metadata.name}-{time.strftime('%Y%m%d')}",
                "checkPointPath": ckpt.spec.get("checkpoint"),
                "llmPath": (ckpt.spec.get("image") or {}).get("path"),
            }
            store.update(ckpt)
            job.status["state"] = FinetuneJob.STATE_BUILDIMAGE
            job.status.setdefault("result", {})["modelExportResult"] = True
            job.status["result"]["image"] = ckpt.spec["checkpointImage"]["name"]
            job.status["result"]["checkpointPath"] = ckpt.spec.get("checkpoint")
            store.update(job)
            return Result(requeue_after=0)
        return None

    # -------------------------------------------------------------- serving
    def _reconcile_serving(self, store: ObjectStore, job: FinetuneJob) -> Optional[Result]:
        if job.status.get("state") not in (FinetuneJob.STATE_BUILDIMAGE,
                                           FinetuneJob.STATE_SERVE):
            return None

        name = job.metadata.name
        serve_status = self.serving.status(name)
        if serve_status == "NotFound":
            ckpt_ref = (job.status.get("finetuneStatus", {})
                        .get("llmCheckpoint", {}) or {}).get("llmCheckpointRef")
            ckpt = store.try_get(LLMCheckpoint, ckpt_ref, job.metadata.namespace)
            info = {
                "llmPath": (ckpt.spec.get("checkpointImage") or {}).get("llmPath")
                if ckpt else None,
                "checkpointPath": ckpt.spec.get("checkpoint") if ckpt else None,
            }
            self.serving.deploy(name, generate_serving_spec(job, {
                "llmPath": info["llmPath"],
                "checkpointPath": info["checkpointPath"],
            }))
            job.status["state"] = FinetuneJob.STATE_SERVE
            store.update(job)
            return Result(requeue_after=SERVE_POLL_S)

        if serve_status != "HEALTHY":
            if serve_status == "FAILED":
                job.status["state"] = FinetuneJob.STATE_FAILED
                store.update(job)
                return None
            return Result(requeue_after=SERVE_POLL_S)

        # HEALTHY (reference gate :423-424) → record endpoints + create Scoring
        endpoint = self.serving.endpoint(name) or f"http://{name}.{job.metadata.namespace}.svc:8000"
        result = job.status.setdefault("result", {})
        changed = result.get("serve") != endpoint
        result["serve"] = endpoint
        result["dashboard"] = endpoint.replace(":8000", ":8080")
        inference_url = endpoint.rstrip("/") + "/chat/completions"  # reference :433

        changed = self._reconcile_autoscale(job) or changed

        if store.try_get(Scoring, name, job.metadata.namespace) is None:
            if job.spec.get("scoringPluginConfig") and job.spec["scoringPluginConfig"].get("name"):
                scoring = generate_plugin_scoring(job, inference_url)
            else:
                scoring = generate_builtin_scoring(job, inference_url)
            try:
                store.create(scoring)
            except AlreadyExists:
                pass
            changed = True
        if changed:
            store.update(job)
        return None  # scoring watch / requeue drives the rest

    def _reconcile_autoscale(self, job: FinetuneJob) -> bool:
        """Poll the gateway's autoscale hint and apply the capacity-clamped
        replica count (gateway/autoscale.py → capacity.serving_replicas_for).
        No-op for single-replica/no-gateway deployments and backends that
        don't expose scale_hint/scale. Returns True when job.status changed."""
        serve_cfg = job.spec.get("serveConfig", {}) or {}
        gatewayed = (bool(serve_cfg.get("gateway"))
                     or int(serve_cfg.get("replicas") or 1) > 1)
        hint_fn = getattr(self.serving, "scale_hint", None)
        scale_fn = getattr(self.serving, "scale", None)
        if not gatewayed or hint_fn is None or scale_fn is None:
            return False
        hint = hint_fn(job.metadata.name)
        if hint is None:
            return False

        from datatunerx_tpu_torch.operator.capacity import serving_replicas_for

        desired = serving_replicas_for(
            hint,
            min_replicas=int(serve_cfg.get("minReplicas") or 1),
            max_replicas=int(serve_cfg.get("maxReplicas")
                             or serve_cfg.get("replicas") or 1),
            free_slices=(self.slice_pool.free_count()
                         if self.slice_pool is not None else None),
        )
        result = job.status.setdefault("result", {})
        summary = {
            "replicas": hint["replicas"],
            "desiredReplicas": desired,
            "queueDepth": hint["queueDepth"],
            "shedCount": hint["shedCount"],
            "p95LatencySeconds": hint["p95LatencySeconds"],
            "reason": hint["reason"],
        }
        changed = result.get("serving") != summary
        result["serving"] = summary
        if desired != hint["replicas"]:
            try:
                scale_fn(job.metadata.name, desired)
            except Exception:  # noqa: BLE001 — next poll retries; don't
                pass           # fail the reconcile over a scale hiccup
        return changed

    # -------------------------------------------------------------- scoring
    def _reconcile_by_scoring_status(self, store: ObjectStore, job: FinetuneJob) -> Optional[Result]:
        if job.status.get("state") != FinetuneJob.STATE_SERVE:
            return None
        scoring = store.try_get(Scoring, job.metadata.name, job.metadata.namespace)
        if scoring is None:
            return Result(requeue_after=SERVE_POLL_S)
        if scoring.status.get("error"):
            # permanent scoring failure (invalid spec) — fail the job and tear
            # down serving rather than polling SERVE forever
            job.status["state"] = FinetuneJob.STATE_FAILED
            job.status.setdefault("result", {})["scoringError"] = scoring.status["error"]
            store.update(job)
            self.serving.delete(job.metadata.name)
            return None
        if scoring.status.get("score") is None:
            return Result(requeue_after=SERVE_POLL_S)
        # score set → Successful; tear down serving (reference :485-508)
        job.status["state"] = FinetuneJob.STATE_SUCCESSFUL
        job.status.setdefault("result", {})["score"] = scoring.status["score"]
        job.status["stats"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        store.update(job)
        self.serving.delete(job.metadata.name)
        return None

    # -------------------------------------------------------------- cleanup
    def _cleanup(self, store: ObjectStore, job: FinetuneJob) -> Optional[Result]:
        """Reference reconcileCleaner (:513-560): delete children, clear
        back-references, drop finalizer."""
        name, ns = job.metadata.name, job.metadata.namespace
        self.serving.delete(name)
        for kind, child in ((Scoring, name), (Finetune, f"{name}-finetune")):
            try:
                store.delete(kind, child, ns)
            except NotFound:
                pass
        ft_name = job.spec.get("finetune", {}).get("name")
        if ft_name:
            try:
                store.delete(Finetune, ft_name, ns)
            except NotFound:
                pass
        ft_spec = job.spec.get("finetune", {}).get("finetuneSpec", {})
        for kind, ref in (
            (LLM, ft_spec.get("llm")),
            (Hyperparameter, (ft_spec.get("hyperparameter") or {}).get("hyperparameterRef")),
            (Dataset, ft_spec.get("dataset")),
        ):
            if not ref:
                continue
            obj = store.try_get(kind, ref, ns)
            if obj and name in obj.status.get("referenceFinetuneName", []):
                obj.status["referenceFinetuneName"].remove(name)
                store.update(obj)
        if FINETUNE_GROUP_FINALIZER in job.metadata.finalizers:
            job.metadata.finalizers.remove(FINETUNE_GROUP_FINALIZER)
            store.update(job)
        return None
