"""Finetune controller: one training run (the port of
``datatunerx_tpu/operator/finetune_controller.py``; reference
internal/controller/finetune/finetune_controller.go:81-237).

State machine (reference :115-234):
  "" → Init → (deps missing → Pending, retry) → submit training job →
  Pending/Running (poll, requeue) → Succeeded → read completion manifest
  (replaces pod-exec checkpoint-path scrape, :278-305) → status.llmCheckpoint →
  create LLMCheckpoint provenance snapshot (:307-353,621-653) → Successful
  | Failed (sticky terminal states, :115-123)

It makes the reference controller's decisions but for the cards: one
trainer process drives one card, so a node's share of a slice is its cards
(``CARDS_PER_HOST``; the reference takes 4 chips a v5e host), a job held
for placement says ``PLACEMENT_PENDING``, and admission checks the 80 GB
card budget (``capacity.check_admission``'s ``h100-80gb``).
"""

from __future__ import annotations

import os
from typing import Optional

from datatunerx_tpu_torch.operator import config
from datatunerx_tpu_torch.operator.api import (
    Dataset,
    Finetune,
    FINETUNE_GROUP_FINALIZER,
    Hyperparameter,
    LLM,
    LLMCheckpoint,
    ObjectMeta,
)
from datatunerx_tpu_torch.operator.errors import ErrRecalibrate
from datatunerx_tpu_torch.operator.generate import (
    build_trainer_args,
    generate_training_spec,
    merge_hyperparameters,
    rand_suffix,
)
from datatunerx_tpu_torch.operator.labels import generate_instance_label
from datatunerx_tpu_torch.operator.reconciler import Result
from datatunerx_tpu_torch.operator.store import NotFound, ObjectStore, set_owner
from datatunerx_tpu_torch.training.checkpoint import read_manifest

# Reference parity defaults (finetune_controller.go:55 3s requeue; :171,190
# 30s running poll). Env-tunable so tests run the same state machines at
# ~100ms.
POLL_INTERVAL_S = float(os.environ.get("DTX_POLL_INTERVAL_S", "3.0"))
RUNNING_POLL_S = float(os.environ.get("DTX_RUNNING_POLL_S", "30.0"))

# one process a card: a slice's cards are its hosts
CARDS_PER_HOST = 1
PLACEMENT_PENDING = "no free slice of cards"


class FinetuneController:
    kind = Finetune

    def __init__(self, backend, storage_path: Optional[str] = None,
                 health_probe=None, slice_pool=None):
        self.backend = backend
        self.storage_path = storage_path or config.get_storage_path()
        # optional DeviceHealthProbe (operator/health.py): while unhealthy,
        # hold new submissions instead of queueing onto a wedged device
        self.health_probe = health_probe
        # optional SlicePool (operator/placement.py): concurrent jobs onto
        # disjoint sub-slices; no pool = single-tenant, no gating
        self.slice_pool = slice_pool

    # ------------------------------------------------------------ reconcile
    def reconcile(self, store: ObjectStore, ft: Finetune) -> Optional[Result]:
        meta = ft.metadata

        # deletion: tear down the training job, drop finalizer (reference :98-113)
        if meta.deletion_timestamp:
            self.backend.delete(meta.name)
            if self.slice_pool is not None:
                self.slice_pool.release(meta.name)
            if FINETUNE_GROUP_FINALIZER in meta.finalizers:
                meta.finalizers.remove(FINETUNE_GROUP_FINALIZER)
                store.update(ft)
            return None

        if FINETUNE_GROUP_FINALIZER not in meta.finalizers:
            meta.finalizers.append(FINETUNE_GROUP_FINALIZER)
            store.update(ft)
            return Result(requeue_after=0)

        state = ft.status.get("state", "")
        if state in (Finetune.STATE_SUCCESSFUL, Finetune.STATE_FAILED):
            # terminal states are sticky (reference :115-123); the slice goes
            # back to the pool for the next queued job
            if self.slice_pool is not None:
                self.slice_pool.release(meta.name)
            return None

        if state == "":
            ft.status["state"] = Finetune.STATE_INIT
            store.update(ft)
            return Result(requeue_after=0)

        # dependencies (reference :389-405: miss → Pending + retry)
        dataset = store.try_get(Dataset, ft.spec.get("dataset", ""), meta.namespace)
        hp_ref = ft.spec.get("hyperparameter", {}) or {}
        hyperparameter = store.try_get(
            Hyperparameter, hp_ref.get("hyperparameterRef", ""), meta.namespace
        )
        llm = store.try_get(LLM, ft.spec.get("llm", ""), meta.namespace)
        if dataset is None or hyperparameter is None or llm is None:
            if ft.status.get("state") != Finetune.STATE_PENDING:
                ft.status["state"] = Finetune.STATE_PENDING
                store.update(ft)
            raise ErrRecalibrate(
                f"{meta.namespace}/{meta.name}: waiting for dataset/hyperparameter/llm"
            )

        job_status = self.backend.status(meta.name)
        if job_status == "NotFound":
            if self.health_probe is not None and not self.health_probe.healthy:
                reason = self.health_probe.last_error or "device unhealthy"
                if ft.status.get("state") != Finetune.STATE_PENDING or (
                        ft.status.get("backendUnavailable") != reason):
                    ft.status["state"] = Finetune.STATE_PENDING
                    ft.status["backendUnavailable"] = reason
                    store.update(ft)
                return Result(requeue_after=RUNNING_POLL_S)
            # recovered: drop the hold note (persisted by the post-submit
            # update below — no extra write)
            ft.status.pop("backendUnavailable", None)
            placement = None
            hosts = None
            if self.slice_pool is not None:
                # controller-owned placement (SURVEY §7.4#3): every job gets
                # a DISJOINT sub-slice; none free -> hold in Pending
                placement = self.slice_pool.acquire(
                    meta.name,
                    min_chips=int(ft.spec.get("node", 1) or 1) * CARDS_PER_HOST)
                if placement is None:
                    if (ft.status.get("state") != Finetune.STATE_PENDING
                            or not ft.status.get("placementPending")):
                        ft.status["state"] = Finetune.STATE_PENDING
                        ft.status["placementPending"] = PLACEMENT_PENDING
                        store.update(ft)
                    return Result(requeue_after=RUNNING_POLL_S)
                # one trainer process a card: the job takes every card of
                # the ASSIGNED slice
                hosts = max(1, placement.chips // CARDS_PER_HOST)
            params = merge_hyperparameters(
                hyperparameter.spec.get("parameters", {}),
                hp_ref.get("overrides"),
            )
            # memory admission (parallel/memory.py): a job whose training
            # state provably exceeds a card's 80 GB is failed HERE with a
            # byte breakdown, not after it is launched
            n_chips = (placement.chips if placement is not None
                       else max(1, int(ft.spec.get("node", 1) or 1))
                       * CARDS_PER_HOST)
            from datatunerx_tpu_torch.operator.capacity import check_admission

            denied = check_admission(
                ft.spec.get("image", {}).get("path") or "",
                params, n_chips=n_chips)
            if denied is not None:
                reason, breakdown = denied
                if self.slice_pool is not None and placement is not None:
                    self.slice_pool.release(meta.name)
                    ft.status.pop("placement", None)
                ft.status["state"] = Finetune.STATE_FAILED
                ft.status["admissionDenied"] = reason
                if breakdown:
                    ft.status["hbmEstimateGB"] = breakdown
                store.update(ft)
                return None
            args = build_trainer_args(ft, dataset.spec, params, uid=meta.uid,
                                      num_workers=hosts)
            spec = generate_training_spec(ft, args, num_hosts=hosts)
            if placement is not None:
                ft.status.pop("placementPending", None)
                ft.status["placement"] = placement.to_dict()
                spec["topology"] = placement.topology
                spec["node_selector"] = placement.node_selector
            self.backend.submit(meta.name, spec)
            ft.status["state"] = Finetune.STATE_PENDING
            ft.status["jobInfo"] = {"jobName": meta.name, "backend": type(self.backend).__name__}
            store.update(ft)
            return Result(requeue_after=POLL_INTERVAL_S)

        if job_status == "Pending":
            return Result(requeue_after=POLL_INTERVAL_S)
        if job_status == "Running":
            if ft.status.get("state") != Finetune.STATE_RUNNING:
                ft.status["state"] = Finetune.STATE_RUNNING
                store.update(ft)
            return Result(requeue_after=RUNNING_POLL_S)
        if job_status == "Failed":
            # bounded retry with checkpoint-resume (SURVEY.md §5.3 — the
            # reference has no retry at all): the trainer auto-resumes from its
            # latest Orbax checkpoint (same uid → same storage key), so a retry
            # continues rather than restarts
            # DTX_DEFAULT_BACKOFF_LIMIT: fleet-wide retry default for specs
            # that don't set backoffLimit (k8s Jobs default 6; ours stays 0
            # so failure-propagation semantics are explicit). Retries resume
            # from the latest checkpoint — a retry continues, not restarts.
            default_limit = int(os.environ.get("DTX_DEFAULT_BACKOFF_LIMIT",
                                               "0"))
            raw = ft.spec.get("backoffLimit")
            try:
                limit = default_limit if raw in (None, "") else int(raw)
            except (TypeError, ValueError):
                limit = default_limit  # junk in the spec must not wedge
                # the Failed transition in an error-requeue loop
            retries = int(ft.status.get("retries", 0))
            if retries < limit:
                self.backend.delete(meta.name)
                ft.status["retries"] = retries + 1
                ft.status["state"] = Finetune.STATE_PENDING
                store.update(ft)
                return Result(requeue_after=POLL_INTERVAL_S)
            ft.status["state"] = Finetune.STATE_FAILED
            store.update(ft)
            return None
        if job_status == "Succeeded":
            return self._on_succeeded(store, ft)
        return Result(requeue_after=POLL_INTERVAL_S)

    # ------------------------------------------------------- success path
    def _on_succeeded(self, store: ObjectStore, ft: Finetune) -> Optional[Result]:
        meta = ft.metadata
        manifest = read_manifest(self.storage_path, meta.uid)
        if manifest is None:
            # completion manifest not yet visible on shared storage
            return Result(requeue_after=POLL_INTERVAL_S)

        if not ft.status.get("llmCheckpoint"):
            ft.status["llmCheckpoint"] = {
                "llmCheckpointRef": f"{meta.name}-{rand_suffix()}",
                "checkpointPath": manifest["checkpoint"],
            }
            store.update(ft)
            return Result(requeue_after=0)

        ref = ft.status["llmCheckpoint"]["llmCheckpointRef"]
        if store.try_get(LLMCheckpoint, ref, meta.namespace) is None:
            self._create_checkpoint_cr(store, ft, ref, manifest)

        ft.status["state"] = Finetune.STATE_SUCCESSFUL
        store.update(ft)
        return None

    def _create_checkpoint_cr(self, store, ft: Finetune, ref: str, manifest: dict):
        """Provenance snapshot: deep-copied dependency specs (reference
        generateLLMCheckpoint, finetune_controller.go:621-653)."""
        meta = ft.metadata
        dataset = store.try_get(Dataset, ft.spec.get("dataset", ""), meta.namespace)
        hp = store.try_get(
            Hyperparameter,
            (ft.spec.get("hyperparameter") or {}).get("hyperparameterRef", ""),
            meta.namespace,
        )
        llm = store.try_get(LLM, ft.spec.get("llm", ""), meta.namespace)
        ckpt = LLMCheckpoint(
            metadata=ObjectMeta(
                name=ref,
                namespace=meta.namespace,
                labels=generate_instance_label(meta.name),
            ),
            spec={
                "llm": {"llmRef": ft.spec.get("llm"),
                        "spec": llm.spec if llm else None},
                "dataset": {"datasetRef": ft.spec.get("dataset"),
                            "spec": dataset.spec if dataset else None},
                "hyperparameter": {
                    "hyperparameterRef": (ft.spec.get("hyperparameter") or {}).get(
                        "hyperparameterRef"
                    ),
                    "spec": hp.spec if hp else None,
                },
                "image": ft.spec.get("image"),
                "checkpoint": manifest["checkpoint"],
                "metrics": manifest.get("metrics", {}),
            },
        )
        set_owner(ckpt, ft)
        store.create(ckpt)
