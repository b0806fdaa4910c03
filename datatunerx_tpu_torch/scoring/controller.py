"""Scoring controller: reconciles Scoring CRs by driving the inference
endpoint and writing status.score.

The reference keeps this in a sibling-repo operator and only creates/watches
the CR (SURVEY.md §2.3 Scoring); here it's in-tree so the pipeline is
self-contained. Built-in path uses the probe scorer; plugin path resolves the
named plugin (reference plugin contract, generate.go:343-358).
"""

from __future__ import annotations

import os

from typing import Optional

from datatunerx_tpu_torch.operator.api import Scoring
from datatunerx_tpu_torch.operator.reconciler import Result
from datatunerx_tpu_torch.operator.store import ObjectStore
from datatunerx_tpu_torch.scoring.builtin import score_endpoint, validate_probes
from datatunerx_tpu_torch.scoring.dataset_scoring import (
    DEFAULT_MAX_EXAMPLES,
    score_dataset,
)
from datatunerx_tpu_torch.scoring.plugin import resolve_plugin

RETRY_S = float(os.environ.get("DTX_SCORING_RETRY_S", "10.0"))


class ScoringController:
    kind = Scoring

    def __init__(self, timeout: float = 120.0):
        self.timeout = timeout

    def reconcile(self, store: ObjectStore, scoring: Scoring) -> Optional[Result]:
        if scoring.metadata.deletion_timestamp:
            return None
        if scoring.status.get("score") is not None:
            return None  # done

        url = scoring.spec.get("inferenceService")
        if not url:
            scoring.status["error"] = "spec.inferenceService is required"
            store.update(scoring)
            return None

        plugin = scoring.spec.get("plugin") or {}
        dataset_ref = scoring.spec.get("datasetRef")
        metric = scoring.spec.get("metric") or "generation"
        # Validate the spec BEFORE any endpoint traffic — this is the only
        # permanent-error branch. Endpoint failures (including a warming
        # server returning a 200 with a non-OpenAI body, which surfaces as
        # JSONDecodeError/KeyError from the response parser) must retry.
        try:
            if plugin.get("loadPlugin"):
                fn = resolve_plugin(plugin.get("name", ""))
            elif dataset_ref:
                if metric not in ("generation", "perplexity"):
                    raise ValueError(f"unknown scoring metric {metric!r}")
                max_examples = int(scoring.spec.get("maxExamples")
                                   or DEFAULT_MAX_EXAMPLES)
                if max_examples <= 0:
                    raise ValueError("maxExamples must be positive")
            else:
                # built-in scorer accepts CR-supplied probes
                # (spec.probes: [{prompt, reference}]); defaults otherwise
                probes = validate_probes(scoring.spec.get("probes"))
        except (KeyError, TypeError, ValueError, PermissionError,
                ImportError, AttributeError) as e:
            # bad spec OR bad-but-allowlisted plugin path — permanent either way
            scoring.status["error"] = f"invalid scoring spec: {e!r}"[:500]
            store.update(scoring)
            return None

        try:
            if plugin.get("loadPlugin"):
                score = str(fn(url, plugin.get("parameters")))
                details = None
            elif dataset_ref:
                from datatunerx_tpu_torch.operator.api import Dataset

                ds = store.try_get(Dataset, dataset_ref,
                                   scoring.metadata.namespace)
                if ds is None:  # may be created later — retry
                    scoring.status["lastError"] = f"Dataset/{dataset_ref} not found"
                    store.update(scoring)
                    return Result(requeue_after=RETRY_S)
                result = score_dataset(url, ds.spec, metric=metric,
                                       max_examples=max_examples,
                                       timeout=self.timeout,
                                       model=scoring.spec.get("model"))
                score, details = result["score"], result["details"]
            else:
                result = score_endpoint(
                    url, probes=probes, timeout=self.timeout,
                    # spec.model: named adapter on a multi-adapter engine —
                    # N Scorings against ONE endpoint compare N checkpoints
                    model=scoring.spec.get("model"))
                score, details = result["score"], result["details"]
        except Exception as e:  # endpoint not ready / transient — retry
            scoring.status["lastError"] = str(e)[:500]
            store.update(scoring)
            return Result(requeue_after=RETRY_S)

        scoring.status["score"] = str(score)
        if details is not None:
            scoring.status["details"] = details
        scoring.status.pop("lastError", None)
        store.update(scoring)
        return None
