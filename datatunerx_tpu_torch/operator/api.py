"""CR schemas: 8 kinds across 3 API groups (SURVEY.md §2.3; reconstructed from
the reference's field-by-field usage since its meta-server types module is not
vendored).

Groups:
  finetune.datatunerx.io/v1beta1:  Finetune, FinetuneJob, FinetuneExperiment
  core.datatunerx.io/v1beta1:      LLM, Hyperparameter, LLMCheckpoint
  extension.datatunerx.io/v1beta1: Dataset, Scoring

Everything is a plain dataclass serializable to/from dicts (to_dict/from_dict)
so stores can persist JSON and webhooks can validate structurally.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import typing
from typing import Any, Dict, List, Optional

GROUP_FINETUNE = "finetune.datatunerx.io/v1beta1"
GROUP_CORE = "core.datatunerx.io/v1beta1"
GROUP_EXTENSION = "extension.datatunerx.io/v1beta1"

# shared finalizer (reference finetune_controller.go:98-113)
FINETUNE_GROUP_FINALIZER = "finetune.datatunerx.io/finalizer"


def _new_uid() -> str:
    import uuid

    return str(uuid.uuid4())


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = dataclasses.field(default_factory=_new_uid)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    finalizers: List[str] = dataclasses.field(default_factory=list)
    owner_references: List[Dict[str, str]] = dataclasses.field(default_factory=list)
    resource_version: int = 0
    generation: int = 1
    creation_timestamp: float = dataclasses.field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None


@dataclasses.dataclass
class CustomResource:
    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # class attributes set by subclasses (ClassVar: not dataclass fields)
    api_version: typing.ClassVar[str] = ""
    kind: typing.ClassVar[str] = ""

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def deepcopy(self):
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": dataclasses.asdict(self.metadata),
            "spec": copy.deepcopy(self.spec),
            "status": copy.deepcopy(self.status),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        meta = ObjectMeta(**d.get("metadata", {}))
        return cls(metadata=meta, spec=copy.deepcopy(d.get("spec", {})),
                   status=copy.deepcopy(d.get("status", {})))


# --------------------------------------------------------- finetune group

class Finetune(CustomResource):
    """One training run (SURVEY.md §2.3 Finetune).

    spec: dataset, llm, hyperparameter{hyperparameterRef, overrides},
          image{name, path, imagePullPolicy}, node (worker count), resource,
          an addition to the reference CRD: topology/mesh {dp, fsdp, tp, sp}
    status: state, jobInfo{podName, containerName}, llmCheckpoint{ref, checkpointPath}
    """

    api_version = GROUP_FINETUNE
    kind = "Finetune"

    STATE_INIT = "Init"
    STATE_PENDING = "Pending"
    STATE_RUNNING = "Running"
    STATE_SUCCESSFUL = "Successful"
    STATE_FAILED = "Failed"


class FinetuneJob(CustomResource):
    """Pipeline wrapper: train → checkpoint publish → serve → score
    (SURVEY.md §2.3 FinetuneJob).

    spec: finetune{name, finetuneSpec}, scoringPluginConfig{name, parameters},
          serveConfig{nodeSelector, tolerations}
    status: state, finetuneStatus (mirror), result{modelExportResult, image,
            serve, dashboard, score}, stats
    """

    api_version = GROUP_FINETUNE
    kind = "FinetuneJob"

    STATE_INIT = "Init"
    STATE_FINETUNE = "Finetune"
    STATE_BUILDIMAGE = "BuildImage"  # checkpoint-publish stage (no image bake)
    STATE_SERVE = "Serve"
    STATE_SUCCESSFUL = "Successful"
    STATE_FAILED = "Failed"


class FinetuneExperiment(CustomResource):
    """Batch of jobs with best-version selection (SURVEY.md §2.3).

    spec: finetuneJobs[{name, spec}], pending (pause switch)
    status: state, jobsStatus[{name, status}], bestVersion{score, image, llm,
            hyperparameter, dataset}, stats
    """

    api_version = GROUP_FINETUNE
    kind = "FinetuneExperiment"

    STATE_PENDING = "Pending"
    STATE_PROCESSING = "Processing"
    STATE_SUCCESS = "Success"
    STATE_FAILED = "Failed"


# ------------------------------------------------------------- core group

class LLM(CustomResource):
    """Model registry entry. status.referenceFinetuneName back-references."""

    api_version = GROUP_CORE
    kind = "LLM"


class Hyperparameter(CustomResource):
    """Reusable parameter group. spec.parameters fields (SURVEY.md §2.3):
    scheduler, optimizer, int4, int8, loRA_R, loRA_Alpha, loRA_Dropout,
    learningRate, epochs, blockSize, batchSize, warmupRatio, weightDecay,
    gradAccSteps, trainerType, PEFT, FP16 — numeric-ish fields are strings
    (reference quirk kept for API compat); additions to the reference CRD:
    topology, meshShape."""

    api_version = GROUP_CORE
    kind = "Hyperparameter"


class LLMCheckpoint(CustomResource):
    """Immutable provenance snapshot of a finished run: deep-copied LLM/
    Dataset/Hyperparameter specs + checkpoint URI (reference
    finetune_controller.go:621-653)."""

    api_version = GROUP_CORE
    kind = "LLMCheckpoint"


# -------------------------------------------------------- extension group

class Dataset(CustomResource):
    """spec.datasetMetadata.datasetInfo: subsets[].splits.{train,validate,test}
    .file URIs + features[{name: instruction|response, mapTo}]."""

    api_version = GROUP_EXTENSION
    kind = "Dataset"


class Scoring(CustomResource):
    """spec: inferenceService URL, plugin{loadPlugin, name, parameters};
    status.score (string, reference quirk kept)."""

    api_version = GROUP_EXTENSION
    kind = "Scoring"


ALL_KINDS = [
    Finetune, FinetuneJob, FinetuneExperiment,
    LLM, Hyperparameter, LLMCheckpoint,
    Dataset, Scoring,
]
KIND_BY_NAME = {k.kind: k for k in ALL_KINDS}
