"""The port's control plane (the port of ``datatunerx_tpu/operator/``): the
CRD-driven orchestration layer with the reference's 8 CR kinds in 3 API
groups, the three nested controllers (Finetune → FinetuneJob →
FinetuneExperiment), resource generation, validation webhooks,
finalizers, owner references and requeue-with-backoff, over the port's
launch backends: ``backends.LocalProcessBackend`` (the port's trainer CLI
as subprocesses), ``serving/local_backend.LocalServingBackend`` (port
servers and gateways), ``backends.ManifestBackend`` (GPU JobSets and
Deployments) and the scripted fakes, and the Kubernetes mode: the CRs in
an apiserver (``kubestore``), lease-based leader election
(``leaderelection``), the HTTPS admission webhooks (``webhook_server``)
and the install bundle (``crdgen``, ``install``; ``dtx-torch install``).
``manager.main`` is ``dtx-torch-controller-manager``.
"""

from datatunerx_tpu_torch.operator.api import (
    Dataset,
    Finetune,
    FinetuneExperiment,
    FinetuneJob,
    Hyperparameter,
    LLM,
    LLMCheckpoint,
    ObjectMeta,
    Scoring,
)
from datatunerx_tpu_torch.operator.store import ObjectStore
from datatunerx_tpu_torch.operator.reconciler import Manager, Result

__all__ = [
    "Dataset", "Finetune", "FinetuneExperiment", "FinetuneJob",
    "Hyperparameter", "LLM", "LLMCheckpoint", "ObjectMeta", "Scoring",
    "ObjectStore", "Manager", "Result",
]
