"""Kubernetes-submitting backends over the port's GPU manifests (the port
of ``datatunerx_tpu/operator/kubebackends.py``): the JobSet/Deployment
feedback loop the reference operator's controllers poll.

- KubeTrainingBackend: creates the port's rendered GPU JobSet
  (``ManifestBackend.render_training``: ``nvidia.com/gpu`` limits, the
  ``cloud.google.com/gke-accelerator`` selector, ``--device cuda``, one pod
  a host with the coordinator env) through the apiserver and maps JobSet
  conditions → Pending | Running | Succeeded | Failed (``jobset_state``)
- KubeServingBackend: creates the port server's Deployment + Service and
  maps Deployment availability → PENDING | HEALTHY | FAILED
  (``deployment_state``)
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from datatunerx_tpu_torch.operator.backends import (
    ManifestBackend,
    deployment_state,
    jobset_state,
)
from datatunerx_tpu_torch.operator.kubeclient import ApiError, KubeClient

JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL = "jobset.x-k8s.io", "v1alpha2", "jobsets"
DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "dtx-manifests")


class KubeTrainingBackend(ManifestBackend):
    """Renders the same GPU JobSet as ManifestBackend, but submits it to the
    apiserver and derives status from the JobSet the cluster reports."""

    def __init__(self, client: KubeClient, namespace: str = "default",
                 out_dir: str = DEFAULT_OUT, **render_kw):
        super().__init__(out_dir, **render_kw)
        self.client = client
        self.namespace = namespace

    def submit(self, name: str, spec: dict) -> None:
        manifest = self.render_training(name, spec)
        manifest["metadata"]["namespace"] = self.namespace
        try:
            self.client.create(JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                               self.namespace, manifest)
        except ApiError as e:
            if e.status != 409:  # already submitted: idempotent
                raise

    def status(self, name: str) -> str:
        try:
            js = self.client.get(JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                                 self.namespace, name)
        except ApiError as e:
            if e.status == 404:
                return "NotFound"
            raise
        return jobset_state(js.get("status") or {})

    def delete(self, name: str) -> None:
        try:
            self.client.delete(JOBSET_GROUP, JOBSET_VERSION, JOBSET_PLURAL,
                               self.namespace, name)
        except ApiError as e:
            if e.status != 404:
                raise


class KubeServingBackend(ManifestBackend):
    def __init__(self, client: KubeClient, namespace: str = "default",
                 out_dir: str = DEFAULT_OUT, **render_kw):
        super().__init__(out_dir, **render_kw)
        self.client = client
        self.namespace = namespace

    def deploy(self, name: str, spec: dict) -> None:
        deployment, service = self.render_serving(name, {
            "model_path": spec.get("llmPath") or spec.get("model_path") or "",
            "checkpoint_path": spec.get("checkpointPath")
            or spec.get("checkpoint_path") or "",
            "labels": spec.get("labels", {}),
            "node_selector": spec.get("nodeSelector", {}),
            "tolerations": spec.get("tolerations", []),
            "quantization": spec.get("quantization", ""),
            "slots": spec.get("slots"),
            "replicas": spec.get("replicas"),
        })
        for group, version, plural, body in (
            ("apps", "v1", "deployments", deployment),
            ("", "v1", "services", service),
        ):
            body["metadata"]["namespace"] = self.namespace
            try:
                self.client.create(group, version, plural, self.namespace, body)
            except ApiError as e:
                if e.status != 409:
                    raise

    def status(self, name: str) -> str:
        try:
            dep = self.client.get("apps", "v1", "deployments",
                                  self.namespace, name)
        except ApiError as e:
            if e.status == 404:
                return "NotFound"
            raise
        return deployment_state(dep.get("status") or {})

    def endpoint(self, name: str) -> Optional[str]:
        if self.status(name) != "HEALTHY":
            return None
        return f"http://{name}.{self.namespace}.svc:8000"

    def delete(self, name: str) -> None:
        for group, version, plural in (("apps", "v1", "deployments"),
                                       ("", "v1", "services")):
            try:
                self.client.delete(group, version, plural, self.namespace, name)
            except ApiError as e:
                if e.status != 404:
                    raise
