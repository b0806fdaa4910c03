"""KubeObjectStore: the ObjectStore verbs against a real Kubernetes apiserver
(the port's copy of ``datatunerx_tpu/operator/kubestore.py``, over the
port's ``kubeclient``: it reads that client's ``ApiError``).

The in-memory ``ObjectStore`` gives reconcilers the API-server contract
(optimistic concurrency, finalizer-gated deletion, watches); this adapter
implements the SAME five verbs + watch over the CRD endpoints (deploy/crds/),
so the controllers run unchanged in-cluster — the arrangement the reference
gets from controller-runtime (reference cmd/controller-manager/app/
controller_manager.go:44-51 scheme registration; every controller Create/
Status().Update crosses into the apiserver, SURVEY.md §3).

Spec/metadata and status are separate update surfaces in k8s (status
subresource); ``update()`` writes both, preserving the single-call contract
controllers expect from ObjectStore.
"""

from __future__ import annotations

import calendar
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Type

from datatunerx_tpu_torch.operator.api import ALL_KINDS, CustomResource, KIND_BY_NAME, ObjectMeta
from datatunerx_tpu_torch.operator.kubeclient import ApiError, KubeClient
from datatunerx_tpu_torch.operator.store import AlreadyExists, Conflict, Event, NotFound


def plural_of(kind: str) -> str:
    return kind.lower() + "s"


def gvp(cls: Type[CustomResource]) -> Tuple[str, str, str]:
    group, _, version = cls.api_version.partition("/")
    return group, version, plural_of(cls.kind)


def _epoch_to_rfc3339(t: Optional[float]) -> Optional[str]:
    if t is None:
        return None
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


def _rfc3339_to_epoch(s) -> Optional[float]:
    if not s:
        return None
    if isinstance(s, (int, float)):
        return float(s)
    try:
        return float(calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%SZ")))
    except ValueError:
        return None


def to_k8s(obj: CustomResource) -> dict:
    m = obj.metadata
    meta: dict = {"name": m.name, "namespace": m.namespace}
    if m.uid:
        meta["uid"] = m.uid
    if m.labels:
        meta["labels"] = dict(m.labels)
    if m.annotations:
        meta["annotations"] = dict(m.annotations)
    if m.finalizers:
        meta["finalizers"] = list(m.finalizers)
    if m.owner_references:
        meta["ownerReferences"] = [
            {
                "apiVersion": KIND_BY_NAME[r["kind"]].api_version
                if r.get("kind") in KIND_BY_NAME else r.get("apiVersion", ""),
                "kind": r.get("kind"),
                "name": r.get("name"),
                "uid": r.get("uid"),
            }
            for r in m.owner_references
        ]
    if m.resource_version:
        meta["resourceVersion"] = str(m.resource_version)
    return {
        "apiVersion": obj.api_version,
        "kind": obj.kind,
        "metadata": meta,
        "spec": obj.spec,
        "status": obj.status,
    }


def from_k8s(d: dict) -> CustomResource:
    cls = KIND_BY_NAME[d["kind"]]
    km = d.get("metadata", {})
    rv_raw = km.get("resourceVersion", 0)
    meta = ObjectMeta(
        name=km.get("name", ""),
        namespace=km.get("namespace", "default"),
        uid=km.get("uid", ""),
        labels=dict(km.get("labels") or {}),
        annotations=dict(km.get("annotations") or {}),
        finalizers=list(km.get("finalizers") or []),
        owner_references=[
            {"kind": r.get("kind"), "name": r.get("name"), "uid": r.get("uid")}
            for r in (km.get("ownerReferences") or [])
        ],
        resource_version=int(rv_raw) if str(rv_raw).isdigit() else 0,
        generation=int(km.get("generation", 1) or 1),
        creation_timestamp=_rfc3339_to_epoch(km.get("creationTimestamp"))
        or time.time(),
        deletion_timestamp=_rfc3339_to_epoch(km.get("deletionTimestamp")),
    )
    return cls(metadata=meta, spec=d.get("spec") or {}, status=d.get("status") or {})


class KubeObjectStore:
    def __init__(self, client: KubeClient,
                 kinds: Optional[List[Type[CustomResource]]] = None):
        self.client = client
        self.kinds = list(kinds or ALL_KINDS)
        self._watchers: List[Callable[[Event], None]] = []
        self._watch_threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # --------------------------------------------------------------- verbs
    def create(self, obj: CustomResource) -> CustomResource:
        cls = type(obj)
        group, version, plural = gvp(cls)
        body = to_k8s(obj)
        body["metadata"].pop("resourceVersion", None)
        status = body.pop("status", None)
        try:
            created = self.client.create(
                group, version, plural, obj.metadata.namespace, body
            )
        except ApiError as e:
            if e.status == 409:
                raise AlreadyExists(f"{obj.kind} {obj.key}") from e
            raise
        if status:
            created["status"] = status
            created = self._put_status(group, version, plural, obj.metadata.namespace,
                                       obj.metadata.name, created)
        return from_k8s(created)

    def get(self, kind, name: str, namespace: str = "default") -> CustomResource:
        cls = KIND_BY_NAME[kind] if isinstance(kind, str) else kind
        group, version, plural = gvp(cls)
        try:
            return from_k8s(self.client.get(group, version, plural, namespace, name))
        except ApiError as e:
            if e.status == 404:
                raise NotFound(f"{cls.kind} {namespace}/{name}") from e
            raise

    def try_get(self, kind, name, namespace="default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, obj: CustomResource) -> CustomResource:
        cls = type(obj)
        group, version, plural = gvp(cls)
        ns, name = obj.metadata.namespace, obj.metadata.name
        body = to_k8s(obj)
        try:
            updated = self.client.replace(group, version, plural, ns, name, body)
        except ApiError as e:
            if e.status == 409:
                raise Conflict(f"{obj.kind} {obj.key}") from e
            if e.status == 404:
                raise NotFound(f"{obj.kind} {obj.key}") from e
            raise
        if updated.get("status") == obj.status:
            # status unchanged by this reconcile: skip the second PUT (halves
            # apiserver write load and watch-event churn)
            return from_k8s(updated)
        # status subresource write rides the rv the main write just returned
        updated["status"] = obj.status
        try:
            updated = self._put_status(group, version, plural, ns, name, updated)
        except NotFound:
            # removing the last finalizer completed a pending deletion during
            # the main write — the object is legitimately gone
            if updated["metadata"].get("deletionTimestamp"):
                return from_k8s(updated)
            raise
        return from_k8s(updated)

    def _put_status(self, group, version, plural, ns, name, body) -> dict:
        try:
            return self.client.replace(
                group, version, plural, ns, name, body, subresource="status"
            )
        except ApiError as e:
            if e.status == 409:
                raise Conflict(f"{body.get('kind')} {ns}/{name} (status)") from e
            if e.status == 404:
                raise NotFound(f"{body.get('kind')} {ns}/{name}") from e
            raise

    def delete(self, kind, name, namespace="default"):
        cls = KIND_BY_NAME[kind] if isinstance(kind, str) else kind
        group, version, plural = gvp(cls)
        try:
            self.client.delete(group, version, plural, namespace, name)
        except ApiError as e:
            if e.status == 404:
                raise NotFound(f"{cls.kind} {namespace}/{name}") from e
            raise

    def list(self, kind, namespace: Optional[str] = "default",
             labels: Optional[Dict[str, str]] = None) -> List[CustomResource]:
        cls = KIND_BY_NAME[kind] if isinstance(kind, str) else kind
        group, version, plural = gvp(cls)
        selector = ",".join(f"{k}={v}" for k, v in (labels or {}).items()) or None
        resp = self.client.list(group, version, plural, namespace,
                                label_selector=selector)
        out = [from_k8s(item) for item in resp.get("items", [])]
        return sorted(out, key=lambda o: o.metadata.name)

    # --------------------------------------------------------------- watch
    def watch(self, fn: Callable[[Event], None]):
        self._watchers.append(fn)
        if not self._watch_threads:
            self._start_watches()

    def _start_watches(self):
        for cls in self.kinds:
            group, version, plural = gvp(cls)
            t = threading.Thread(
                target=self.client.watch,
                args=(group, version, plural, None, self._dispatch, self._stop),
                daemon=True,
                name=f"watch-{plural}",
            )
            t.start()
            self._watch_threads.append(t)

    def _dispatch(self, ev_type: str, obj_dict: dict):
        if obj_dict.get("kind") not in KIND_BY_NAME:
            return
        obj = from_k8s(obj_dict)
        for w in list(self._watchers):
            try:
                w((ev_type, obj))
            except Exception:
                pass

    def stop(self):
        self._stop.set()
