"""Object store: the k8s-API-server-shaped state layer controllers talk to.

Gives the reconcilers the same contract controller-runtime gets from the API
server (SURVEY.md §3: every `Create`/`Status().Update` crosses into the API
server): optimistic concurrency via resourceVersion, finalizer-gated deletion,
owner-reference cascade, label selection, and watch events feeding the work
queue. In-memory with optional JSON-dir persistence; a real-cluster adapter can
implement the same five verbs against the k8s API without touching controller
code.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Type

from datatunerx_tpu_torch.operator.api import CustomResource, KIND_BY_NAME


class Conflict(Exception):
    """resourceVersion mismatch (concurrent update)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


Event = Tuple[str, CustomResource]  # ("ADDED"|"MODIFIED"|"DELETED", obj)


class ObjectStore:
    def __init__(self, persist_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str], CustomResource] = {}  # (kind, ns/name)
        self._watchers: List[Callable[[Event], None]] = []
        self._rv = 0
        self.persist_dir = persist_dir
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._load()

    # ------------------------------------------------------------- helpers
    def _key(self, kind: str, namespace: str, name: str) -> Tuple[str, str]:
        return (kind, f"{namespace}/{name}")

    def _notify(self, event: Event):
        for w in list(self._watchers):
            try:
                w(event)
            except Exception:
                pass

    def watch(self, fn: Callable[[Event], None]):
        self._watchers.append(fn)

    # --------------------------------------------------------------- verbs
    def create(self, obj: CustomResource) -> CustomResource:
        with self._lock:
            k = self._key(obj.kind, obj.metadata.namespace, obj.metadata.name)
            if k in self._objects:
                raise AlreadyExists(f"{obj.kind} {k[1]}")
            self._rv += 1
            obj = obj.deepcopy()
            obj.metadata.resource_version = self._rv
            self._objects[k] = obj
            self._persist(obj)
            self._notify(("ADDED", obj.deepcopy()))
            return obj.deepcopy()

    def get(self, kind: Type[CustomResource] | str, name: str,
            namespace: str = "default") -> CustomResource:
        kind_name = kind if isinstance(kind, str) else kind.kind
        with self._lock:
            k = self._key(kind_name, namespace, name)
            if k not in self._objects:
                raise NotFound(f"{kind_name} {namespace}/{name}")
            return self._objects[k].deepcopy()

    def try_get(self, kind, name, namespace="default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, obj: CustomResource) -> CustomResource:
        """Optimistic-concurrency update (spec+metadata+status)."""
        with self._lock:
            k = self._key(obj.kind, obj.metadata.namespace, obj.metadata.name)
            if k not in self._objects:
                raise NotFound(f"{obj.kind} {k[1]}")
            current = self._objects[k]
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {k[1]}: rv {obj.metadata.resource_version} != "
                    f"{current.metadata.resource_version}"
                )
            if obj.to_dict() == current.to_dict():
                # no-op update: no rv bump, no event (otherwise every
                # reconcile-that-updates would re-enqueue itself forever)
                return current.deepcopy()
            self._rv += 1
            obj = obj.deepcopy()
            obj.metadata.resource_version = self._rv
            self._objects[k] = obj
            self._persist(obj)
            self._notify(("MODIFIED", obj.deepcopy()))
            # finalizer-gated deletion completes when the last finalizer is gone
            if obj.metadata.deletion_timestamp and not obj.metadata.finalizers:
                self._finalize_delete(k)
            return obj.deepcopy()

    def delete(self, kind, name, namespace="default"):
        """Marks deletion; object remains until finalizers are removed
        (k8s semantics the reference's finalizer handling relies on,
        finetune_controller.go:98-113)."""
        kind_name = kind if isinstance(kind, str) else kind.kind
        with self._lock:
            k = self._key(kind_name, namespace, name)
            if k not in self._objects:
                raise NotFound(f"{kind_name} {namespace}/{name}")
            obj = self._objects[k]
            if obj.metadata.finalizers:
                if not obj.metadata.deletion_timestamp:
                    self._rv += 1
                    obj.metadata.deletion_timestamp = time.time()
                    obj.metadata.resource_version = self._rv
                    self._persist(obj)
                    self._notify(("MODIFIED", obj.deepcopy()))
                return
            self._finalize_delete(k)

    def _finalize_delete(self, k):
        obj = self._objects.pop(k, None)
        if obj is None:
            return
        self._unpersist(obj)
        self._notify(("DELETED", obj.deepcopy()))
        # owner-reference cascade (controller-runtime GC equivalent)
        for child_key, child in list(self._objects.items()):
            for ref in child.metadata.owner_references:
                if (ref.get("kind") == obj.kind
                        and ref.get("name") == obj.metadata.name
                        and ref.get("uid") == obj.metadata.uid):
                    try:
                        self.delete(child.kind, child.metadata.name,
                                    child.metadata.namespace)
                    except NotFound:
                        pass

    def list(self, kind, namespace: Optional[str] = "default",
             labels: Optional[Dict[str, str]] = None) -> List[CustomResource]:
        kind_name = kind if isinstance(kind, str) else kind.kind
        with self._lock:
            out = []
            for (kn, _), obj in self._objects.items():
                if kn != kind_name:
                    continue
                if namespace and obj.metadata.namespace != namespace:
                    continue
                if labels and any(
                    obj.metadata.labels.get(k) != v for k, v in labels.items()
                ):
                    continue
                out.append(obj.deepcopy())
            return sorted(out, key=lambda o: o.metadata.name)

    # -------------------------------------------------------- persistence
    def _path(self, obj: CustomResource) -> str:
        return os.path.join(
            self.persist_dir,
            f"{obj.kind}__{obj.metadata.namespace}__{obj.metadata.name}.json",
        )

    def _persist(self, obj: CustomResource):
        if not self.persist_dir:
            return
        with open(self._path(obj), "w") as f:
            json.dump(obj.to_dict(), f, indent=1, sort_keys=True, default=str)

    def _unpersist(self, obj: CustomResource):
        if not self.persist_dir:
            return
        try:
            os.remove(self._path(obj))
        except FileNotFoundError:
            pass

    def _load(self):
        for fn in sorted(os.listdir(self.persist_dir)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(self.persist_dir, fn)) as f:
                d = json.load(f)
            cls = KIND_BY_NAME.get(d.get("kind"))
            if cls is None:
                continue
            obj = cls.from_dict(d)
            k = self._key(obj.kind, obj.metadata.namespace, obj.metadata.name)
            self._objects[k] = obj
            self._rv = max(self._rv, obj.metadata.resource_version)


def set_owner(child: CustomResource, owner: CustomResource):
    child.metadata.owner_references.append(
        {"kind": owner.kind, "name": owner.metadata.name, "uid": owner.metadata.uid}
    )
