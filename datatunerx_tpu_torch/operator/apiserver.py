"""REST API server: the kubectl-shaped front door to the object store.

The reference's user surface is the k8s API server + 8 CRDs (SURVEY.md §1 L6,
kubectl/Helm/dtx-ctl/web UI). Without a cluster, this server provides the same
verbs over the in-process store so external tools (the dtx CLI, a UI, curl)
can drive the pipeline:

  GET    /apis                                    — discovery
  GET    /apis/{group}/{version}/{kind}           — list (``?labelSelector=k=v``)
  POST   /apis/{group}/{version}/{kind}           — create (admission applies)
  GET    /apis/{group}/{version}/{kind}/{ns}/{name}
  PUT    /apis/{group}/{version}/{kind}/{ns}/{name}
  DELETE /apis/{group}/{version}/{kind}/{ns}/{name}
  GET    /healthz | /readyz | /metrics

Admission (operator/webhooks.py) runs on create/update — the webhook-server
equivalent (reference controller_manager.go:114-134).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from datatunerx_tpu_torch.operator.api import ALL_KINDS, CustomResource, KIND_BY_NAME
from datatunerx_tpu_torch.operator.store import (
    AlreadyExists,
    Conflict,
    NotFound,
    ObjectStore,
)
from datatunerx_tpu_torch.operator.webhooks import AdmissionError

_GROUPS = {
    "finetune.datatunerx.io": ["Finetune", "FinetuneJob", "FinetuneExperiment"],
    "core.datatunerx.io": ["LLM", "Hyperparameter", "LLMCheckpoint"],
    "extension.datatunerx.io": ["Dataset", "Scoring"],
}
_KIND_LOWER = {k.kind.lower(): k.kind for k in ALL_KINDS}
# also accept plural-ish forms (kubectl habit)
for k in ALL_KINDS:
    _KIND_LOWER[k.kind.lower() + "s"] = k.kind

_PATH = re.compile(
    r"^/apis/(?P<group>[^/]+)/(?P<version>[^/]+)/(?P<kind>[^/]+)"
    r"(?:/(?P<ns>[^/]+)(?:/(?P<name>[^/]+))?)?$"
)


def _resolve_kind(raw: str) -> Optional[str]:
    return _KIND_LOWER.get(raw.lower())


class ApiHandler(BaseHTTPRequestHandler):
    store: ObjectStore = None
    manager = None
    token: Optional[str] = None  # DTX_API_TOKEN bearer auth when set

    def _authorized(self) -> bool:
        if not self.token:
            return True
        return self.headers.get("Authorization") == f"Bearer {self.token}"

    # ------------------------------------------------------------ plumbing
    def _send(self, code: int, payload):
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def log_message(self, *a):
        pass

    # --------------------------------------------------------------- verbs
    def do_GET(self):
        url = urlparse(self.path)
        if url.path in ("/healthz", "/readyz"):
            return self._send(200, {"status": "ok"})
        if not self._authorized():
            return self._send(401, {"error": "unauthorized"})
        if url.path in ("/", "/ui", "/ui/"):
            # single-file web UI (reference datatunerx-ui equivalent)
            import os

            try:
                with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "ui.html"), "rb") as f:
                    body = f.read()
            except OSError:
                return self._send(404, {"error": "ui.html not bundled"})
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path.startswith("/trainermetrics/"):
            # /trainermetrics/{ns}/{name}: trainer/eval jsonl curves for the UI
            parts = [p for p in url.path.split("/")[2:] if p]
            if len(parts) != 2:
                return self._send(400, {"error": "use /trainermetrics/{namespace}/{name}"})
            ns, name = parts
            if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", name):
                return self._send(400, {"error": "invalid job name"})
            if self.store.try_get("Finetune", name, ns) is None:
                return self._send(404, {"error": f"Finetune {ns}/{name} not found"})
            backend = getattr(self.manager, "training_backend", None) if self.manager else None
            series = getattr(backend, "metrics_series", None)
            if series is None:
                return self._send(
                    501, {"error": "metrics series not supported by this backend"})
            return self._send(200, {"name": name, **series(name)})
        if url.path == "/metrics":
            n_err = len(self.manager.errors) if self.manager else 0
            lines = [
                "# TYPE dtx_operator_reconcile_errors_total counter",
                f"dtx_operator_reconcile_errors_total {n_err}",
                "# TYPE dtx_operator_reconciles_total counter",
            ]
            counts = dict(  # snapshot: the manager thread inserts keys live
                getattr(self.manager, "reconcile_counts", {}) if self.manager else {}
            )
            for kind, n in sorted(counts.items()):
                lines.append(
                    f'dtx_operator_reconciles_total{{kind="{kind}"}} {n}')
            probe = getattr(self.manager, "health_probe", None) if self.manager else None
            if probe is not None:
                lines.append("# TYPE dtx_device_healthy gauge")
                lines.append(f"dtx_device_healthy {int(bool(probe.healthy))}")
            pool = getattr(self.manager, "slice_pool", None) if self.manager else None
            if pool is not None:
                lines.append("# TYPE dtx_slices_free gauge")
                lines.append(f"dtx_slices_free {pool.free_count()}")
                lines.append("# TYPE dtx_slices_total gauge")
                lines.append(f"dtx_slices_total {len(pool.slices())}")
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/apis":
            return self._send(200, {"groups": _GROUPS})
        if url.path.startswith("/logs/"):
            # /logs/{ns}/{name}: trainer log tail for a Finetune (local backend)
            parts = [p for p in url.path.split("/")[2:] if p]
            if len(parts) != 2:
                return self._send(400, {"error": "use /logs/{namespace}/{name}"})
            ns, name = parts
            if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", name):
                return self._send(400, {"error": "invalid job name"})
            if self.store.try_get("Finetune", name, ns) is None:
                return self._send(404, {"error": f"Finetune {ns}/{name} not found"})
            backend = getattr(self.manager, "training_backend", None) if self.manager else None
            tail = getattr(backend, "log_tail", None)
            if tail is None:
                return self._send(501, {"error": "log tail not supported by this backend"})
            return self._send(200, {"name": name, "log": tail(name, 100)})

        m = _PATH.match(url.path)
        if not m:
            return self._send(404, {"error": "not found"})
        kind = _resolve_kind(m["kind"])
        if kind is None:
            return self._send(404, {"error": f"unknown kind {m['kind']}"})

        if m["name"]:
            try:
                obj = self.store.get(kind, m["name"], m["ns"] or "default")
            except NotFound as e:
                return self._send(404, {"error": str(e)})
            return self._send(200, obj.to_dict())

        qs = parse_qs(url.query)
        labels = None
        if "labelSelector" in qs:
            try:
                labels = dict(
                    pair.split("=", 1)
                    for pair in qs["labelSelector"][0].split(",")
                )
            except ValueError:
                return self._send(
                    400, {"error": "labelSelector must be k=v[,k=v...]"}
                )
        ns = m["ns"] or qs.get("namespace", ["default"])[0]
        items = self.store.list(kind, namespace=None if ns == "-" else ns,
                                labels=labels)
        return self._send(200, {"kind": f"{kind}List",
                                "items": [o.to_dict() for o in items]})

    def do_POST(self):
        if not self._authorized():
            return self._send(401, {"error": "unauthorized"})
        m = _PATH.match(urlparse(self.path).path)
        if not m:
            return self._send(404, {"error": "not found"})
        kind = _resolve_kind(m["kind"])
        if kind is None:
            return self._send(404, {"error": f"unknown kind {m['kind']}"})
        try:
            payload = self._body()
            obj = KIND_BY_NAME[kind].from_dict(payload)
            if not obj.metadata.name:
                return self._send(400, {"error": "metadata.name is required"})
            created = self.store.create(obj)
            return self._send(201, created.to_dict())
        except AdmissionError as e:
            return self._send(422, {"error": f"admission denied: {e}"})
        except AlreadyExists as e:
            return self._send(409, {"error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            return self._send(400, {"error": str(e)})

    def do_PUT(self):
        if not self._authorized():
            return self._send(401, {"error": "unauthorized"})
        m = _PATH.match(urlparse(self.path).path)
        if not m or not m["name"]:
            return self._send(404, {"error": "not found"})
        kind = _resolve_kind(m["kind"])
        if kind is None:
            return self._send(404, {"error": f"unknown kind {m['kind']}"})
        try:
            obj = KIND_BY_NAME[kind].from_dict(self._body())
            if (obj.metadata.name != m["name"]
                    or obj.metadata.namespace != (m["ns"] or "default")):
                return self._send(400, {
                    "error": "metadata.name/namespace must match the URL path"})
            # kube semantics: a main-resource PUT cannot write .status (that
            # is the /status subresource, which this server doesn't expose) —
            # keep the stored status so a UI/CLI spec edit can't wipe
            # controller bookkeeping (scores, checkpoint refs)
            try:
                obj.status = self.store.get(
                    kind, m["name"], m["ns"] or "default").status
            except NotFound:
                pass
            updated = self.store.update(obj)
            return self._send(200, updated.to_dict())
        except AdmissionError as e:
            return self._send(422, {"error": f"admission denied: {e}"})
        except Conflict as e:
            return self._send(409, {"error": str(e)})
        except NotFound as e:
            return self._send(404, {"error": str(e)})
        except (ValueError, KeyError, TypeError) as e:
            return self._send(400, {"error": str(e)})

    def do_DELETE(self):
        if not self._authorized():
            return self._send(401, {"error": "unauthorized"})
        m = _PATH.match(urlparse(self.path).path)
        if not m or not m["name"]:
            return self._send(404, {"error": "not found"})
        kind = _resolve_kind(m["kind"])
        if kind is None:
            return self._send(404, {"error": f"unknown kind {m['kind']}"})
        try:
            self.store.delete(kind, m["name"], m["ns"] or "default")
            return self._send(200, {"status": "deleted"})
        except NotFound as e:
            return self._send(404, {"error": str(e)})


def serve_api(store, manager=None, port: int = 8080, host: str = "127.0.0.1",
              token: Optional[str] = None):
    """Start the API server on a background thread; returns (server, port).

    Binds loopback by default — this API is full-CRUD and can launch local
    processes via the backends; expose it beyond localhost only behind a
    bearer token (``token`` / DTX_API_TOKEN) or a real ingress."""
    import os

    token = token if token is not None else os.environ.get("DTX_API_TOKEN")
    handler = type("BoundApiHandler", (ApiHandler,), {"store": store,
                                                      "manager": manager,
                                                      "token": token or None})
    srv = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_port
