"""Minimal Kubernetes API client, stdlib only (urllib + ssl): the port's
own copy of ``datatunerx_tpu/operator/kubeclient.py``, which the port may
not import.

The transport under the port's kube-backed training and serving backends
(``operator/kubebackends.py``): a thin REST layer over the apiserver's
group/version/plural endpoints:

  /apis/{group}/{version}/namespaces/{ns}/{plural}[/{name}[/status]]

Supports in-cluster configuration (service-account token + CA at the
standard mount paths) and an explicit base URL and token for tests against
a fake apiserver.
"""

from __future__ import annotations

import http.client
import json
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterable, Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiError(Exception):
    def __init__(self, status: int, reason: str = "", body: str = ""):
        self.status = status
        self.reason = reason
        self.body = body
        super().__init__(f"kube api {status} {reason}: {body[:200]}")


class KubeClient:
    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        namespace: str = "default",
        timeout: float = 30.0,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "no base_url and not in-cluster (KUBERNETES_SERVICE_HOST unset)"
                )
            base_url = f"https://{host}:{port}"
            token_file = os.path.join(SA_DIR, "token")
            if token is None and os.path.exists(token_file):
                with open(token_file) as f:
                    token = f.read().strip()
            ca_file = os.path.join(SA_DIR, "ca.crt")
            if ca_cert is None and os.path.exists(ca_file):
                ca_cert = ca_file
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.namespace = namespace
        self.timeout = timeout
        if self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca_cert)
            if ca_cert is None:  # token-only auth against self-signed apiserver
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
        else:
            self._ctx = None

    # ------------------------------------------------------------- request
    def request(self, method: str, path: str, body: Optional[dict] = None,
                timeout: Optional[float] = None) -> dict:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self._ctx
            ) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.reason, e.read().decode(errors="replace"))
        except urllib.error.URLError as e:
            raise ApiError(0, str(e.reason), "")
        except (OSError, http.client.HTTPException) as e:
            # raw socket / HTTP-protocol failures (ConnectionResetError,
            # RemoteDisconnected, …) are not URLError subclasses; callers —
            # the leader elector above all — rely on every transport failure
            # surfacing as ApiError, never a leaked socket exception
            raise ApiError(0, repr(e), "")
        return json.loads(raw) if raw else {}

    # ---------------------------------------------------------- path utils
    @staticmethod
    def path_for(group: str, version: str, plural: str,
                 namespace: Optional[str], name: Optional[str] = None,
                 subresource: Optional[str] = None) -> str:
        prefix = "/api/v1" if not group else f"/apis/{group}/{version}"
        p = prefix
        if namespace:
            p += f"/namespaces/{namespace}"
        p += f"/{plural}"
        if name:
            p += f"/{name}"
        if subresource:
            p += f"/{subresource}"
        return p

    # ----------------------------------------------------------- CRUD-ish
    def create(self, group, version, plural, namespace, body) -> dict:
        return self.request(
            "POST", self.path_for(group, version, plural, namespace), body
        )

    def get(self, group, version, plural, namespace, name) -> dict:
        return self.request(
            "GET", self.path_for(group, version, plural, namespace, name)
        )

    def replace(self, group, version, plural, namespace, name, body,
                subresource: Optional[str] = None) -> dict:
        return self.request(
            "PUT",
            self.path_for(group, version, plural, namespace, name, subresource),
            body,
        )

    def delete(self, group, version, plural, namespace, name) -> dict:
        return self.request(
            "DELETE", self.path_for(group, version, plural, namespace, name)
        )

    def list(self, group, version, plural, namespace=None,
             label_selector: Optional[str] = None) -> dict:
        path = self.path_for(group, version, plural, namespace)
        if label_selector:
            path += "?labelSelector=" + urllib.parse.quote(label_selector)
        return self.request("GET", path)

    # -------------------------------------------------------------- watch
    def watch(
        self,
        group, version, plural,
        namespace: Optional[str],
        on_event: Callable[[str, dict], None],
        stop: threading.Event,
        resource_version: Optional[str] = None,
        reconnect_delay: float = 1.0,
    ) -> None:
        """Blocking watch loop: streams JSON event lines, invoking
        ``on_event(type, object)``; reconnects (from the last seen
        resourceVersion) until ``stop`` is set. Run on a daemon thread."""
        rv = resource_version
        while not stop.is_set():
            path = self.path_for(group, version, plural, namespace)
            q = {"watch": "true"}
            if rv:
                q["resourceVersion"] = rv
            url = self.base_url + path + "?" + urllib.parse.urlencode(q)
            req = urllib.request.Request(url)
            if self.token:
                req.add_header("Authorization", f"Bearer {self.token}")
            try:
                with urllib.request.urlopen(
                    req, timeout=330, context=self._ctx
                ) as resp:
                    for line in resp:
                        if stop.is_set():
                            return
                        line = line.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        obj = ev.get("object", {})
                        if ev.get("type") == "ERROR":
                            # in-stream Status (e.g. 410 Gone after etcd
                            # compaction): the bookmark is stale — restart
                            # from a fresh list or the watch wedges forever
                            if obj.get("code") == 410:
                                rv = None
                            break
                        new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                        if new_rv:
                            rv = new_rv
                        if ev.get("type") == "BOOKMARK":
                            continue
                        on_event(ev.get("type", ""), obj)
            except urllib.error.HTTPError as e:
                if e.code == 410:  # history compacted: stale resourceVersion
                    rv = None
                if stop.wait(reconnect_delay):
                    return
            except (urllib.error.URLError, OSError, ValueError):
                if stop.wait(reconnect_delay):
                    return


def iter_chunked_json(lines: Iterable[bytes]):
    """Parse a k8s watch stream (one JSON object per line)."""
    for line in lines:
        line = line.strip()
        if line:
            yield json.loads(line)
