"""Controller-manager entrypoint (the port of
``datatunerx_tpu/operator/manager.py``; reference main.go +
cmd/controller-manager/app/controller_manager.go): build the object store,
register the three controllers (+ scoring), run the reconcile loop.

  dtx-torch-controller-manager --backend local [--device cpu]
      [--storage-path file:///…] [--device-health-interval 5]
  dtx-torch-controller-manager --backend kube [--kube-url URL]
      [--kube-namespace NS] [--leader-elect true]
  (or ``python -m datatunerx_tpu_torch.operator.manager``)

``--backend local`` runs the port's trainers (``tuning/train.py``) and
servers (``serving/server.py``) as subprocesses on ``--device`` (``cuda``
unless the caller asks for the CPU: without a card they fail),
``manifest`` renders GPU workloads, ``fake`` scripts them, and ``kube``
keeps the CRs in a Kubernetes apiserver (``kubestore.py``) and submits the
port's GPU JobSets and server Deployments there (``kubebackends.py``),
with lease-based leader election and the HTTPS admission webhooks. The
REST API (``apiserver.py``: ``/apis/...``, ``/healthz``, ``/metrics``)
listens on ``--metrics-bind-address``; ``dtx-torch
apply|get|status|delete|logs`` talk to it. CLI flags mirror the reference
options (options.go:38-48).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from datatunerx_tpu_torch.operator.backends import (
    FakeServingBackend,
    FakeTrainingBackend,
    LocalProcessBackend,
    ManifestBackend,
)
from datatunerx_tpu_torch.operator.finetune_controller import FinetuneController
from datatunerx_tpu_torch.operator.finetuneexperiment_controller import (
    FinetuneExperimentController,
)
from datatunerx_tpu_torch.operator.finetunejob_controller import FinetuneJobController
from datatunerx_tpu_torch.operator.reconciler import Manager
from datatunerx_tpu_torch.operator.store import ObjectStore
from datatunerx_tpu_torch.operator.webhooks import AdmittingStore


def build_manager(
    store: ObjectStore,
    training_backend,
    serving_backend,
    storage_path: str | None = None,
    with_scoring: bool = True,
    health_probe=None,
    slice_pool=None,
) -> Manager:
    mgr = Manager(store)
    mgr.training_backend = training_backend  # exposed for the /logs endpoint
    mgr.health_probe = health_probe  # exposed for /metrics
    mgr.slice_pool = slice_pool  # exposed for /metrics
    if slice_pool is not None:
        _restore_placements(store, slice_pool)
    mgr.register(FinetuneController(training_backend, storage_path=storage_path,
                                    health_probe=health_probe,
                                    slice_pool=slice_pool))
    mgr.register(FinetuneJobController(serving_backend,
                                       slice_pool=slice_pool))
    mgr.register(FinetuneExperimentController())
    if with_scoring:
        from datatunerx_tpu_torch.scoring.controller import ScoringController

        mgr.register(ScoringController())
    return mgr


def _restore_placements(store, slice_pool, attempts: int = 5):
    """Rebuild slice assignments from Finetune.status.placement so restarts
    (and leadership takeovers) don't double-book sub-slices. A transient
    apiserver error must NOT silently skip restore — double-booked slices
    wedge both jobs — so this retries briefly and then raises (crash →
    pod restart → clean retry)."""
    import time as _time

    from datatunerx_tpu_torch.operator.api import Finetune

    finetunes = None
    for i in range(attempts):
        try:
            finetunes = store.list(Finetune, namespace=None)
            break
        except Exception as e:  # noqa: BLE001
            print(f"[controller-manager] placement restore list failed "
                  f"({i + 1}/{attempts}): {e}", flush=True)
            if i == attempts - 1:
                raise
            _time.sleep(3)
    # full rebuild, never a merge: a boot-time snapshot in a standby can
    # record holds released (and re-assigned) by the old leader since
    slice_pool.reset()
    for ft in finetunes:
        placement = ft.status.get("placement")
        state = ft.status.get("state", "")
        if placement and state not in (Finetune.STATE_SUCCESSFUL,
                                       Finetune.STATE_FAILED):
            try:
                slice_pool.restore(ft.metadata.name, placement.get("name", ""))
            except ValueError as e:
                print(f"[controller-manager] placement restore: {e}", flush=True)


def _neutralize_webhook_configs(client) -> None:
    """With no webhook server running, leftover failurePolicy:Fail
    configurations reject every CREATE/UPDATE of the webhooked kinds
    cluster-wide (the apiserver can't reach :9443). Flip them to Ignore —
    loudly — so a cryptography-less deployment degrades to in-process-only
    admission instead of a silent cluster-wide outage."""
    for plural, name in (
        ("validatingwebhookconfigurations", "datatunerx-validating-webhook"),
        ("mutatingwebhookconfigurations", "datatunerx-mutating-webhook"),
    ):
        path = f"/apis/admissionregistration.k8s.io/v1/{plural}/{name}"
        try:
            cfg = client.request("GET", path)
        except Exception:  # noqa: BLE001 — absent: nothing to neutralize
            continue
        changed = False
        for wh in cfg.get("webhooks") or []:
            if wh.get("failurePolicy") != "Ignore":
                wh["failurePolicy"] = "Ignore"
                changed = True
        if not changed:
            continue
        try:
            client.request("PUT", path, body=cfg)
            print(f"[controller-manager] WARNING: set failurePolicy=Ignore "
                  f"on {name} — kubectl-applied CRs are NOT validated until "
                  "the webhook server is restored", flush=True)
        except Exception as pe:  # noqa: BLE001
            print(f"[controller-manager] ERROR: could not neutralize {name} "
                  f"({pe}); kubectl CREATE/UPDATE of webhooked kinds will "
                  "FAIL cluster-wide until it is deleted or the webhook "
                  "server is restored", flush=True)


def webhook_cert_sans(service_name: str, namespace: str) -> list:
    """Serving-cert SANs for the admission webhook server.

    A real apiserver routes service-style clientConfig traffic to
    ``<service>.<ns>.svc`` and verifies the webhook's serving certificate
    against that DNS name (the reference's cert-rotator certs the webhook
    Service name for the same reason). localhost stays FIRST: the default
    ``--webhook-url-base`` is derived from dns_names[0] and must keep
    resolving for url-style dev / fake-apiserver routing."""
    return [
        "localhost",
        "127.0.0.1",
        f"{service_name}.{namespace}.svc",
        f"{service_name}.{namespace}.svc.cluster.local",
    ]


def _interrupt(signum, frame):
    raise KeyboardInterrupt


class _HealthHandler(BaseHTTPRequestHandler):
    """Probe-only endpoint (reference --health-probe-bind-address,
    options.go:13-14); metrics live on the API address only."""

    manager: Manager = None

    def do_GET(self):
        if self.path in ("/healthz", "/readyz"):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, *a):
        pass


def main(argv=None):
    p = argparse.ArgumentParser(prog="dtx-torch-controller-manager")
    # reference options.go:38-48
    p.add_argument("--metrics-bind-address", default=":8080")
    p.add_argument("--health-probe-bind-address", default=":8081")
    p.add_argument("--leader-elect", default="false",
                   help="lease-based leader election (kube backend; no-op "
                        "for in-process stores, which are single-replica "
                        "by construction)")
    p.add_argument("--leader-lease-duration", type=float, default=15.0)
    p.add_argument("--leader-renew-period", type=float, default=5.0)
    p.add_argument("--enable-cert-rotator", default="true",
                   help="kube backend: rotate the webhook TLS cert before "
                        "expiry and re-patch the caBundle (reference "
                        "cert-rotator, controller_manager.go:83-111)")
    p.add_argument("--webhook-bind-address", default=":9443",
                   help="kube backend: admission webhook HTTPS address "
                        "(reference webhook server port, "
                        "controller_manager.go:70); ':0' picks a free port, "
                        "'disabled' turns the webhook server off")
    p.add_argument("--webhook-cert-dir", default="/tmp/dtx-webhook-certs",
                   help="local TLS cert dir for the webhook server (with "
                        "--webhook-cert-secret: the materialization dir for "
                        "the shared Secret)")
    p.add_argument("--webhook-cert-secret", default=None,
                   help="name of a Secret holding the webhook CA + serving "
                        "cert, shared by every replica (HA; rotation is "
                        "gated on the election leader). Unset: certs are "
                        "generated per-process under --webhook-cert-dir, "
                        "which is only correct at replicas=1")
    p.add_argument("--webhook-url-base", default=None,
                   help="externally reachable base URL of this webhook "
                        "server, written into the webhook configurations "
                        "(default: https://<first-cert-SAN>:<port>)")
    p.add_argument("--webhook-service-name",
                   default="datatunerx-webhook-service",
                   help="Service routing admission traffic to this webhook "
                        "server (deploy/webhooks.yaml clientConfig.service); "
                        "its cluster DNS names are added to the serving-cert "
                        "SANs so a real apiserver's TLS verification of "
                        "service-style routing succeeds")
    p.add_argument("--webhook-service-namespace", default=None,
                   help="namespace of that Service (default: the pod's own "
                        "namespace via the serviceaccount file / "
                        "OPERATOR_NAMESPACE — NOT --kube-namespace, which "
                        "scopes the CRs being reconciled)")
    # TPU-native options
    p.add_argument("--persist-dir", default=None,
                   help="JSON object store directory (durable CRs)")
    p.add_argument("--backend", choices=["local", "manifest", "kube", "fake"],
                   default="local")
    p.add_argument("--workdir", default="/tmp/dtx-operator")
    p.add_argument("--storage-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the local backend's trainers and servers and "
                        "the health probe run: cuda (default; they fail "
                        "without a card) or cpu")
    # kube mode: CRs + workloads through a real apiserver (in-cluster config
    # is auto-detected when --kube-url is omitted)
    p.add_argument("--kube-url", default=None,
                   help="apiserver base URL (default: in-cluster config)")
    p.add_argument("--kube-namespace", default="default")
    p.add_argument("--device-health-interval", type=float, default=0.0,
                   help="seconds between local-device health probes (0 = off; "
                        "--backend local only — cluster backends rely on "
                        "kubelet/JobSet health); while unhealthy, new "
                        "Finetunes hold in Pending instead of submitting "
                        "onto a broken card")
    args = p.parse_args(argv)
    if args.device_health_interval > 0 and args.backend != "local":
        print("[controller-manager] warning: --device-health-interval only "
              f"applies to --backend local (got {args.backend!r}); ignored",
              flush=True)

    if args.storage_path:
        # one source of truth: generate.py renders --storage_path for trainers
        # from env config, and the Finetune controller reads manifests from the
        # same key — both must see this value
        import os

        os.environ["STORAGE_PATH"] = args.storage_path

    if args.backend == "kube":
        from datatunerx_tpu_torch.operator.kubebackends import (
            KubeServingBackend,
            KubeTrainingBackend,
        )
        from datatunerx_tpu_torch.operator.kubeclient import KubeClient
        from datatunerx_tpu_torch.operator.kubestore import KubeObjectStore

        client = KubeClient(base_url=args.kube_url,
                            namespace=args.kube_namespace)
        from datatunerx_tpu_torch.operator.placement import pool_from_env

        store = AdmittingStore(KubeObjectStore(client))
        training = KubeTrainingBackend(client, namespace=args.kube_namespace,
                                       out_dir=args.workdir)
        serving = KubeServingBackend(client, namespace=args.kube_namespace,
                                     out_dir=args.workdir)
        mgr = build_manager(store, training, serving,
                            storage_path=args.storage_path,
                            slice_pool=pool_from_env())
        mgr.leader_callbacks = []

        # Leader election BEFORE webhook setup: the cert-rotation loop gates
        # generation on leadership (standbys only hot-reload the shared
        # Secret), so the webhook server needs the elector handle.
        elector = None
        if str(args.leader_elect).lower() in ("true", "1", "yes"):
            import os as _os

            from datatunerx_tpu_torch.operator.leaderelection import LeaderElector

            # lost leadership = exit; the Deployment restarts the replica,
            # which re-enters the election (controller-runtime's contract)
            elector = LeaderElector(
                client, namespace=args.kube_namespace,
                lease_duration_s=args.leader_lease_duration,
                renew_period_s=args.leader_renew_period,
                on_stopped_leading=lambda: _os._exit(1),
            )

        # Kubernetes-native admission: serve the webhook rules over TLS and
        # register the configurations so kubectl-applied CRs are validated by
        # the apiserver itself, not just by this process's AdmittingStore.
        if args.webhook_bind_address != "disabled":
            import importlib.util

            if importlib.util.find_spec("cryptography") is None:
                # precise probe, NOT a broad except ImportError around the
                # setup block: a genuine packaging/refactor bug in our own
                # modules must crash loudly, while a host without
                # cryptography degrades to in-process-only admission.
                # Existing failurePolicy:Fail configurations from a prior
                # run would keep rejecting EVERY kubectl CREATE/UPDATE
                # against an unserved :9443 — neutralize them (a later
                # healthy start's install_webhooks restores Fail).
                print("[controller-manager] WARNING: admission webhook "
                      "server disabled (no module named 'cryptography'); "
                      "install 'cryptography' to enforce validation on "
                      "kubectl-applied CRs (in-process admission via "
                      "AdmittingStore remains active)", flush=True)
                _neutralize_webhook_configs(client)
            else:
                from datatunerx_tpu_torch.operator.webhook_server import (
                    AdmissionWebhookServer,
                    CertManager,
                    install_webhooks,
                )

                wh_host, _, wh_port = args.webhook_bind_address.rpartition(":")
                # SANs must cover service-style routing (failurePolicy Fail
                # would otherwise reject every CREATE/UPDATE cluster-wide).
                # The Service lives in the OPERATOR's namespace (the pod's
                # own, per the serviceaccount file), which is not the same
                # thing as --kube-namespace (the CR scope).
                from datatunerx_tpu_torch.operator.config import (
                    get_operator_namespace,
                )

                wh_ns = (args.webhook_service_namespace
                         or get_operator_namespace())
                sans = webhook_cert_sans(args.webhook_service_name, wh_ns)
                if args.webhook_cert_secret:
                    from datatunerx_tpu_torch.operator.webhook_server import (
                        SecretBackedCertManager,
                    )

                    # HA: one CA for the whole Deployment, held in a Secret.
                    # Boot is leaderless-CAS (first writer wins, losers
                    # converge); ongoing rotation is leader-gated below.
                    certs = SecretBackedCertManager(
                        client, namespace=wh_ns,
                        secret_name=args.webhook_cert_secret,
                        cert_dir=args.webhook_cert_dir, dns_names=sans)
                else:
                    certs = CertManager(args.webhook_cert_dir,
                                        dns_names=sans)
                wh_srv = AdmissionWebhookServer(
                    certs, host=wh_host or "0.0.0.0",
                    port=int(wh_port or 9443))
                base = (args.webhook_url_base
                        or f"https://{certs.dns_names[0]}:{wh_srv.port}")
                rotate = (3600.0 if str(args.enable_cert_rotator).lower()
                          in ("true", "1", "yes") else 0.0)
                wh_srv.start(
                    rotation_check_s=rotate,
                    on_rotate=lambda ca: install_webhooks(client, ca, base),
                    is_leader=(None if elector is None
                               else lambda: elector.is_leader),
                )
                install_webhooks(client, certs.ca_bundle_b64(), base)

                def _reassert_ca():
                    # A leader can rotate the Secret and crash before
                    # re-patching the caBundle; whoever takes over converges
                    # on the Secret (rotating it if it went stale), reloads
                    # its own TLS, and re-asserts the CURRENT CA into the
                    # webhook configs on promotion.
                    if certs.ensure(as_leader=True):
                        wh_srv._ssl_ctx.load_cert_chain(
                            certs.cert_path, certs.key_path)
                    install_webhooks(client, certs.ca_bundle_b64(), base)

                mgr.leader_callbacks.append(_reassert_ca)
                print("[controller-manager] admission webhooks on "
                      f":{wh_srv.port}", flush=True)

        return _run_manager(args, store, mgr, elector=elector)

    store = AdmittingStore(ObjectStore(persist_dir=args.persist_dir))
    probe = None
    if args.backend == "local":
        training = LocalProcessBackend(args.workdir, device=args.device)
        from datatunerx_tpu_torch.serving.local_backend import (
            LocalServingBackend,
        )

        serving = LocalServingBackend(args.workdir, device=args.device)
        if args.device_health_interval > 0:
            from datatunerx_tpu_torch.operator.health import DeviceHealthProbe

            probe = DeviceHealthProbe(
                interval_s=args.device_health_interval,
                idle_check=lambda: not training.has_active_jobs(),
                device=args.device,
            ).start()
    elif args.backend == "manifest":
        training = ManifestBackend(args.workdir)
        serving = FakeServingBackend()
    else:
        training, serving = FakeTrainingBackend(), FakeServingBackend()

    from datatunerx_tpu_torch.operator.placement import pool_from_env

    mgr = build_manager(store, training, serving, storage_path=args.storage_path,
                        health_probe=probe, slice_pool=pool_from_env())
    return _run_manager(args, store, mgr)


def _run_manager(args, store, mgr: Manager, elector=None) -> int:
    # REST API (kubectl-shaped user surface + metrics) on the metrics address,
    # plain health probes on the probe address — mirroring the reference's
    # :8080/:8081 split (options.go:13-14)
    from datatunerx_tpu_torch.operator.apiserver import serve_api

    api_host, _, api_port = args.metrics_bind_address.rpartition(":")
    api_srv, api_port = serve_api(
        store, manager=mgr, port=int(api_port),
        host=api_host or "127.0.0.1",  # loopback unless explicitly widened
    )

    health_port = int(args.health_probe_bind_address.rsplit(":", 1)[-1])
    _HealthHandler.manager = mgr
    srv = ThreadingHTTPServer(("0.0.0.0", health_port), _HealthHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    if elector is not None:
        def lead():
            print(f"[controller-manager] became leader as {elector.identity}",
                  flush=True)
            for cb in getattr(mgr, "leader_callbacks", None) or []:
                try:
                    cb()
                except Exception as e:  # noqa: BLE001 — a failed CA
                    # re-assert must not block promotion; the rotation loop
                    # retries on its next check
                    print(f"[controller-manager] leader callback failed: {e}",
                          flush=True)
            if getattr(mgr, "slice_pool", None) is not None:
                # re-read assignments at takeover: the boot-time snapshot of
                # a standby predates jobs the previous leader placed
                _restore_placements(mgr.store, mgr.slice_pool)
            mgr.sync_all()
            mgr.start()

        elector.on_started_leading = lead
        elector.start()
        print(
            f"[controller-manager] standing by for leadership; api+metrics on "
            f":{api_port}, health on :{health_port}",
            flush=True,
        )
    else:
        mgr.sync_all()
        mgr.start()
        print(
            f"[controller-manager] running; api+metrics on :{api_port}, "
            f"health on :{health_port}",
            flush=True,
        )
    # SIGTERM takes the KeyboardInterrupt path, so the loop and the servers
    # stop
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        mgr.stop()
        srv.shutdown()
        api_srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
