"""Controller-manager entrypoint (the port of
``datatunerx_tpu/operator/manager.py``; reference main.go +
cmd/controller-manager/app/controller_manager.go): wires store + webhooks +
the three finetune controllers + the built-in scoring controller over a chosen
backend pair, exposes health/metrics endpoints, and runs the reconcile loop.

  dtx-torch-controller-manager --backend local [--device cpu]
      [--storage-path file:///…] [--device-health-interval 5]
  (or ``python -m datatunerx_tpu_torch.operator.manager``)

``--backend local`` runs the port's trainers (``tuning/train.py``) and
servers (``serving/server.py``) as subprocesses on ``--device`` (``cuda``
unless the caller asks for the CPU: without a card they fail),
``manifest`` renders GPU workloads, ``fake`` scripts them. ``--backend
kube`` is not ported yet and raises with its ROADMAP item. The REST API
(``apiserver.py``: ``/apis/...``, ``/healthz``, ``/metrics``) listens on
``--metrics-bind-address``; ``dtx-torch apply|get|status|delete|logs``
talk to it. CLI flags mirror the reference options
(options.go:38-48); leader election and cert rotation belong to the
Kubernetes mode (``--leader-elect`` is accepted as a no-op).
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
                   help="accepted and ignored: in-process stores are "
                        "single-replica by construction (election belongs "
                        "to the Kubernetes mode)")
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
    p.add_argument("--device-health-interval", type=float, default=0.0,
                   help="seconds between local-device health probes (0 = off; "
                        "--backend local only — cluster backends rely on "
                        "kubelet/JobSet health); while unhealthy, new "
                        "Finetunes hold in Pending instead of submitting "
                        "onto a broken card")
    args = p.parse_args(argv)
    if args.backend == "kube":
        raise NotImplementedError(
            "not ported yet: --backend kube (ROADMAP Queue 1 item 13 (the "
            "operator's Kubernetes mode))")
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


def _run_manager(args, store, mgr: Manager) -> int:
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
