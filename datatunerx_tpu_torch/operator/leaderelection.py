"""Lease-based leader election (coordination.k8s.io/v1; the port's copy of
``datatunerx_tpu/operator/leaderelection.py``, over the port's
``kubeclient``).

The reference gets HA from controller-runtime's leader election
(reference cmd/controller-manager/app/controller_manager.go:72-74; lease
timings from options.go:38-48). Round 1 accepted ``--leader-elect`` as a
no-op; with the kube adapter this is the real thing: replicas race on a Lease
object, the holder runs the reconcile loop, non-holders block, and a holder
that cannot renew within the lease duration is superseded.

Semantics match client-go's leaderelection package: acquire when the lease is
unheld or expired, renew on a period well under the lease duration, bump
``leaseTransitions`` on takeover, and call ``on_stopped_leading`` when a
renew discovers another holder (the replica should exit and let its
Deployment restart it — the same contract controller-runtime has).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from datatunerx_tpu_torch.operator.kubeclient import ApiError, KubeClient

LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL = "coordination.k8s.io", "v1", "leases"


def _micro_now() -> str:
    t = time.time()
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
    return f"{base}.{int((t % 1) * 1e6):06d}Z"


def _parse_micro(s: Optional[str]) -> Optional[float]:
    if not s:
        return None
    try:
        import calendar

        base, _, frac = s.rstrip("Z").partition(".")
        epoch = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
        return epoch + (float(f"0.{frac}") if frac else 0.0)
    except ValueError:
        return None


class LeaderElector:
    def __init__(
        self,
        client: KubeClient,
        lease_name: str = "datatunerx-tpu-controller-manager",
        namespace: str = "default",
        identity: Optional[str] = None,
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        import os
        import uuid

        self.client = client
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or f"{os.uname().nodename}_{uuid.uuid4().hex[:8]}"
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lease ops
    def _get_lease(self) -> Optional[dict]:
        try:
            return self.client.get(LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                                   self.namespace, self.lease_name)
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def _lease_expired(self, lease: dict) -> bool:
        spec = lease.get("spec") or {}
        renew = _parse_micro(spec.get("renewTime")) or _parse_micro(
            spec.get("acquireTime"))
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration_s)
        return renew is None or (time.time() - renew) > duration

    def try_acquire_or_renew(self) -> bool:
        """One acquire/renew attempt; returns current leadership."""
        now = _micro_now()
        lease = self._get_lease()
        try:
            if lease is None:
                self.client.create(
                    LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL, self.namespace,
                    {
                        "apiVersion": "coordination.k8s.io/v1",
                        "kind": "Lease",
                        "metadata": {"name": self.lease_name,
                                     "namespace": self.namespace},
                        "spec": {
                            "holderIdentity": self.identity,
                            "leaseDurationSeconds": int(self.lease_duration_s),
                            "acquireTime": now,
                            "renewTime": now,
                            "leaseTransitions": 0,
                        },
                    },
                )
                return True
            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity")
            if holder == self.identity:
                spec["renewTime"] = now
            elif self._lease_expired(lease):
                # takeover: previous holder stopped renewing
                spec.update(
                    holderIdentity=self.identity,
                    acquireTime=now,
                    renewTime=now,
                    leaseTransitions=int(spec.get("leaseTransitions") or 0) + 1,
                )
            else:
                return False
            lease["spec"] = spec
            self.client.replace(LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                                self.namespace, self.lease_name, lease)
            return True
        except ApiError as e:
            if e.status in (409,):  # lost a create/update race this round
                return False
            raise

    # ------------------------------------------------------------ lifecycle
    def run(self, stop: Optional[threading.Event] = None):
        """Blocking election loop: waits for leadership, fires
        on_started_leading, renews until leadership is lost (fires
        on_stopped_leading) or ``stop`` is set.

        A leader that cannot RENEW past its renew deadline must abdicate —
        another replica will rightfully take the lease once it expires, and
        because that expiry clock started at the apiserver-side write of the
        LAST successful renew, waiting the full lease duration locally leaves
        a split-brain window of up to one renew period. client-go's contract
        is renewDeadline < leaseDuration; mirrored here as
        lease_duration − renew_period."""
        stop = stop or self._stop
        last_renew_ok = time.time()
        renew_deadline_s = max(self.lease_duration_s - self.renew_period_s,
                               self.renew_period_s)
        while not stop.is_set():
            try:
                leading = self.try_acquire_or_renew()
                if leading:
                    last_renew_ok = time.time()
            except ApiError:
                # transient apiserver error: hold state only while no standby
                # could yet have observed our lease as expired
                leading = self.is_leader
                if (leading
                        and time.time() - last_renew_ok > renew_deadline_s):
                    leading = False
            if leading and not self.is_leader:
                self.is_leader = True
                if self.on_started_leading:
                    self.on_started_leading()
            elif not leading and self.is_leader:
                self.is_leader = False
                if self.on_stopped_leading:
                    self.on_stopped_leading()
                return
            if stop.wait(self.renew_period_s if self.is_leader
                         else min(self.renew_period_s, 1.0)):
                return

    def start(self):
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="leader-elector")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
