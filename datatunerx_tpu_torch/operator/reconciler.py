"""Reconciler framework: controller-runtime semantics in ~150 lines.

Mirrors what the reference gets from sigs.k8s.io/controller-runtime
(SURVEY.md §2.1 G2): a Manager owning a work queue per controller, watch-driven
re-entry, `Result{requeue_after}`, MaxConcurrentReconciles=1 (the reference
pins this, finetunejob_controller.go:209), conflict retry, and the
handle_err requeue policy applied to reconciler exceptions.

Controllers implement:
    kind: the CR class they own
    reconcile(store, obj) -> Result | None
    watches(event) -> list[(namespace, name)]   # optional cross-kind triggers
"""

from __future__ import annotations

import os
import dataclasses
import heapq
import threading
import time
from typing import List, Optional, Protocol, Tuple

from datatunerx_tpu_torch.operator.errors import handle_err
from datatunerx_tpu_torch.operator.store import Conflict, NotFound, ObjectStore


@dataclasses.dataclass
class Result:
    requeue_after: Optional[float] = None  # seconds


class Controller(Protocol):
    kind: type

    def reconcile(self, store: ObjectStore, obj) -> Optional[Result]: ...


class Manager:
    """Drives all registered controllers off one store. `run_until_idle` is the
    envtest-style synchronous mode used by tests and the local pipeline runner;
    `start`/`stop` run the same loop on a background thread."""

    def __init__(self, store: ObjectStore):
        self.store = store
        self.controllers: List[Controller] = []
        self._queue: List[Tuple[float, int, str, str, str]] = []  # (t, seq, kind, ns, name)
        self._seq = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors: List[Tuple[str, BaseException]] = []
        self.reconcile_counts: dict = {}  # kind -> reconciles run
        store.watch(self._on_event)

    # ------------------------------------------------------------ plumbing
    def register(self, controller: Controller):
        self.controllers.append(controller)

    def _on_event(self, event):
        etype, obj = event
        # owner gets re-queued when a child changes (controller-runtime Owns())
        self.enqueue(obj.kind, obj.metadata.namespace, obj.metadata.name)
        for ref in obj.metadata.owner_references:
            self.enqueue(ref["kind"], obj.metadata.namespace, ref["name"])
        # explicit cross-kind watches (reference Watches(...) wiring,
        # finetunejob_controller.go:162-206)
        for c in self.controllers:
            watches = getattr(c, "watches", None)
            if watches is None:
                continue
            for ns, name in watches(event) or []:
                self.enqueue(c.kind.kind, ns, name)

    def enqueue(self, kind: str, namespace: str, name: str, after: float = 0.0):
        kind = kind if isinstance(kind, str) else kind.kind
        if not any(c.kind.kind == kind for c in self.controllers):
            return
        with self._cv:
            self._seq += 1
            heapq.heappush(
                self._queue, (time.monotonic() + after, self._seq, kind, namespace, name)
            )
            self._cv.notify()

    # ----------------------------------------------------------- execution
    def _reconcile_one(self, kind: str, namespace: str, name: str):
        controller = next((c for c in self.controllers if c.kind.kind == kind), None)
        if controller is None:
            return
        obj = self.store.try_get(kind, name, namespace)
        if obj is None:
            return
        self.reconcile_counts[kind] = self.reconcile_counts.get(kind, 0) + 1
        try:
            result = controller.reconcile(self.store, obj)
        except Conflict:
            self.enqueue(kind, namespace, name, after=0.0)  # retry on fresh read
            return
        except BaseException as e:  # noqa: BLE001 - reconcilers must not kill the loop
            after, err = handle_err(e)
            if err is not None:
                self.errors.append((f"{kind}/{namespace}/{name}", err))
            if after is not None:
                self.enqueue(kind, namespace, name, after=after)
            return
        if result and result.requeue_after is not None:
            self.enqueue(kind, namespace, name, after=result.requeue_after)

    # test suites that shrink the poll intervals (conftest DTX_*_S envs) must
    # shrink the idle horizon below the smallest interval, or run_until_idle
    # would spin-reconcile poll-style waits until max_wall_s
    IDLE_HORIZON_S = float(os.environ.get("DTX_IDLE_HORIZON_S", "0.5"))

    def run_until_idle(self, max_wall_s: float = 30.0,
                       treat_delayed_as_idle: float = None):
        """Process the queue synchronously until it only holds far-future
        requeues (poll-style waits) or is empty. Virtual time: delayed items
        under `treat_delayed_as_idle`s run immediately."""
        if treat_delayed_as_idle is None:
            treat_delayed_as_idle = self.IDLE_HORIZON_S
        deadline = time.monotonic() + max_wall_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._queue:
                    return True
                t, seq, kind, ns, name = self._queue[0]
                now = time.monotonic()
                if t > now + treat_delayed_as_idle:
                    return True  # only long-delay requeues remain
                heapq.heappop(self._queue)
            if t > time.monotonic():
                time.sleep(max(t - time.monotonic(), 0))
            self._reconcile_one(kind, ns, name)
        return False

    def drain_scheduled(self, horizon_s: float = 60.0, max_wall_s: float = 30.0):
        """Testing helper: fast-forward requeues due within `horizon_s` by
        collapsing their delay, then run until idle."""
        with self._cv:
            self._queue = [
                (min(t, time.monotonic()), s, k, ns, n)
                for (t, s, k, ns, n) in self._queue
                if t <= time.monotonic() + horizon_s
            ]
            heapq.heapify(self._queue)
        return self.run_until_idle(max_wall_s=max_wall_s)

    def _loop(self):
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                t, seq, kind, ns, name = self._queue[0]
                now = time.monotonic()
                if t > now:
                    self._cv.wait(timeout=min(t - now, 0.5))
                    continue
                heapq.heappop(self._queue)
            self._reconcile_one(kind, ns, name)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)

    def sync_all(self):
        """Enqueue every existing object of every registered kind (startup
        resync, like controller-runtime's initial list)."""
        for c in self.controllers:
            for obj in self.store.list(c.kind, namespace=None):
                self.enqueue(c.kind.kind, obj.metadata.namespace, obj.metadata.name)
