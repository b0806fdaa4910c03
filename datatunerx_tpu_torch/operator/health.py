"""Device health probe (the port of ``datatunerx_tpu/operator/health.py``):
don't queue training onto a broken card.

A job submitted to a wedged device burns its whole backoff budget
producing nothing. The probe runs a small matmul on the card in a
SUBPROCESS (a hung probe must not poison the operator) on an interval;
while it fails, the Finetune controller holds new submissions in Pending
instead of handing them to the backend (finetune_controller.py).

The reference probes with a JAX matmul; the port's probe is a ``torch``
matmul on ``device`` (``cuda`` unless the caller asks for the CPU).
Without a card a ``cuda`` probe reports unhealthy: it never probes the CPU
in place of the card.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from typing import Optional

PROBE_CODE = (
    "import sys, torch;"
    "d = torch.device(sys.argv[1]);"
    "ok = d.type != 'cuda' or torch.cuda.is_available();"
    "ok or sys.exit('no CUDA device is visible');"
    "x = torch.ones((256, 256), dtype=torch.float32, device=d);"
    "print(float((x @ x)[0, 0].item()))"
)


def probe_device_once(timeout_s: float = 90.0,
                      device: str = "cuda") -> Optional[str]:
    """Run one subprocess probe on ``device``; returns None when healthy,
    else the failure description."""
    try:
        p = subprocess.run([sys.executable, "-c", PROBE_CODE, str(device)],
                           timeout=timeout_s, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return f"device probe hung (> {timeout_s:.0f}s)"
    if p.returncode != 0:
        return f"device probe exited {p.returncode}: {p.stderr[-200:]}"
    if "256.0" not in p.stdout:
        return f"device probe wrong result: {p.stdout[-100:]!r}"
    return None


class DeviceHealthProbe:
    """Background prober with a sticky last-known state.

    Starts optimistic (healthy) so the first reconcile isn't blocked behind a
    cold probe; flips unhealthy as soon as a probe fails.
    """

    def __init__(self, interval_s: float = 300.0, timeout_s: float = 90.0,
                 idle_check=None, device: str = "cuda"):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.device = device
        # idle_check() -> bool: probe ONLY while no training job is running
        # (a probe against a busy card competes with the live job for its
        # memory and reads a slow answer as a failure)
        self.idle_check = idle_check
        self.healthy = True
        self.last_error: Optional[str] = None
        self.last_checked: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_now(self) -> bool:
        err = probe_device_once(self.timeout_s, self.device)
        self.last_error = err
        self.healthy = err is None
        self.last_checked = time.time()
        return self.healthy

    def start(self):
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.is_set():
                if self.idle_check is None or self.idle_check():
                    self.check_now()
                if self._stop.wait(self.interval_s):
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="device-health-probe")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
