"""Multi-process bootstrap: ``torch.distributed.init_process_group`` from
the pod environment (the port of ``datatunerx_tpu/parallel/distributed.py``).

One process drives one card. A JobSet of GPU pods, or
``operator/backends.LocalProcessBackend`` with ``num_hosts > 1``, runs one
identical trainer per card; rank 0 is the coordinator.

Env contract (set by the operator's job generator and the port's backends):
  DTX_COORDINATOR_ADDRESS  host:port of rank 0 (default port 8476)
  DTX_NUM_PROCESSES        total process count
  DTX_PROCESS_ID           this process's rank
  DTX_DIST_HEARTBEAT_S     liveness knob: a rank may stall this long (the
                           store's timeout for the rendezvous, default 100)
  DTX_DIST_SHUTDOWN_S      the collectives' timeout (default 300)

The backend is NCCL for a CUDA device and gloo for ``--device cpu``; no
other is tried. A rank takes the card the launcher gives it through
``CUDA_VISIBLE_DEVICES`` (its only visible card), else ``process_id %
device_count`` on one host. NCCL refuses two ranks on one card; that error
surfaces as it is.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

DEFAULT_PORT = 8476


def _host_port(coord: Optional[str]) -> tuple:
    """``host[:port]`` → (host, port), rank 0's store address."""
    host, sep, port = (coord or "").rpartition(":")
    if not sep:
        host, port = coord or "", ""
    return host or "127.0.0.1", int(port or DEFAULT_PORT)


def maybe_initialize_distributed(num_workers: int = 1,
                                 device="cuda") -> dict:
    """Join the process group when running as more than one process; a
    no-op otherwise. Returns {initialized, process_id, num_processes}.

    ``device`` ("cuda" or "cpu", or a torch.device) picks NCCL or gloo; on
    CUDA it also binds this process to its card."""
    import torch
    import torch.distributed as dist

    if num_workers <= 1 and "DTX_COORDINATOR_ADDRESS" not in os.environ:
        return {"initialized": False, "process_id": 0, "num_processes": 1}
    coord = os.environ.get("DTX_COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("DTX_NUM_PROCESSES", num_workers))
    pid = int(os.environ.get("DTX_PROCESS_ID", 0))
    if nproc <= 1:
        return {"initialized": False, "process_id": 0, "num_processes": 1}
    heartbeat_s = int(os.environ.get("DTX_DIST_HEARTBEAT_S", "100"))
    shutdown_s = int(os.environ.get("DTX_DIST_SHUTDOWN_S", "300"))
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "distributed training on CUDA and no CUDA device is visible; "
                "pass --device cpu to train over gloo on the CPU")
        torch.cuda.set_device(pid % count)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        host, port = _host_port(coord)
        store = dist.TCPStore(host, port, nproc, pid == 0,
                              timeout=datetime.timedelta(seconds=heartbeat_s))
        dist.init_process_group(
            backend, store=store, world_size=nproc, rank=pid,
            timeout=datetime.timedelta(seconds=shutdown_s))
    return {
        "initialized": True,
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
    }
