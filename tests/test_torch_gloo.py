"""Run a function in N gloo processes on the CPU for the port's
multi-process tests: ``World(fn, n, *args)`` spawns ``n`` processes, joins
each to a gloo process group over a free localhost port and calls ``fn(rank,
n, *args)`` there; it returns at once, so that the caller can compute its
reference while the ranks run, and ``result()`` then gives the ranks'
results in rank order (a helper module: no test is collected here).

Every process is joined with its own deadline: a straggler is killed and
the call raises, so a hung collective fails the test instead of hanging it
(pytest-timeout is not installed). ``fn`` must be importable by module
path from a fresh interpreter (spawn), and its module should not import
JAX: each child imports only torch and the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, n, port, args, queue):
    try:
        os.environ.update(DTX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                          DTX_NUM_PROCESSES=str(n),
                          DTX_PROCESS_ID=str(rank))
        import torch

        torch.set_num_threads(1)
        from datatunerx_tpu_torch.parallel.distributed import (
            maybe_initialize_distributed,
        )

        info = maybe_initialize_distributed(n, device="cpu")
        assert info["num_processes"] == n and info["process_id"] == rank
        out = fn(rank, n, *args)
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, "error", traceback.format_exc()))


class World:
    """N spawned ranks running ``fn``; ``result()`` joins them."""

    def __init__(self, fn, n: int, *args, timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        self.queue = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_child,
                                  args=(fn, r, n, port, args, self.queue),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def result(self):
        n, procs, queue = self.n, self.procs, self.queue
        results, errors = {}, []
        try:
            while len(results) + len(errors) < n:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, status, out = queue.get(timeout=min(left, 1.0))
                except Exception:  # noqa: BLE001 — queue.Empty: poll again
                    if any(p.exitcode not in (None, 0) for p in procs) \
                            and queue.empty():
                        time.sleep(0.5)
                        if queue.empty():
                            break
                    continue
                if status == "ok":
                    results[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, self.deadline
                                            - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise AssertionError("\n".join(errors))
        if len(results) < n:
            missing = sorted(set(range(n)) - set(results))
            raise AssertionError(
                f"ranks {missing} of {n} gave no result within "
                f"{self.timeout} s (exit codes "
                f"{[p.exitcode for p in procs]})")
        return [results[r] for r in range(n)]
