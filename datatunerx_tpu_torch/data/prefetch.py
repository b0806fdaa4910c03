"""Pipelined training input path (the port of
``datatunerx_tpu/data/prefetch.py``).

  ReadAheadIterator — a reader thread pulls raw records into a bounded
                     queue while the consumer encodes them (the streaming
                     path's fetch half); order is kept, source errors
                     re-raise at the consumer, and ``close()`` stops it.
  HostPrefetcher   — runs a batch iterator in a background thread behind a
                     bounded queue (backpressure, exception propagation,
                     clean shutdown, ``resize`` live), so step N's host
                     build overlaps step N-1's compute.
  prefetch_batches — adds the device half: each host batch is copied into
                     pinned memory and sent to the device with
                     ``non_blocking`` copies up to ``depth`` batches ahead,
                     so the transfer overlaps the running step.
  MetricsBuffer    — holds per-step device metrics and resolves them one
                     logging interval late; a CUDA event recorded at push
                     time says when an entry is ready, so logging never
                     drains the stream.

``PipelineStats`` aggregates pipeline health (host build, device copy and
step wait in ms, queue depth) into the logged records under the reference's
``pipe_*`` names. The pipeline changes when work happens, never what the
batches hold or their order.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

_ITEM, _ERROR, _DONE = 0, 1, 2


class PipelineStats:
    """Thread-safe accumulators (the last ``maxlen`` samples per key);
    ``snapshot()`` returns the means since the previous snapshot, prefixed
    ``pipe_``."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._maxlen = maxlen
        self._acc: Dict[str, collections.deque] = {}

    def record(self, key: str, value: float):
        with self._lock:
            dq = self._acc.get(key)
            if dq is None:
                dq = self._acc[key] = collections.deque(maxlen=self._maxlen)
            dq.append(float(value))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {f"pipe_{k}": sum(v) / len(v)
                   for k, v in self._acc.items() if v}
            self._acc.clear()
        return out


class ReadAheadIterator:
    """Bounded background read-ahead over a record iterable: one reader
    thread and a FIFO queue, so the records (and the batches built from
    them) come in the synchronous order. A source exception re-raises where
    its record would have arrived; ``close()`` (or an early exit of the
    consumer's generator) stops the reader even when the queue is full."""

    _DONE = object()

    def __init__(self, records: Iterable, depth: int = 64):
        if depth < 1:
            raise ValueError(f"read-ahead depth must be >= 1, got {depth}")
        self._records = records
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="dtx-readahead")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for rec in self._records:
                if not self._put(rec):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._exc = e
        self._put(self._DONE)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration
                continue
            if item is self._DONE:
                if self._exc is not None:
                    raise self._exc
                raise StopIteration
            return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HostPrefetcher:
    """Runs a batch iterator (or a zero-arg callable returning one) in a
    daemon thread behind a queue of ``depth`` batches. A worker exception
    re-raises in the consumer where the failed batch would have arrived;
    ``close()`` stops the worker even when it is blocked on a full queue."""

    def __init__(self, source: Iterable | Callable[[], Iterator],
                 depth: int = 2, stats: Optional[PipelineStats] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stats = stats
        self._finished = False
        self._thread = threading.Thread(target=self._worker,
                                        name="dtx-host-prefetch", daemon=True)
        self._thread.start()

    def resize(self, depth: int) -> int:
        """Grow (or shrink) the bounded queue live — the in-run half of the
        training logger's prefetch advisory. A worker blocked on put() is
        woken at once; shrinking drops no batch, the queue just stops
        refilling until it drains below the new bound."""
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        with self._q.mutex:
            self._q.maxsize = depth
            self._q.not_full.notify_all()
        return depth

    def _put(self, item) -> bool:
        """Queue-put that stays responsive to close(); False = stopping."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            src = self._source() if callable(self._source) else self._source
            it = iter(src)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                if self._stats is not None:
                    self._stats.record("host_build_ms",
                                       (time.perf_counter() - t0) * 1e3)
                    self._stats.record("queue_depth", self._q.qsize())
                if not self._put((_ITEM, item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._put((_ERROR, e))
            return
        self._put((_DONE, None))

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                kind, payload = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                continue
        if self._stats is not None:
            self._stats.record("step_wait_ms",
                               (time.perf_counter() - t0) * 1e3)
        if kind != _ITEM:
            self._finished = True
            self._thread.join(timeout=5)
            if kind == _ERROR:
                raise payload
            raise StopIteration
        return payload

    def close(self):
        """Stop the worker and drop buffered batches. Idempotent."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=1.0)
        self._finished = True


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Batch of numpy arrays (or tensors) → tensors on ``device``: host
    arrays go through pinned copies with ``non_blocking`` transfers on CUDA
    (the copy overlaps the running step); tensors already there pass
    through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class _DevicePrefetcher:
    """Keeps up to ``depth`` device batches in flight ahead of the step."""

    def __init__(self, host_batches: Iterable, device: torch.device,
                 depth: int, stats: Optional[PipelineStats]):
        self._it = iter(host_batches)
        self._device = device
        self._buf: collections.deque = collections.deque()
        self._depth = depth
        self._stats = stats
        self._exhausted = False

    def _fill(self):
        while not self._exhausted and len(self._buf) < self._depth:
            try:
                hb = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            t0 = time.perf_counter()
            placed = to_device(hb, self._device)
            if self._stats is not None:
                self._stats.record("device_put_ms",
                                   (time.perf_counter() - t0) * 1e3)
            self._buf.append(placed)

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        return self._buf.popleft()


def prefetch_batches(
    source: Iterable | Callable[[], Iterator],
    device: Optional[torch.device] = None,
    depth: int = 2,
    stats: Optional[PipelineStats] = None,
) -> Tuple[Iterator, HostPrefetcher]:
    """The full pipeline over one epoch's batches: ``(iterator,
    host_prefetcher)``. Iterate the first; close the second when leaving
    the epoch early so the worker thread never outlives the loop."""
    host = HostPrefetcher(source, depth=depth, stats=stats)
    if device is None:
        return host, host
    return _DevicePrefetcher(host, torch.device(device), depth, stats), host


class MetricsBuffer:
    """Holds in-flight step metrics; resolves only completed ones.

    ``push`` stores the device tensors and, on CUDA, records an event on
    the current stream. ``pop_ready`` resolves every entry but the newest
    ``lag`` — by the next logging boundary those steps are long done — plus
    any newer entry whose event has completed. ``drain`` resolves all."""

    def __init__(self, lag: int = 1):
        self.lag = max(0, lag)
        self._pending: collections.deque = collections.deque()

    def push(self, step: int, metrics: Dict[str, Any],
             extra: Optional[Dict[str, float]] = None):
        event = None
        if any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in metrics.values()):
            event = torch.cuda.Event()
            event.record()
        self._pending.append((step, metrics, extra or {}, event))

    @staticmethod
    def _resolve(step, metrics, extra, event) -> Tuple[int, Dict[str, float]]:
        host = {k: float(v) for k, v in metrics.items()}
        host.update(extra)
        return step, host

    def pop_ready(self) -> List[Tuple[int, Dict[str, float]]]:
        out = []
        while len(self._pending) > self.lag:
            out.append(self._resolve(*self._pending.popleft()))
        while self._pending and (self._pending[0][3] is None
                                 or self._pending[0][3].query()):
            out.append(self._resolve(*self._pending.popleft()))
        return out

    def drain(self) -> List[Tuple[int, Dict[str, float]]]:
        out = [self._resolve(*entry) for entry in self._pending]
        self._pending.clear()
        return out
