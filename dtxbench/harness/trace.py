"""``torch.profiler`` windows and what the benchmark reads from them.

A traced run profiles twice, after its measured window. The device window
(``start(host=False)``) records the CUDA kernels, copies and memsets
alone: it costs the host almost nothing, so its idle share and kernel
times are those of an untraced run. The host window (``start(host=True)``)
also records the CPU operations and ranges of every thread (the serving
engine's ranges run on its scheduler thread), which the launches, the
ranges' own readings and the naming of idle gaps need; it slows the host.
Both are read in memory from Kineto's events: nothing is written to disk.
A window's bounds are host stamps (``now``) on Kineto's clock, which is
the Unix epoch in nanoseconds for host and device events alike.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

NAMED_GAPS = 5000  # idle gaps named one by one; the rest are summed


def start(host: bool):
    """A started profiler: the device window, or with ``host`` the host
    window. Without a card both record the CPU (the tests' runs)."""
    kw = {}
    if host or not torch.cuda.is_available():
        acts = [ProfilerActivity.CPU]
        try:
            kw["experimental_config"] = (
                torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
        except (AttributeError, TypeError):
            pass
    else:
        acts = []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, **kw)
    prof.start()
    return prof


def now() -> int:
    """A window bound: the host's clock as Kineto stamps its events."""
    return time.time_ns()


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


class Window:
    """The events of one stopped profiler between two bounds (``now``
    stamps), split into device activity, launches (runtime calls) and
    ranges (user annotations)."""

    def __init__(self, prof, t0: int, t1: int):
        self.t0, self.t1 = int(t0), int(t1)
        events = prof.profiler.kineto_results.events()
        self.device = []  # (start_ns, end_ns, name, correlation)
        self.launch = {}  # correlation -> (start_ns, thread)
        self.ranges = collections.defaultdict(list)  # name -> [(s, e, tid)]
        self.cpu = collections.defaultdict(list)  # tid -> [(s, e, name)]
        for e in events:
            s = e.start_ns()
            end = s + e.duration_ns()
            if _is_device(e):
                if e.is_user_annotation() or e.name().startswith("dtx_"):
                    continue  # a range's shadow on the device's timeline
                self.device.append((s, end, e.name(), e.correlation_id(),
                                    e.linked_correlation_id()))
                continue
            tid = e.start_thread_id()
            if e.is_user_annotation():
                self.ranges[e.name()].append((s, end, tid))
            elif e.name().startswith(("cuda", "cu")):
                self.launch[e.correlation_id()] = (s, tid)
            else:
                self.cpu[tid].append((s, end, e.name()))
        self.device.sort()
        for v in self.ranges.values():
            v.sort()
        for v in self.cpu.values():
            v.sort()
        self.kernels = [d for d in self.device if not _is_copy(d[2])]

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def launched_at(self, dev):
        """(host start, thread) of the runtime call that launched a device
        event, or None."""
        for c in (dev[3], dev[4]):
            if c in self.launch:
                return self.launch[c]
        return None

    def busy_ns(self) -> int:
        """The union of device activity inside the window."""
        t0, t1 = self.t0, self.t1
        busy, cur_s, cur_e = 0, None, None
        for s, e, *_ in self.device:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def kernel_ns(self, patterns) -> int:
        """Device time inside the window of the kernels whose name holds
        one of ``patterns``."""
        t0, t1 = self.t0, self.t1
        tot = 0
        for s, e, name, *_ in self.kernels:
            if any(p in name for p in patterns):
                tot += max(0, min(e, t1) - max(s, t0))
        return tot

    def under_range(self, range_name: str):
        """For each ``range_name`` range inside the window: the device
        events its host thread launched while in it, as a list per
        range."""
        rs = [r for r in self.ranges.get(range_name, [])
              if r[0] >= self.t0 and r[1] <= self.t1]
        starts = [r[0] for r in rs]
        out = [[] for _ in rs]
        for dev in self.kernels:
            at = self.launched_at(dev)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at[0]) - 1
            if i >= 0 and at[0] <= rs[i][1] and at[1] == rs[i][2]:
                out[i].append(dev)
        return out

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by = collections.Counter()
        for s, e, name, *_ in self.device:
            d = min(e, self.t1) - max(s, self.t0)
            if d > 0:
                by[_short(name)] += d
        return [[n, v / 1e9] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps, summed by what the host's busiest thread
        was doing then: [[name, seconds]]."""
        t0, t1 = self.t0, self.t1
        gaps = []
        last = t0
        for s, e, *_ in self.device:
            if e <= t0 or s >= t1:
                continue
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if last < t1:
            gaps.append((last, t1))
        main = max(self.cpu, key=lambda t: len(self.cpu[t]), default=None)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = collections.Counter()
        for k, (g0, g1) in enumerate(gaps):
            who = (self._host_doing(main, (g0 + g1) // 2) if k < NAMED_GAPS
                   else f"gaps after the longest {NAMED_GAPS}")
            named[who] += g1 - g0
        return [[n, v / 1e9] for n, v in named.most_common(top)]

    def _host_doing(self, tid, t: int) -> str:
        for name, rs in self.ranges.items():
            i = bisect.bisect_right(rs, (t, float("inf"), 0)) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1]:
                return name
        ops = self.cpu.get(tid, [])
        i = bisect.bisect_right(ops, (t, float("inf"), "")) - 1
        for s, e, name in ops[max(0, i - 200):i + 1][::-1]:
            if s <= t <= e:
                return name
        return "host: Python between traced ops"


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    signature."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].split("<")[0].strip()
    return (base or name)[:80]
