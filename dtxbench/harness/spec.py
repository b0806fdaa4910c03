"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root,
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json``, ``kernels/<class>.json``, ``drivers/<driver>.py``
and ``metrics/<metric>.py``. A new cell, configuration, traffic mix,
kernel class or per-layer metric is a new file and a new entry; nothing
here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from dtxbench.harness.env import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _load(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _load(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _load(BENCH / "traffic" / f"{name}.json")


def kernel_class(name: str) -> list:
    """The kernel-name substrings that count as one class of work."""
    return list(_load(BENCH / "kernels" / f"{name}.json")["match"])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH / "drivers" / f"{name}.py",
                   f"dtxbench_driver_{name}")


def metric_reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py",
                   "dtxbench_metric_" + re.sub(r"\W", "_", name))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that this cell reports."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
