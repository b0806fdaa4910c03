"""One run of one cell: find its files, set up the device, hand the cell to
its driver, read its per-layer metrics, decide ``correct`` and make the
result line. ``run.py`` is the command; the CPU tests call ``run_cell``
with a small configuration and the CPU as the device."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types

from dtxbench.harness import env, spec


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, config=None, workload=None,
             traffic=None, fault=None, control=False) -> dict:
    """The result dict of one run (see ``run.py``). ``config``,
    ``workload`` and ``traffic`` replace the cell's files (the tests' small
    sizes); ``fault`` wraps the timed path (the tests' broken programs);
    ``control`` adds the control's numbers (``calibrate.py``)."""
    import torch

    bench = spec.benchmark()
    wl = workload or spec.workload(cell)
    e2e_defs, layer_defs = spec.cell_metrics(bench, cell)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = types.SimpleNamespace(
        cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        t_start=t_start, device=torch.device(device), workload=wl,
        config_name=wl["config"], config=config or spec.config(wl["config"]),
        traffic=traffic or spec.traffic(wl["traffic"]), fault=fault,
        control=control, kernels=spec.kernel_class)
    out = spec.driver(wl["driver"]).run(ctx)

    metrics = {}
    if trace:
        lc = out["layer_ctx"]
        for m in layer_defs:
            v = spec.metric_reader(m["name"]).read(lc)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e_defs:
            v = out["e2e"].get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    compared = {}
    ok = out.get("problem") is None and out["failed"] == 0
    for name, value, limit in out["compared"]:
        compared[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(wl["chips"]),
           "memory_peak_bytes": int(out["memory_peak"])}
    if ctx.device.type == "cuda":
        dev["power_limit_w"] = _power_limit()
    result = {"correct": bool(ok), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev, "timings": out.get("timings", {})}
    if out.get("problem"):
        result["problem"] = out["problem"]
    if "control" in out:
        result["control"] = out["control"]
    if trace:
        lc = out["layer_ctx"]
        win = lc["window"]
        dev["busy_s"] = win.busy_ns() / 1e9
        dev["window_s"] = win.seconds
        result["breakdown"] = {
            "device_ops": win.device_ops(),
            "idle_gaps": (lc.get("host") or win).idle_gaps()}
    result["compared"] = compared
    return result


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.prepare()
    try:
        wl = spec.workload(args.workload)
    except OSError as e:
        print(f"dtxbench: no workload {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    err = env.require_cuda(int(wl["chips"]))
    if err:
        print(f"dtxbench: {err}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start)
    found = env.forbidden_modules()
    if found:
        print(f"dtxbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"dtxbench: timings {json.dumps(result['timings'])}",
          file=sys.stderr)
    if "problem" in result:
        print(f"dtxbench: {result['problem']}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
