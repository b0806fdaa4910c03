"""The readings that a cell's limits are set from: the program's compared
numbers on each seed, the control's (the reference in the next lower
precision, fp8, put in the program's place) and, for training, each
planted fault's. One process runs the seeds in turn, since set-up is
long:

    python3 dtxbench/calibrate.py --workload train.qwen1.5-7b.lora \\
        --seeds 11,12,13 --control --faults half_batch --seconds 2

One JSON line a seed and reading: ``{"seed", "kind", "numbers"}`` with
``kind`` ``program``, ``control`` or a fault's name. A state left
unchanged reads 1 on ``change_gap`` by that number's definition and needs
no run. ``--seconds`` is the window of each run (serving: long enough to
finish the mix's longest requests at the cell's load).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dtxbench.harness import env, faults, runner, spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    env.prepare()
    wl = spec.workload(args.workload)
    err = env.require_cuda(int(wl["chips"]))
    if err:
        print(f"calibrate: {err}", file=sys.stderr)
        return 3
    table = faults.TRAIN if wl["driver"] == "train" else faults.SERVE
    for seed in (int(x) for x in args.seeds.split(",")):
        res = runner.run_cell(args.workload, seed, args.seconds, False,
                              time.perf_counter(), control=args.control)
        nums = {k: v["value"] for k, v in res["compared"].items()}
        print(json.dumps({"seed": seed, "kind": "program", "numbers": nums,
                          "correct": res["correct"],
                          "timings": res["timings"]}), flush=True)
        if "control" in res:
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": res["control"]}), flush=True)
        for name in filter(None, args.faults.split(",")):
            res = runner.run_cell(args.workload, seed, args.seconds, False,
                                  time.perf_counter(), fault=table[name])
            nums = {k: v["value"] for k, v in res["compared"].items()}
            print(json.dumps({"seed": seed, "kind": name, "numbers": nums,
                              "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
