"""On the card, at each cell's own size: the control (the reference in
fp8 put in the program's place) fails the cell's limits while the program
passes them, on three seeds. Run on the H100:

    python -m pytest --noconftest -m cuda -s \
        dtxbench/tests/test_bench_controls.py
"""

import json
import time

import pytest

from dtxbench.harness import runner, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size")
    limits = spec.workload(cell)["limits"]
    seconds = 2.0 if cell.startswith("train") else 20.0
    for seed in SEEDS:
        res = runner.run_cell(cell, seed, seconds, False, time.perf_counter(),
                              control=True)
        assert res["correct"], res["compared"]
        ctl = res["control"]
        print(json.dumps({"cell": cell, "seed": seed, "program": {
            k: v["value"] for k, v in res["compared"].items()},
            "control": ctl}))
        assert any(ctl[k] > limits[k] for k in limits), ctl
