"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 dtxbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``compared`` comes last, each compared number beside its limit, as the
last lines of standard error do. Exits non-zero, printing no result,
without the GPUs the cell asks for, or if a JAX module was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dtxbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
