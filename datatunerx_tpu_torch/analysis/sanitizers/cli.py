"""``dtx-torch san`` — run pytest under the port's sanitizers and report
like dtxlint.

Wraps a pytest invocation (child process, so the wrapper's own
interpreter stays un-instrumented), collects the raw report the plugin
writes, partitions it against the dtxsan baseline, and emits the same
contract as ``dtx-torch lint``: human text or ``--format json`` with
``{"version", "findings", "baselined", "suppressed", "failed"}``; exit
0 clean / 1 findings-or-test-failure / 2 usage-or-infrastructure error.

The child loads the port's plugin with ``-p`` and gets the classes under
``DTX_TORCH_SAN``; ``DTX_SAN`` is taken out of its environment, because
the tests' conftest loads the REFERENCE's plugin whenever DTX_SAN is set
and two planes must not both wrap ``threading.Lock``.

    dtx-torch san                         # the port's tests, all sanitizers
    dtx-torch san --san lock,thread -- tests/test_torch_loadgen.py -q
    dtx-torch san --module-budget datatunerx_tpu_torch/serving=0 -- tests/
    dtx-torch san --from-report .dtxsan-torch-report.json --format json

``--write-baseline`` snapshots current findings into the baseline file —
policy here keeps that file EMPTY (fix or inline-annotate instead), but
the mechanism matches dtxlint's for rule rollouts.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import List, Optional

from datatunerx_tpu_torch.analysis.baseline import save_baseline
from datatunerx_tpu_torch.analysis.sanitizers import report
from datatunerx_tpu_torch.analysis.sanitizers.plugin import ENV_KEY

PLUGIN = "datatunerx_tpu_torch.analysis.sanitizers.plugin"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtx-torch san",
        description="Run pytest under the dtxsan runtime sanitizers "
                    "(SAN001 lock-order, SAN002 thread-leak, SAN003 "
                    "compile-budget).")
    p.add_argument("--san", default="1", metavar="CLASSES",
                   help="sanitizer classes: 1/all or a comma list of "
                        "lock,thread,compile (default: all)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline path (default: dtxsan-torch-baseline.json at "
                        "the repo root)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline entirely")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline and exit 0")
    p.add_argument("--report", default=None, metavar="FILE",
                   help="where the raw report is written "
                        "(default: .dtxsan-torch-report.json at the repo "
                        "root)")
    p.add_argument("--from-report", default=None, metavar="FILE",
                   help="skip the pytest run; evaluate an existing raw "
                        "report")
    p.add_argument("--module-budget", action="append", default=[],
                   metavar="PATH=N",
                   help="module compile budget (repeatable); requires the "
                        "compile sanitizer")
    p.add_argument("--no-detail", action="store_true",
                   help="omit evidence stacks from text output")
    p.add_argument("pytest_args", nargs=argparse.REMAINDER,
                   help="arguments after -- go to pytest verbatim "
                        "(default: the port's tests/test_torch_*.py -q)")
    return p


def _run_pytest(args, report_path: str) -> int:
    pytest_args = [a for a in args.pytest_args if a != "--"]
    if not pytest_args:
        pytest_args = sorted(glob.glob(os.path.join(
            report.REPO_ROOT, "tests", "test_torch_*.py"))) + ["-q"]
    env = dict(os.environ)
    env.pop("DTX_SAN", None)  # conftest would load the reference's plugin
    env[ENV_KEY] = args.san
    env["DTX_SAN_REPORT"] = report_path
    if args.baseline:
        env["DTX_SAN_BASELINE"] = args.baseline
    if args.no_baseline:
        env["DTX_SAN_NO_BASELINE"] = "1"
    budgets = [b for b in args.module_budget if "=" in b]
    if budgets:
        env["DTX_SAN_MODULE_BUDGETS"] = ",".join(budgets)
    cmd = [sys.executable, "-m", "pytest", "-p", PLUGIN] + pytest_args
    return subprocess.call(cmd, env=env)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    for b in args.module_budget:
        if "=" not in b or not b.split("=", 1)[1].strip().lstrip("-").isdigit():
            print(f"dtx-torch san: bad --module-budget {b!r} (want PATH=N)",
                  file=sys.stderr)
            return 2

    report_path = args.report or report.default_report_path()
    pytest_exit: Optional[int] = None
    if args.from_report:
        report_path = args.from_report
    else:
        pytest_exit = _run_pytest(args, report_path)
    try:
        findings, suppressed, counters, classes = report.load_raw(
            report_path)
    except (OSError, ValueError, KeyError) as e:
        print(f"dtx-torch san: cannot read report {report_path}: {e}",
              file=sys.stderr)
        return 2

    if args.write_baseline:
        path = args.baseline or report.default_baseline_path()
        save_baseline(path, [sf.finding for sf in findings])
        print(f"dtx-torch san: wrote {len(findings)} finding(s) to {path}")
        return 0

    evaluation = report.evaluate(findings, suppressed,
                                 baseline_path=args.baseline,
                                 no_baseline=args.no_baseline)
    doc = report.build_doc(evaluation, counters, classes,
                           pytest_exit=pytest_exit)
    if args.format == "json":
        print(json.dumps(doc, indent=1))
    else:
        print(report.render_text(evaluation, counters,
                                 with_detail=not args.no_detail))
        if pytest_exit not in (None, 0):
            print(f"dtx-torch san: pytest exited {pytest_exit}")
    return 1 if doc["failed"] else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
