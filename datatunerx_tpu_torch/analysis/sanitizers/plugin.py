"""pytest glue for the port's dtxsan — loaded with ``-p
datatunerx_tpu_torch.analysis.sanitizers.plugin`` (``dtx-torch san`` does
so), and active only when ``DTX_TORCH_SAN`` names sanitizer classes.

The key is not the reference's ``DTX_SAN``: the tests' conftest loads the
reference's plugin whenever DTX_SAN is set, and two sanitizer planes in
one process would both wrap ``threading.Lock``.

What it does:

  * ``pytest_configure`` installs the sanitizers DTX_TORCH_SAN names and
    registers module compile budgets from
    ``DTX_SAN_MODULE_BUDGETS=path/substr=N,...``;
  * an autouse fixture snapshots live threads per test and runs the
    thread-leak audit at teardown — a leak FAILS that test, naming the
    spawn site (the audit fixture is function-scoped and autouse, so it
    finalizes after the test's own fixtures have cleaned up);
  * ``pytest_sessionfinish`` runs the end-of-run scans (lock-order
    cycles, module budgets), partitions against the dtxsan baseline
    (``DTX_SAN_BASELINE`` overrides the default path,
    ``DTX_SAN_NO_BASELINE=1`` ignores it), writes the raw report when
    ``DTX_SAN_REPORT`` names a path (for ``dtx-torch san``), prints every new
    finding with its evidence, and forces a non-zero exit when anything
    new survived — a green suite with a pending deadlock is the failure
    mode this plugin exists to prevent.
"""

from __future__ import annotations

import os
import threading

import pytest

from datatunerx_tpu_torch.analysis.sanitizers import report, runtime

#: the environment key this plugin reads (conftest reads DTX_SAN)
ENV_KEY = "DTX_TORCH_SAN"


def _parse_module_budgets(spec: str):
    out = []
    for tok in (spec or "").split(","):
        path, _, n = tok.partition("=")
        path = path.strip()
        n = n.strip()
        if path and n.lstrip("-").isdigit():
            out.append((path, int(n)))
    return out


def pytest_configure(config):
    classes = runtime.install_from_env(os.environ.get(ENV_KEY, ""))
    config._dtxsan_classes = classes
    if "compile" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import (
            register_module_budget,
        )

        for path, n in _parse_module_budgets(
                os.environ.get("DTX_SAN_MODULE_BUDGETS", "")):
            register_module_budget(path, n)


@pytest.fixture(autouse=True)
def _dtxsan_thread_audit(request):
    from datatunerx_tpu_torch.analysis.sanitizers.threads import THREAD_SANITIZER

    if not THREAD_SANITIZER.installed:
        yield
        return
    before = set(threading.enumerate())
    yield
    leaks = THREAD_SANITIZER.audit(before, runtime.COLLECTOR,
                                   testid=request.node.nodeid)
    if leaks:
        pytest.fail("dtxsan thread-leak: "
                    + "; ".join(f.message for f in leaks), pytrace=False)


def pytest_sessionfinish(session, exitstatus):
    classes = runtime.active_classes()
    if not classes:
        return
    findings = runtime.finalize()
    suppressed = runtime.COLLECTOR.snapshot()[1]
    counters = {}
    if "compile" in classes:
        from datatunerx_tpu_torch.analysis.sanitizers.compile import (
            COMPILE_SANITIZER,
        )

        counters = COMPILE_SANITIZER.counts()
    report_path = os.environ.get("DTX_SAN_REPORT", "")
    if report_path:
        report.write_raw(report_path, findings, suppressed, counters,
                         classes)
    evaluation = report.evaluate(
        findings, suppressed,
        baseline_path=os.environ.get("DTX_SAN_BASELINE") or None,
        no_baseline=os.environ.get("DTX_SAN_NO_BASELINE", "") == "1")
    text = report.render_text(evaluation, counters)
    tr = session.config.pluginmanager.get_plugin("terminalreporter")
    if tr is not None:
        tr.ensure_newline()
        tr.section("dtxsan", sep="=")
        tr.line(text)
    else:  # pragma: no cover - terminalreporter always present in practice
        print(text)
    if evaluation["failed"] and session.exitstatus == 0:
        session.exitstatus = 1
