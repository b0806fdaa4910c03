"""dtxsan reporting: baseline partition, JSON contract, text rendering.

The baseline machinery is dtxlint's (`analysis/baseline.py`) verbatim —
SanFindings carry a plain ``Finding`` so ``partition`` works unchanged,
and the policy is the same: the checked-in baseline stays EMPTY; inline
``# dtxsan: disable=...`` with a reason is the only sanctioned way to
carry a finding.

Two artifact shapes:

  * the **raw report** (``write_raw``/``load_raw``) — every
    post-suppression finding with its evidence detail plus the compile
    counters; written by the pytest plugin (``DTX_SAN_REPORT=...``) so
    the ``dtx-torch san`` CLI can re-partition under its own baseline flags
    without re-running the suite;
  * the **JSON contract doc** (``build_doc``) — mirrors ``dtx lint
    --format json``: ``{"version", "findings", "baselined",
    "suppressed", "failed"}`` plus dtxsan's ``counters``/``classes``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from datatunerx_tpu_torch.analysis.baseline import load_baseline, partition
from datatunerx_tpu_torch.analysis.core import Finding
from datatunerx_tpu_torch.analysis.sanitizers.runtime import (
    REPO_ROOT,
    SanFinding,
    render,
)

JSON_SCHEMA_VERSION = 1
RAW_KIND = "dtxsan-raw"


def default_baseline_path() -> str:
    return os.path.join(REPO_ROOT, "dtxsan-torch-baseline.json")


def default_report_path() -> str:
    return os.path.join(REPO_ROOT, ".dtxsan-torch-report.json")


def evaluate(findings: Sequence[SanFinding], suppressed: int,
             baseline_path: Optional[str] = None,
             no_baseline: bool = False) -> Dict:
    """Partition findings against the baseline; ``failed`` iff anything
    NEW survives."""
    path = baseline_path or default_baseline_path()
    baseline = {} if no_baseline else load_baseline(path)
    plain = [sf.finding for sf in findings]
    new, carried = partition(plain, baseline)
    new_ids = {id(f) for f in new}
    new_sf = [sf for sf in findings if id(sf.finding) in new_ids]
    return {
        "new": new_sf,
        "baselined": len(carried),
        "suppressed": suppressed,
        "failed": bool(new_sf),
        "baseline_path": path,
    }


def build_doc(evaluation: Dict, counters: Optional[Dict[str, int]] = None,
              classes: Sequence[str] = (),
              pytest_exit: Optional[int] = None) -> Dict:
    doc = {
        "version": JSON_SCHEMA_VERSION,
        "findings": [dict(sf.finding.to_json(), detail=sf.detail)
                     for sf in evaluation["new"]],
        "baselined": evaluation["baselined"],
        "suppressed": evaluation["suppressed"],
        "failed": evaluation["failed"],
        "classes": list(classes),
        "counters": dict(counters or {}),
    }
    if pytest_exit is not None:
        doc["pytest_exit"] = pytest_exit
        doc["failed"] = doc["failed"] or pytest_exit != 0
    return doc


def render_text(evaluation: Dict, counters: Optional[Dict[str, int]] = None,
                with_detail: bool = True) -> str:
    lines: List[str] = []
    for sf in evaluation["new"]:
        lines.append(render(sf, with_detail=with_detail))
    new = len(evaluation["new"])
    summary = (f"dtxsan: {new} finding{'s' if new != 1 else ''}"
               f" ({evaluation['baselined']} baselined, "
               f"{evaluation['suppressed']} suppressed)")
    if counters:
        summary += (f"; builds: {counters.get('builds', 0)} "
                    f"({counters.get('kernel_builds', 0)} kernel library, "
                    f"{counters.get('native_builds', 0)} native, "
                    f"{counters.get('torch_compiles', 0)} torch.compile)")
    lines.append(summary)
    return "\n".join(lines)


# --------------------------------------------------------------- raw file
def write_raw(path: str, findings: Sequence[SanFinding], suppressed: int,
              counters: Optional[Dict[str, int]] = None,
              classes: Sequence[str] = ()):
    doc = {
        "version": JSON_SCHEMA_VERSION,
        "kind": RAW_KIND,
        "findings": [dict(sf.finding.to_json(), detail=sf.detail)
                     for sf in findings],
        "suppressed": suppressed,
        "counters": dict(counters or {}),
        "classes": list(classes),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_raw(path: str) -> Tuple[List[SanFinding], int, Dict[str, int],
                                 List[str]]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("kind") != RAW_KIND:
        raise ValueError(f"{path}: not a dtxsan raw report")
    findings = []
    for e in doc.get("findings", []):
        findings.append(SanFinding(
            Finding(e["rule"], e["path"], int(e.get("line", 0)),
                    int(e.get("col", 0)), e["message"],
                    e.get("severity", "error")),
            e.get("detail", "")))
    return (findings, int(doc.get("suppressed", 0)),
            dict(doc.get("counters", {})), list(doc.get("classes", [])))


__all__: Sequence[str] = (
    "JSON_SCHEMA_VERSION", "RAW_KIND", "build_doc", "default_baseline_path",
    "default_report_path", "evaluate", "load_raw", "render_text",
    "write_raw",
)
