"""Baseline handling: carry pre-existing findings so CI only blocks NEW debt.

The baseline is a checked-in JSON file of finding keys (rule, path,
message — deliberately line-number-free, so edits above a carried finding
don't invalidate it). ``partition`` matches multiset-style: two identical
findings need two baseline entries, so fixing one of a pair still
surfaces the other.

The port's policy: its baseline (``dtxlint-torch-baseline.json``) carries
only DTX001 host syncs in hot paths, each listed as performance debt in
ROADMAP.md; every other finding is fixed or inline-suppressed with a
reason.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Counter, List, Sequence, Tuple

from datatunerx_tpu_torch.analysis.core import Finding

Key = Tuple[str, str, str]


def load_baseline(path: str) -> Counter:
    """Counter of carried finding keys; missing file → empty."""
    if not path or not os.path.isfile(path):
        return collections.Counter()
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    keys: Counter = collections.Counter()
    for entry in doc.get("findings", []):
        keys[(entry["rule"], entry["path"], entry["message"])] += 1
    return keys


def save_baseline(path: str, findings: Sequence[Finding]):
    doc = {
        "comment": "dtxlint baseline — regenerate with `dtxlint-torch --write-baseline`",
        "findings": [
            {"rule": f.rule, "path": f.path.replace(os.sep, "/"),
             "message": f.message}
            for f in sorted(findings, key=lambda f: f.key())
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def partition(findings: Sequence[Finding],
              baseline: Counter) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, baselined)."""
    budget = collections.Counter(baseline)
    new: List[Finding] = []
    carried: List[Finding] = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            carried.append(f)
        else:
            new.append(f)
    return new, carried
