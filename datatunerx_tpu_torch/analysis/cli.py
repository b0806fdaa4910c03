"""dtxlint command line for the port: ``dtxlint-torch``, ``dtx-torch
lint``, ``python -m datatunerx_tpu_torch.analysis``.

Exit codes: 0 = clean (or everything suppressed/baselined), 1 = new
findings (or, with ``--fix --check``, fixes that would change files),
2 = usage error. ``--format json`` emits one machine-readable object
(schema ``version`` 2) for CI annotation tooling; ``--write-baseline``
records the current findings as accepted debt instead of failing.

By default linting is PROGRAM-LEVEL: the cross-module call graph over
the linted package lets DTX001/DTX007/DTX009 follow calls across files,
with per-module summaries cached on mtime+size (``--no-program`` /
``--no-cache`` opt out). ``--changed`` restricts to files differing
from git HEAD for cheap pre-commit runs; ``--fix`` applies the
mechanical autofixes (DTX002 hoist-compile-out-of-loop, DTX004
``prng.split`` insertion, DTX008 default-argument deferral) and ``--fix --check`` is the CI idempotency
gate — it fails if a fix is still applicable, without writing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import List, Optional

from datatunerx_tpu_torch.analysis import baseline as baseline_mod
from datatunerx_tpu_torch.analysis.config import LintConfig, load_config
from datatunerx_tpu_torch.analysis.core import LintResult, lint_paths
from datatunerx_tpu_torch.analysis.rules import RULE_CLASSES, all_rules, rules_by_id

_SEVERITY_RANK = {"warning": 0, "error": 1}
JSON_SCHEMA_VERSION = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtxlint-torch",
        description="static analysis for the PyTorch/CUDA port "
                    "(host-sync, recompile, sharding, lock-discipline, "
                    "graph-replay rules; program-level cross-module graph)")
    p.add_argument("paths", nargs="*", default=["datatunerx_tpu_torch"],
                   help="files/directories to lint "
                        "(default: datatunerx_tpu_torch)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: one object with schema `version`, findings, "
                        "and counts")
    p.add_argument("--select", default="",
                   help="comma list of rule ids to run (default: all)")
    p.add_argument("--baseline", default="",
                   help="baseline file (default: the config's baseline)")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current findings as accepted debt and exit 0")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline file (report everything)")
    p.add_argument("--no-config", action="store_true",
                   help="skip dtxlint-torch.toml discovery")
    p.add_argument("--fail-on", choices=["warning", "error"],
                   default="warning",
                   help="minimum severity that fails the run "
                        "(default: warning — everything gates)")
    p.add_argument("--no-program", action="store_true",
                   help="per-module rules only: skip the cross-module "
                        "program pass (DTX001/DTX007/DTX009 stop at file "
                        "boundaries)")
    p.add_argument("--no-cache", action="store_true",
                   help="ignore and don't write the module-summary cache "
                        "(the config's cache, keyed on file mtime+size)")
    p.add_argument("--changed", action="store_true",
                   help="lint only files differing from git HEAD "
                        "(`git diff --name-only HEAD`) — cheap pre-commit "
                        "mode; the program graph covers just those files")
    p.add_argument("--fix", action="store_true",
                   help="apply automatic fixes for the mechanical rules "
                        "(DTX002 hoist-compile-out-of-loop, DTX004 "
                        "prng.split insertion, DTX008 default-argument "
                        "deferral), re-lint to verify, then report what "
                        "remains")
    p.add_argument("--check", action="store_true",
                   help="with --fix: write nothing, exit 1 if any fix "
                        "would be applied (CI idempotency gate)")
    p.add_argument("--list-rules", action="store_true")
    return p


def _list_rules() -> int:
    for cls in RULE_CLASSES:
        doc = (cls.__module__ and sys.modules[cls.__module__].__doc__) or ""
        first = next((ln.strip() for ln in doc.splitlines() if cls.id in ln),
                     "")
        print(f"{cls.id}  {cls.name:28s} [{cls.severity}] {first}")
    return 0


def _changed_paths(paths: List[str], config: LintConfig) -> Optional[List[str]]:
    """Intersect the requested paths with files differing from HEAD.
    None → git failed (caller reports usage error); [] → nothing to lint."""
    start = config.root or os.getcwd()
    try:
        # git prints paths relative to the TOPLEVEL, not the cwd or the
        # config root — resolve against it or every join misses
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=start, capture_output=True, text=True, timeout=30)
        if top.returncode != 0 or not top.stdout.strip():
            return None
        root = top.stdout.strip()
        out = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=30)
        # diff-vs-HEAD omits brand-new files — the MOST common pre-commit
        # case; untracked (non-ignored) files count as changed too
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or untracked.returncode != 0:
        return None
    changed = [os.path.join(root, ln.strip())
               for ln in (out.stdout.splitlines()
                          + untracked.stdout.splitlines())
               if ln.strip().endswith(".py")]
    wanted = [os.path.abspath(p) for p in paths]
    keep = []
    for c in changed:
        ac = os.path.abspath(c)
        if not os.path.isfile(ac):
            continue  # deleted in the working tree
        if any(ac == w or ac.startswith(w + os.sep) for w in wanted):
            keep.append(ac)
    return keep


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()
    if args.check and not args.fix:
        print("dtxlint: --check requires --fix", file=sys.stderr)
        return 2

    if args.no_config:
        config = LintConfig()
    else:
        config = load_config(start=args.paths[0] if args.paths else ".")
    if args.no_cache:
        config = dataclasses.replace(config, cache="")
    if args.no_program:
        config = dataclasses.replace(config, program=False)
    if args.select:
        wanted = [r.strip() for r in args.select.split(",") if r.strip()]
        known = {cls.id for cls in RULE_CLASSES}
        unknown = sorted(set(wanted) - known)
        if unknown:
            # a typo must not turn the gate green by selecting zero rules
            print(f"dtxlint: unknown rule id(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
        rules = rules_by_id(wanted)
    else:
        rules = all_rules()

    paths = list(args.paths)
    if args.changed:
        changed = _changed_paths(paths, config)
        if changed is None:
            print("dtxlint: --changed requires a git checkout with a HEAD "
                  "commit", file=sys.stderr)
            return 2
        if not changed:
            if args.format == "json":
                # the documented stdout contract holds on every exit path
                print(json.dumps({"version": JSON_SCHEMA_VERSION,
                                  "findings": [], "baselined": 0,
                                  "suppressed": 0, "files": 0,
                                  "failed": False}, indent=1))
            else:
                print("dtxlint: no changed python files under the given "
                      "paths")
            return 0
        paths = changed

    fix_summary = None
    if args.fix:
        from datatunerx_tpu_torch.analysis.fix import FIXABLE_RULES, fix_paths

        fixable = [r.id for r in rules if r.id in FIXABLE_RULES]
        outcomes = fix_paths(paths, config=config, rule_ids=fixable,
                             write=not args.check)
        changed_files = [o for o in outcomes if o.changed]
        fix_summary = {
            "fixed": sum(o.applied for o in changed_files),
            "files_changed": len(changed_files),
            "unfixable": sum(o.unfixable for o in outcomes),
        }
        if args.check:
            if args.format == "json":
                print(json.dumps({"version": JSON_SCHEMA_VERSION,
                                  "fix": fix_summary,
                                  "would_change": [o.path
                                                   for o in changed_files],
                                  "failed": bool(changed_files)}, indent=1))
            elif changed_files:
                for o in changed_files:
                    print(f"{o.path}: {o.applied} fix(es) would be applied "
                          "— run `dtxlint-torch --fix`")
            else:
                print("dtxlint: --fix --check clean (no applicable fixes)")
            return 1 if changed_files else 0

    stats = None
    if config.program:
        from datatunerx_tpu_torch.analysis.program import lint_program

        result, stats = lint_program(paths, config=config, rules=rules)
    else:
        result = lint_paths(paths, config=config, rules=rules)

    baseline_path = args.baseline or config.resolve(config.baseline)
    if args.write_baseline:
        baseline_mod.save_baseline(baseline_path, result.findings)
        print(f"dtxlint: wrote {len(result.findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    carried = (baseline_mod.load_baseline(baseline_path)
               if not args.no_baseline else baseline_mod.load_baseline(""))
    new, baselined = baseline_mod.partition(result.findings, carried)
    gate = [f for f in new
            if _SEVERITY_RANK.get(f.severity, 1)
            >= _SEVERITY_RANK[args.fail_on]]

    if args.format == "json":
        doc = {
            "version": JSON_SCHEMA_VERSION,
            "findings": [f.to_json() for f in new],
            "baselined": len(baselined),
            "suppressed": result.suppressed,
            "files": result.files,
            "failed": bool(gate),
        }
        if stats is not None:
            doc["cache"] = {"analyzed": stats.analyzed,
                            "reused": stats.reused}
        if fix_summary is not None:
            doc["fix"] = fix_summary
        print(json.dumps(doc, indent=1))
    else:
        for f in new:
            print(f.render())
        summary = (f"dtxlint: {len(new)} finding(s) in {result.files} "
                   f"file(s)")
        extras = []
        if result.suppressed:
            extras.append(f"{result.suppressed} suppressed inline")
        if baselined:
            extras.append(f"{len(baselined)} baselined")
        if stats is not None and stats.reused:
            extras.append(f"{stats.reused} module(s) from cache")
        if fix_summary is not None:
            extras.append(f"{fix_summary['fixed']} auto-fixed")
        if extras:
            summary += " (" + ", ".join(extras) + ")"
        print(summary)
    return 1 if gate else 0


if __name__ == "__main__":
    sys.exit(main())
