"""photonlint CLI (the port's; the JAX package's CLI over this package).

    python -m photon_ml_tpu_torch.analysis.lint photon_ml_tpu_torch/
    python -m photon_ml_tpu_torch.analysis.lint --json path/ > findings.json
    python -m photon_ml_tpu_torch.analysis.lint --write-baseline photon_ml_tpu_torch/
    python -m photon_ml_tpu_torch.analysis.lint --select PH01          # prefix
    python -m photon_ml_tpu_torch.analysis.lint --select PH010-PH013   # range
    python -m photon_ml_tpu_torch.analysis.lint --diff                 # vs HEAD
    python -m photon_ml_tpu_torch.analysis.lint --diff origin/main

Exit status: 0 = no findings beyond the committed baseline, 1 = new
findings (CI-gateable), 2 = usage error.  `--json` emits a machine-
readable report (findings + counts + baseline accounting; PH010–PH013
findings carry their `evidence` chain — guard-inference source, witness
call paths for inversions) for CI annotation tooling.  The default
baseline is the committed `photon_ml_tpu_torch/analysis/baseline.json`;
`--no-baseline` reports everything (how `--write-baseline` decides what
to grandfather).

`--diff [REF]` is the fast pre-commit mode: the WHOLE package is still
analyzed (the concurrency pass is interprocedural — a lock-order edge
can span files you did not touch), but only findings anchored in files
changed vs the git ref (default `HEAD`; staged, unstaged, and untracked
files all count) are reported.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence, Set

from photon_ml_tpu_torch.analysis.engine import PACKAGE, Baseline, lint_paths

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"python -m {PACKAGE}.analysis.lint",
        description="photonlint: static enforcement of the hot-path "
                    "invariants (sync points, retrace hazards, donation "
                    "safety, fault sites, durable writes)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: the "
                        f"{PACKAGE} package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a JSON report instead of human output")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline file of grandfathered findings "
                        f"(default: {os.path.relpath(DEFAULT_BASELINE)})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to --baseline and "
                        "exit 0 (grandfathering workflow)")
    p.add_argument("--select", default=None, metavar="PH001,PH01,PH010-PH013",
                   help="comma-separated rule selectors: exact ids, "
                        "prefixes (PH01 = PH010..PH013), or inclusive "
                        "ranges (PH010-PH013); default: all rules")
    p.add_argument("--diff", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="report only findings in files changed vs the "
                        "git ref (default HEAD when given bare); the "
                        "whole tree is still analyzed so interprocedural "
                        "rules see every edge")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _git_changed_files(ref: str, paths: Sequence[str]) -> Set[str]:
    """Absolute paths of .py files changed vs `ref` (committed diff +
    working tree + untracked), resolved from the repo containing the
    first lint path.  Raises RuntimeError when git cannot answer."""
    anchor = os.path.abspath(paths[0])
    if not os.path.isdir(anchor):
        anchor = os.path.dirname(anchor)

    def run(*args: str) -> str:
        proc = subprocess.run(["git", "-C", anchor, *args],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git {' '.join(args)} failed: "
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        return proc.stdout

    top = run("rev-parse", "--show-toplevel").strip()
    names = set(run("diff", "--name-only", ref).splitlines())
    names |= set(run("ls-files", "--others",
                     "--exclude-standard").splitlines())
    return {os.path.abspath(os.path.join(top, n))
            for n in names if n.endswith(".py")}


def _list_rules() -> None:
    from photon_ml_tpu_torch.analysis.rules import all_rules
    for rule in all_rules():
        print(f"{rule.rule_id}  {rule.name:16s} {rule.summary}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0
    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    findings = lint_paths(paths, select=select)

    if args.diff is not None:
        try:
            changed = _git_changed_files(args.diff, paths)
        except RuntimeError as e:
            print(f"photonlint: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
        findings = [f for f in findings
                    if os.path.abspath(f.path) in changed]

    if args.write_baseline:
        n = Baseline.write(args.baseline, findings)
        print(f"photonlint: wrote {n} baseline finding(s) to "
              f"{args.baseline}")
        return 0

    if args.no_baseline:
        new, old, stale = list(findings), [], 0
        baseline_total = 0
    else:
        baseline = Baseline.load(args.baseline)
        new, old, stale = baseline.split(findings)
        baseline_total = baseline.total

    if args.as_json:
        report = {
            "version": 1,
            "findings": [dict(f.to_dict(), baselined=False) for f in new]
            + [dict(f.to_dict(), baselined=True) for f in old],
            "counts": {"new": len(new), "baselined": len(old),
                       "stale_baseline_entries": stale},
            "baseline": {"path": (None if args.no_baseline
                                  else args.baseline),
                         "total": baseline_total},
        }
        json.dump(report, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for f in new:
            print(f.render())
        if old:
            print(f"photonlint: {len(old)} baselined finding(s) "
                  "suppressed (see --no-baseline)")
        if stale:
            print(f"photonlint: {stale} stale baseline entr"
                  f"{'y' if stale == 1 else 'ies'} no longer match — "
                  "regenerate with --write-baseline to shrink the "
                  "baseline")
        if new:
            print(f"photonlint: {len(new)} new finding(s)")
        else:
            print("photonlint: clean")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
