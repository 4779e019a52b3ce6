"""The port's host-sync inventory: every torch host sync the linter's PH001
sees in a hot-path module, by module and by what answers it.

    python3 scripts/host_sync_inventory.py [--json] [PATH ...]

A site is answered by its module's `# photonlint: disable-file=PH001`
(a host-stepped module), by the `# photonlint: flush-point` of the
function it sits in (a designed read-back), by a line's
`# photonlint: disable=PH001`, by the committed baseline
(photon_ml_tpu_torch/analysis/baseline.json), or by nothing ("new": the
linter then exits 1).  Static: it reads the sources and runs nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from photon_ml_tpu_torch.analysis.engine import Baseline, parse_modules  # noqa: E402
from photon_ml_tpu_torch.analysis.lint import DEFAULT_BASELINE  # noqa: E402
from photon_ml_tpu_torch.analysis.rules import HostSyncRule  # noqa: E402

KINDS = ("disable-file", "flush-point", "disable", "baselined", "new")


def inventory(paths) -> dict:
    """{module: {kind: count}} over the hot-path modules under `paths`."""
    contexts, _ = parse_modules(paths)
    sites = []
    for ctx in contexts:
        if not ctx.is_hot_path:
            continue
        flush = ctx.suppressions.flush_lines
        spans = [(fn.lineno, fn.end_lineno) for fn in ctx.function_defs
                 if ctx.flush_point(fn)]
        ctx.suppressions.flush_lines = set()      # see inside flush points too
        try:
            found = list(HostSyncRule().check(ctx))
        finally:
            ctx.suppressions.flush_lines = flush
        sup = ctx.suppressions
        for f in found:
            if sup.file_all or "PH001" in sup.file_rules:
                kind = "disable-file"
            elif any(lo <= f.line <= hi for lo, hi in spans):
                kind = "flush-point"
            elif sup.suppressed("PH001", f.line):
                kind = "disable"
            else:
                kind = None
            sites.append((ctx.norm_path, f, kind))
    new, old, _ = Baseline.load(DEFAULT_BASELINE).split(
        [f for _, f, kind in sites if kind is None])
    baselined = {id(f) for f in old}
    out: dict = {}
    for path, f, kind in sites:
        kind = kind or ("baselined" if id(f) in baselined else "new")
        row = out.setdefault(f.baseline_path, dict.fromkeys(KINDS, 0))
        row[kind] += 1
    return dict(sorted(out.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*", default=[str(ROOT / "photon_ml_tpu_torch")])
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    inv = inventory(args.paths)
    if args.json:
        print(json.dumps(inv, indent=1))
        return 0
    print(f"{'module':48s} " + " ".join(f"{k:>12s}" for k in KINDS))
    for path, row in inv.items():
        print(f"{path:48s} " + " ".join(f"{row[k]:12d}" for k in KINDS))
    totals = {k: sum(r[k] for r in inv.values()) for k in KINDS}
    print(f"{'total':48s} " + " ".join(f"{totals[k]:12d}" for k in KINDS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
