"""Trace tooling CLI: stitch per-process run logs into ONE fleet
timeline (a copy of photon_ml_tpu/cli/trace.py; it reads either package's
run logs).

Every process run with --run-log (cli.train here; the JAX package's
cli.serve fleet members, one per front, replica and publisher) leaves
one JSONL run log.  `merge` aligns their
clocks (the front's probe-derived offsets), joins the propagated request
ids (X-Photon-Trace) into connected trees, and writes a validated
Perfetto/Chrome trace with one process track per fleet member:

    python -m photon_ml_tpu_torch.cli.trace merge \
        out/front.jsonl out/pub.jsonl out/r0.jsonl \
        --out fleet-trace.json

Open the result at https://ui.perfetto.dev.  The summary (last stdout
line, JSON) reports per-request connectivity (`requests`), the clock
offsets applied, and containment violations (children outside their
parents after alignment); exit status is non-zero when the merged trace
fails `validate_chrome_trace`.

Directories are accepted in place of files (every *.jsonl inside is
merged) — point it at the fleet's shared --run-log directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-trace")
    sub = p.add_subparsers(dest="command", required=True)
    m = sub.add_parser(
        "merge", help="merge per-process run logs into one Perfetto "
                      "timeline")
    m.add_argument("run_logs", nargs="+", metavar="RUN.jsonl|DIR",
                   help="per-process run logs (cli.serve/cli.train "
                        "--run-log); a directory means every *.jsonl "
                        "inside it")
    m.add_argument("--out", default="fleet-trace.json",
                   metavar="TRACE.json",
                   help="merged Chrome-trace output path")
    m.add_argument("--containment-slack-ms", type=float, default=25.0,
                   help="alignment tolerance for the child-inside-parent "
                        "check (clock-probe RTT bounds the alignment "
                        "error)")
    return p


def _expand(paths) -> list:
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            out.append(p)
    if not out:
        raise SystemExit("no run logs to merge")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command != "merge":  # pragma: no cover - argparse enforces
        raise SystemExit(f"unknown command {args.command!r}")
    from photon_ml_tpu_torch.telemetry.distributed import merge_run_logs
    report = merge_run_logs(
        _expand(args.run_logs), out_path=args.out,
        containment_slack_s=args.containment_slack_ms / 1e3)
    summary = {k: v for k, v in report.items() if k != "trace"}
    print(json.dumps(summary), flush=True)
    if report["problems"]:
        print(f"merged trace INVALID: {report['problems'][:5]}",
              file=sys.stderr)
        return 1
    print(f"merged {len(report['processes'])} process(es), "
          f"{report['spans']} span(s) -> {args.out} — open at "
          "https://ui.perfetto.dev", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
