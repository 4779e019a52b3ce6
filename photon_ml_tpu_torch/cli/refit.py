"""Continuous-training CLI (port of photon_ml_tpu/cli/refit.py): replay
the feedback lane into a refit cycle, on one CUDA device unless `--device
cpu` is given; `--x64` refits in float64.

The operational entry point of photon_ml_tpu_torch/refit/ — load the incumbent
model, compact the durable feedback lane into training chunks, run the
warm anchored refit, validate candidate vs incumbent on the log's
held-back tail, and (on a win) swap the candidate in:

  # manual one-shot
  python -m photon_ml_tpu_torch.cli.refit --model-dir out/best \
      --feedback-log /srv/fb --chunks /srv/chunks --model-root /srv/models

  # cron-style: a cycle every 15 minutes until SIGINT
  ... --interval 900

  # automatic remediation: watch a serving fleet's /healthz and refit
  # after 3 consecutive degraded polls, at most every 10 minutes
  ... --on-trip --healthz-url http://front:8080/healthz \
      --trip-polls 3 --cooloff 600

With --replication-log the winning swap is appended to the fleet's
replication log (fleet.FleetPublisher), so every replica tailing it
picks the new model up exactly like any other publisher swap — rollback
and version-vector semantics intact.

SINGLE-WRITER CAVEAT: the feedback lane is opened with the replication
log's recovery discipline, which may truncate a torn tail.  Run this CLI
against a lane whose writer is stopped, a filesystem snapshot, or let
the serving process host the trigger in-process instead (refit.trigger).

Exit codes: 0 = cycle ran (swapped or not; see the printed JSON),
1 = the cycle failed (the incumbent keeps serving), 2 = bad arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-refit")
    p.add_argument("--model-dir", required=True,
                   help="incumbent model directory (any models/io layout)")
    p.add_argument("--feedback-log", required=True, metavar="DIR",
                   help="the durable feedback lane (fleet.FeedbackLog; "
                        "cli.serve --feedback-log)")
    p.add_argument("--chunks", required=True, metavar="DIR",
                   help="compactor output directory (chunk files + "
                        "manifest.json; reused incrementally across runs)")
    p.add_argument("--model-root", required=True, metavar="DIR",
                   help="where candidate version directories are written")
    p.add_argument("--chunk-rows", type=int, default=1024,
                   help="rows per sealed chunk, power of two (default "
                        "%(default)s; part of the chunk store's identity)")
    p.add_argument("--holdout-frac", type=float, default=0.2,
                   help="newest fraction of the log held back for "
                        "validation (default %(default)s)")
    p.add_argument("--outer-iterations", type=int, default=2,
                   help="alternating FE/RE passes (default %(default)s)")
    p.add_argument("--fe-iterations", type=int, default=50)
    p.add_argument("--re-iterations", type=int, default=100)
    p.add_argument("--anchor-weight", type=float, default=1.0,
                   help="pull toward the incumbent's random-effect rows")
    p.add_argument("--min-improvement", type=float, default=0.0,
                   help="holdout-loss margin the candidate must win by")
    p.add_argument("--version", default=None,
                   help="explicit candidate version name (default: "
                        "refit-seq<checkpoint>-n<rows>)")
    p.add_argument("--replication-log", default=None, metavar="DIR",
                   help="append winning swaps to this fleet replication "
                        "log (fleet.FleetPublisher)")
    p.add_argument("--interval", type=float, default=None, metavar="S",
                   help="cron-style mode: run a cycle every S seconds "
                        "until interrupted")
    p.add_argument("--on-trip", action="store_true",
                   help="automatic mode: refit on a sustained degraded "
                        "/healthz verdict (needs --healthz-url)")
    p.add_argument("--healthz-url", default=None,
                   help="serving /healthz endpoint --on-trip watches")
    p.add_argument("--trip-polls", type=int, default=2,
                   help="consecutive degraded polls that fire a cycle")
    p.add_argument("--cooloff", type=float, default=60.0,
                   help="minimum seconds between automatic cycles")
    p.add_argument("--poll", type=float, default=2.0,
                   help="trigger poll period in automatic modes")
    p.add_argument("--device", default="cuda",
                   help="torch device to refit on (default cuda; without "
                        "CUDA the run exits non-zero unless --device cpu)")
    p.add_argument("--x64", action="store_true",
                   help="load the incumbent and refit in float64 (float32 "
                        "otherwise)")
    return p


class _HealthzProbe:
    """A `degraded` property over a serving /healthz endpoint — the duck
    type (HealthMonitor.degraded) the RefitTrigger's on_trip mode polls.
    Unreachable endpoints read as healthy: a refit is the wrong remedy
    for a dead server."""

    def __init__(self, url: str, timeout_s: float = 2.0):
        self.url = url
        self.timeout_s = timeout_s

    @property
    def degraded(self) -> bool:
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout_s) as resp:
                body = json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 503:      # the serve CLI's degraded status code
                return True
            return False
        except (OSError, ValueError):
            return False
        health = body.get("health") or {}
        return (body.get("status") == "degraded"
                or health.get("status") == "degraded")


def _result_line(result) -> str:
    return json.dumps(dataclasses.asdict(result), sort_keys=True)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.on_trip and args.healthz_url is None:
        parser.error("--on-trip needs --healthz-url (the verdict source)")
    if args.on_trip and args.interval is not None:
        parser.error("pick one of --interval / --on-trip")

    import torch

    from photon_ml_tpu_torch.cli.train import resolve_cli_device
    from photon_ml_tpu_torch.fleet.replog import FeedbackLog
    from photon_ml_tpu_torch.refit import (CompactorConfig, LogCompactor,
                                           RefitConfig, RefitDriver,
                                           RefitTrigger, TriggerConfig)
    from photon_ml_tpu_torch.serving import ScoringService, ServingConfig

    device = resolve_cli_device(args.device)
    service = ScoringService(
        model_dir=args.model_dir, start_updater=False,
        config=ServingConfig(device=str(device), dtype=(
            torch.float64 if args.x64 else torch.float32)))
    publisher = None
    if args.replication_log is not None:
        from photon_ml_tpu_torch.fleet import ReplicationLog
        from photon_ml_tpu_torch.fleet.replica import FleetPublisher
        publisher = FleetPublisher(service,
                                   ReplicationLog(args.replication_log),
                                   model_dir=args.model_dir)
    log = FeedbackLog(args.feedback_log)
    dropped = log.recover()
    if dropped:
        print(f"feedback lane: truncated {dropped} torn tail byte(s)",
              file=sys.stderr)
    compactor = LogCompactor(log, args.chunks,
                             CompactorConfig(chunk_rows=args.chunk_rows))
    log.register_consumer("refit-compactor", compactor.checkpoint_seq)
    driver = RefitDriver(
        service.registry, compactor, args.model_root,
        RefitConfig(holdout_frac=args.holdout_frac,
                    outer_iterations=args.outer_iterations,
                    fe_iterations=args.fe_iterations,
                    re_iterations=args.re_iterations,
                    anchor_weight=args.anchor_weight,
                    min_loss_improvement=args.min_improvement),
        metrics=service.metrics)

    trigger = None
    try:
        if args.interval is None and not args.on_trip:
            result = driver.run_once(version=args.version)
            print(_result_line(result))
            return 0
        if args.on_trip:
            cfg = TriggerConfig(mode="on_trip", poll_s=args.poll,
                                trip_polls=args.trip_polls,
                                cooloff_s=args.cooloff)
            trigger = RefitTrigger(driver, health=_HealthzProbe(
                args.healthz_url), config=cfg)
        else:
            cfg = TriggerConfig(mode="interval", interval_s=args.interval,
                                poll_s=args.poll)
            trigger = RefitTrigger(driver, config=cfg)
        while True:                       # SIGINT ends the watch loop
            result = trigger.poll()
            if result is not None:
                print(_result_line(result), flush=True)
            elif trigger.state()["last_error"]:
                print(json.dumps({"failed": trigger.state()["last_error"]}),
                      file=sys.stderr, flush=True)
            time.sleep(cfg.poll_s)
    except KeyboardInterrupt:
        state = trigger.state() if trigger is not None else {}
        print(json.dumps({"stopped": True, **state}), flush=True)
        return 0
    except Exception as e:
        print(f"refit failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        del publisher          # hook-driven; no background state to stop
        service.close()


if __name__ == "__main__":
    sys.exit(main())
