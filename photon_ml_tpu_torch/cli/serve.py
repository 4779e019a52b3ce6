"""Online scoring service CLI (port of photon_ml_tpu/cli/serve.py), on one
CUDA device unless `--device cpu` is given; `--x64` serves in float64.
The routing front (`--front`) is model-free and touches no device.

The serving counterpart of cli.score: load a GAME model directory (any
layout the port's `models/io.py` reads — npz, Avro interchange, or a
directory the Scala reference wrote) into a warmed `ScoringService` and
serve it.

HTTP mode (default) — a dependency-free stdlib server:

  python -m photon_ml_tpu_torch.cli.serve --model-dir out/best --port 8080

  POST /score    {"features": {shard: [[...]]}, "ids": {type: [...]},
                  "timeout_ms": 50}        -> {"scores": [...]}
  POST /predict  same body                 -> {"predictions": [...]}
  POST /feedback same body + "labels" (opt "weights"/"offsets"/
                  "event_ids")             -> 202 intake accounting
                                              (--enable-updates only: the
                                              online tier re-solves the
                                              touched entities' random
                                              effects and publishes
                                              row-level delta swaps)
  GET  /metrics                            -> Prometheus text exposition
                                              (0.0.4; scrape this —
                                              includes serve.model_age_s
                                              and online.* instruments)
  GET  /metrics.json                       -> ServingMetrics JSON snapshot
  POST /swap     {"model_dir": "..."}      -> zero-downtime hot swap
  POST /rollback                           -> delta-aware: pending delta
                                              swaps revert to exact
                                              pre-delta rows, else the
                                              previous full model
  GET  /healthz                            -> status + version vector +
                                              updater vitals (thread
                                              liveness, last-cycle age,
                                              frozen entities) + the
                                              per-gate health verdict;
                                              HTTP 503 when a health gate
                                              is tripped (status
                                              "degraded")

  429 = Overloaded (queue full; POST /feedback rejections carry a
  Retry-After header derived from the online updater's observed drain
  rate), 504 = DeadlineExceeded, 400 = bad request.
  SIGUSR1 dumps a metrics snapshot to stderr; --metrics-interval dumps one
  periodically.

Graceful drain: SIGTERM/SIGINT stops accepting new requests, finishes the
in-flight micro-batches, flushes the FeedbackBuffer through the online
updater (when updates are enabled), closes everything cleanly, prints a
final {"drained": true, ...} line and exits 0.  A second signal aborts
immediately (utils.faults.GracefulPreemption semantics).

Fleet modes (photon_ml_tpu_torch/fleet/ — see COMPONENTS.md "Replicated
serving"):

  --replica --replication-log DIR --replica-state DIR
      run as a fleet replica: join (snapshot bootstrap + log-tail replay
      + delta-scatter warmup), then keep converged with the publisher's
      model state by tailing the replication log.  /healthz returns 503
      until ready (and while draining/failed), so a front or Kubernetes
      probe holds traffic.  Followers refuse /swap, /rollback and
      /feedback (model state enters the fleet through the log only).
      Extra endpoints: GET /fleet/audit (version vector + per-table
      sha256 — the bit-identical convergence check), POST /fleet/drain.
  --replica --publish [--enable-updates]
      the PUBLISHER replica: every registry mutation (swap, delta,
      rollback) is appended to the replication log in mutation order;
      the online updater's delta stream replicates live.
  --front --replica-url URL [--replica-url URL ...]
      model-free routing front: /score + /predict round-robin over READY
      replicas (health-probed, failover, hedged tail latency, bounded
      in-flight -> 429), /feedback//swap//rollback proxied to the
      publisher replica, GET /fleet/audit fans out to every replica,
      POST /fleet/drain {"replica": URL} drains one replica out of
      rotation.
  --replica --shard K/N   (entity-sharded serving — COMPONENTS.md
      "Entity-sharded serving")
      this replica holds ONLY shard K of an N-way deterministic
      partition of the random-effect entity space (FE/MF replicate in
      full; replicated deltas filter to owned rows; tiered-store
      residency is sized to the slice).  POST /margins serves one
      fan-out leg; the publisher declares the partition with
      --shard-count N (a shard_map record anchors the log), and a front
      over sharded replicas fans /score //predict out per shard and
      re-folds bit-identically, degrading per --degraded-policy when a
      shard has no healthy replica.  GET /fleet/audit?shard=K on the
      publisher returns the full model filtered to shard K — equal
      hashes to a converged shard-K replica's own audit.

Fleet observability (COMPONENTS.md "Fleet observability"): --trace-out /
--run-log arm the span tracer in EVERY mode (front/replica/publish
included) with export on exit — including the SIGTERM drain path — at
cli.train parity; per-process run logs merge into one fleet timeline via
`python -m photon_ml_tpu_torch.cli.trace merge` (either package's run
logs).  Requests propagate
X-Photon-Trace / X-Photon-Parent headers end to end (front routing →
replica scoring, /feedback → update cycle → replication record → replica
apply).  The flight recorder is always armed (bounded in-memory ring);
--flight-dir makes its dump-on-anomaly bundles durable, and POST
/flight/dump triggers a correlated dump (the front broadcasts it when a
replica leaves rotation).  A front's GET /metrics is the FEDERATED
exposition (own registry + every replica's with instance labels +
per-replica lag); GET /metrics/front is the front-only page.

Burst mode (--burst DATA.npz) — drive a synthetic client burst from a
GameDataset through the full micro-batching pipeline in-process, print the
metrics snapshot as the last stdout line, and exit; --output writes the
scores npz (row order preserved) so results can be diffed against
cli.score on the same data.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-serve")
    p.add_argument("--model-dir", default=None,
                   help="GAME model directory (any layout models/io.py "
                        "reads); required except in --front mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="HTTP port (0 = ephemeral; the bound port is "
                        "printed in the startup line)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="micro-batch coalescing window")
    p.add_argument("--max-batch", type=int, default=1024,
                   help="max rows per device call (power-of-two rounded)")
    p.add_argument("--max-queue", type=int, default=4096,
                   help="pending requests before shedding (Overloaded)")
    p.add_argument("--min-bucket", type=int, default=8,
                   help="smallest padded batch bucket")
    p.add_argument("--default-timeout-ms", type=float, default=None,
                   help="per-request deadline when the client sets none")
    p.add_argument("--metrics-interval", type=float, default=0.0,
                   help="seconds between periodic metrics dumps to stderr "
                        "(0 = only on SIGUSR1)")
    p.add_argument("--enable-updates", action="store_true",
                   help="online learning tier: accept POST /feedback and "
                        "publish per-entity random-effect delta swaps "
                        "into the live scorer")
    p.add_argument("--update-interval-ms", type=float, default=20.0,
                   help="idle poll period of the online update loop")
    p.add_argument("--update-micro-batch", type=int, default=16,
                   help="entity lanes per anchored online solve "
                        "(power-of-two rounded)")
    p.add_argument("--update-anchor-weight", type=float, default=1.0,
                   help="prior-pull strength toward the batch solution "
                        "(lambda of ||c - c0||^2)")
    p.add_argument("--update-max-rows-per-entity", type=int, default=64,
                   help="per-entity sample ceiling per online solve "
                        "(newest rows win)")
    p.add_argument("--feedback-max-pending", type=int, default=8192,
                   help="pending feedback rows before backpressure "
                        "(Overloaded / HTTP 429)")
    p.add_argument("--health-config", default=None, metavar="JSON",
                   help="arm the model-health monitor: HealthConfig as "
                        "inline JSON or @file ('{}' = defaults). Streaming "
                        "calibration + drift gates flip /healthz to "
                        "degraded, pause the online updater, and per "
                        "rollback_on trigger the delta-aware rollback")
    p.add_argument("--max-delta-log", type=int, default=4096,
                   help="delta undo-log bound; overflow drops the oldest "
                        "records LOUDLY and rollback degrades to a "
                        "full-model swap (serve.rollback_degraded)")
    # -- tiered entity store ------------------------------------------------
    p.add_argument("--store-budget-rows", type=int, default=None,
                   metavar="N",
                   help="serve random-effect tables through the tiered "
                        "entity store with a device hot set of N rows "
                        "(misses promote from the host warm tier / disk "
                        "cold tier; requires --store-dir)")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="cold-tier directory for --store-budget-rows "
                        "(sealed sha256-verified row segments; each "
                        "installed version gets a subdirectory)")
    p.add_argument("--store-warm-segments", type=int, default=64,
                   help="host warm-tier budget in segments "
                        "(x --store-seg-rows rows)")
    p.add_argument("--store-seg-rows", type=int, default=16384,
                   help="rows per cold segment file")
    # -- fleet: replica mode ------------------------------------------------
    p.add_argument("--replica", action="store_true",
                   help="run as a fleet replica: join from the "
                        "replication log, stay converged, 503 until "
                        "ready (requires --replication-log and "
                        "--replica-state)")
    p.add_argument("--publish", action="store_true",
                   help="this replica is the PUBLISHER: its registry "
                        "mutations (swaps, deltas, rollbacks) append to "
                        "the replication log in mutation order")
    p.add_argument("--replication-log", default=None, metavar="DIR",
                   help="replication log directory (shared filesystem "
                        "between publisher and replicas)")
    p.add_argument("--replica-state", default=None, metavar="DIR",
                   help="this replica's durable state dir (applied.json "
                        "— the crash/catch-up resume point)")
    p.add_argument("--replica-poll-ms", type=float, default=50.0,
                   help="log tail poll period of the replica apply loop")
    # -- fleet: entity sharding (fleet/shards.py) ---------------------------
    p.add_argument("--shard", default=None, metavar="K/N",
                   help="entity-sharded replica: hold only shard K of an "
                        "N-way partition of the random-effect entity "
                        "space (K in [0,N); fixed-effect/MF coordinates "
                        "replicate in full; replicated deltas filter to "
                        "owned rows; /margins serves fan-out legs)")
    p.add_argument("--shard-count", type=int, default=None, metavar="N",
                   help="publisher: declare the fleet's N-way entity "
                        "partition — anchors a shard_map record on the "
                        "replication log so joining replicas validate "
                        "their --shard against it (the publisher itself "
                        "stays unsharded)")
    p.add_argument("--shard-salt", default="photon",
                   help="shard-map hash salt (must match fleet-wide)")
    p.add_argument("--shard-spec-version", type=int, default=1,
                   help="shard-map version; a rebalance rolls out by "
                        "bumping it fleet-wide (the front adopts the "
                        "highest version it probes)")
    # -- fleet: front mode --------------------------------------------------
    p.add_argument("--front", action="store_true",
                   help="run the model-free routing front over "
                        "--replica-url replicas")
    p.add_argument("--replica-url", action="append", default=[],
                   help="replica base URL (repeatable); the first is the "
                        "publisher unless --publisher-url is given")
    p.add_argument("--publisher-url", default=None,
                   help="which replica accepts /feedback,/swap,/rollback")
    p.add_argument("--probe-interval-ms", type=float, default=250.0,
                   help="front: /healthz probe period per replica")
    p.add_argument("--hedge-ms", type=float, default=250.0,
                   help="front: hedge a duplicate request after this "
                        "long pending")
    p.add_argument("--front-timeout-ms", type=float, default=10_000.0,
                   help="front: per-attempt request timeout")
    p.add_argument("--max-inflight", type=int, default=256,
                   help="front: concurrently routed requests before "
                        "shedding (429)")
    p.add_argument("--degraded-policy", choices=("partial", "error"),
                   default="partial",
                   help="front, sharded fleets: what scoring gets when a "
                        "touched shard has no healthy replica — "
                        "'partial' folds the lost contributions as 0.0 "
                        "and stamps the response degraded, 'error' "
                        "fails those requests 503")
    # -- fleet observability (telemetry/distributed + telemetry/flight) -----
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="arm the telemetry span tracer and write a Chrome-"
                        "trace timeline at exit (cli.train parity; works "
                        "in every mode including --front/--replica/"
                        "--publish, and on the SIGTERM drain path)")
    p.add_argument("--run-log", default=None, metavar="RUN.jsonl",
                   help="stream span/event records as JSONL while "
                        "serving; arms the tracer like --trace-out.  The "
                        "per-process run logs are what `python -m "
                        "photon_ml_tpu_torch.cli.trace merge` stitches into "
                        "one fleet timeline")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="durable flight-recorder bundle directory: the "
                        "always-on ring of recent spans/events/log lines "
                        "dumps here on health-gate trips, replica "
                        "failures, rollbacks, SIGTERM drain and crashes "
                        "(without it the ring stays in memory only)")
    p.add_argument("--flight-ring", type=int, default=4096,
                   help="flight-recorder ring capacity (records)")
    p.add_argument("--event-listener", action="append", default=[],
                   help="dotted EventListener class path (repeatable); "
                        "receives ScoringBatchEvent/ModelSwapEvent")
    p.add_argument("--burst", default=None, metavar="DATA",
                   help="burst mode: npz GameDataset to score as a "
                        "concurrent request stream, then exit")
    p.add_argument("--request-rows", type=int, default=1,
                   help="burst mode: rows per client request")
    p.add_argument("--threads", type=int, default=8,
                   help="burst mode: concurrent client threads")
    p.add_argument("--output", default=None,
                   help="burst mode: write scores npz (canonical row order)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; without "
                        "CUDA the run exits non-zero unless --device cpu; "
                        "--front ignores it)")
    p.add_argument("--x64", action="store_true",
                   help="serve in float64 (float32 otherwise)")
    return p


def _build_service(args, device):
    import torch

    from photon_ml_tpu_torch.serving import ScoringService, ServingConfig
    from photon_ml_tpu_torch.utils.events import EventEmitter
    emitter = None
    if args.event_listener:
        emitter = EventEmitter()
        for dotted in args.event_listener:
            emitter.register_listener_class(dotted)
    shard_index = shard_count = None
    if getattr(args, "shard", None):
        shard_index, shard_count = _parse_shard(args.shard)
    cfg = ServingConfig(
        max_wait_s=args.max_wait_ms / 1e3,
        max_batch=args.max_batch,
        max_queue=args.max_queue,
        min_bucket=args.min_bucket,
        default_timeout_s=(None if args.default_timeout_ms is None
                           else args.default_timeout_ms / 1e3),
        max_delta_log=args.max_delta_log,
        store_budget_rows=args.store_budget_rows,
        store_dir=args.store_dir,
        store_warm_segments=args.store_warm_segments,
        store_seg_rows=args.store_seg_rows,
        shard_index=shard_index,
        shard_count=shard_count,
        shard_salt=getattr(args, "shard_salt", "photon"),
        shard_version=getattr(args, "shard_spec_version", 1),
        device=str(device),
        dtype=torch.float64 if args.x64 else torch.float32)
    updates = None
    if args.enable_updates:
        from photon_ml_tpu_torch.online import OnlineUpdateConfig
        updates = OnlineUpdateConfig(
            micro_batch=args.update_micro_batch,
            max_rows_per_entity=args.update_max_rows_per_entity,
            anchor_weight=args.update_anchor_weight,
            interval_s=args.update_interval_ms / 1e3,
            max_pending_rows=args.feedback_max_pending)
    health = None
    if args.health_config is not None:
        from photon_ml_tpu_torch.cli.train import _load_json_arg
        from photon_ml_tpu_torch.health import HealthConfig
        health = HealthConfig.from_dict(_load_json_arg(args.health_config))
    # publisher mode starts the updater only AFTER the replication
    # publish hook is attached (main wires that), so no delta can ever
    # land unreplicated
    start_updater = not (args.replica and args.publish)
    return ScoringService(model_dir=args.model_dir, config=cfg,
                          emitter=emitter, updates=updates, health=health,
                          start_updater=start_updater)


def _parse_shard(text: str):
    """--shard "K/N" -> (index, count)."""
    try:
        k, _, n = text.partition("/")
        index, count = int(k), int(n)
    except ValueError:
        raise SystemExit(f"--shard expects K/N (e.g. 0/4), got {text!r}")
    if not 0 <= index < count:
        raise SystemExit(f"--shard index {index} out of range for "
                         f"{count} shards")
    return index, count


def _dump_metrics(service, stream=sys.stderr):
    print(json.dumps(service.metrics_snapshot()), file=stream, flush=True)


def _arm_observability(args, proc: str) -> None:
    """cli.train wiring parity for the serve CLI, every mode: --trace-out
    / --run-log arm the span tracer (run logs are what `cli.trace merge`
    stitches); the flight recorder is ALWAYS armed — the ring stays in
    memory until --flight-dir makes its dumps durable."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.telemetry import flight
    if args.trace_out or args.run_log or args.flight_dir:
        telemetry.install(run_log=args.run_log, proc=proc)
    flight.install(dump_dir=args.flight_dir, proc=proc,
                   ring_records=args.flight_ring)


def _export_observability(args) -> None:
    """Finish the tracer and export the Chrome trace — reached on clean
    exit, SIGTERM drain, AND crash paths (the finally in main)."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.telemetry import flight
    telemetry.shutdown()
    flight.shutdown()
    if args.trace_out and telemetry.last_tracer() is not None:
        try:
            info = telemetry.write_chrome_trace(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"({info['events']} events) — open at "
                  "https://ui.perfetto.dev", file=sys.stderr)
        except Exception as e:
            print(f"trace export failed: {e}", file=sys.stderr)


def _install_metrics_hooks(service, interval_s: float):
    try:  # SIGUSR1 works only on the main thread of the main interpreter
        signal.signal(signal.SIGUSR1, lambda *_: _dump_metrics(service))
    except (ValueError, AttributeError, OSError):
        pass
    if interval_s > 0:
        def loop():
            while True:
                time.sleep(interval_s)
                _dump_metrics(service)
        threading.Thread(target=loop, daemon=True,
                         name="photon-serving-metrics").start()


# -- burst mode ------------------------------------------------------------

def run_burst(service, data_path: str, request_rows: int, threads: int,
              output: str = None) -> dict:
    """Concurrent client burst over a GameDataset: split rows into
    `request_rows`-sized requests, fire them from a thread pool through the
    micro-batcher, reassemble scores in canonical row order."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from photon_ml_tpu_torch.data.game_data import load_game_dataset
    ds = load_game_dataset(data_path)
    scorer = service.registry.scorer
    n = ds.num_rows
    chunks = [np.arange(lo, min(lo + request_rows, n))
              for lo in range(0, n, request_rows)]
    scores = np.empty(n, np.float64)
    errors = []

    def one(rows):
        feats, ids = scorer.requests_from_dataset(ds, rows)
        try:
            scores[rows] = service.score(feats, ids)
        except Exception as e:  # count, keep the burst going
            errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, chunks))
    wall = time.perf_counter() - t0
    if output and not errors:
        np.savez_compressed(output if output.endswith(".npz")
                            else output + ".npz", scores=scores)
    snap = service.metrics_snapshot()
    return {
        "mode": "burst", "rows": n, "requests": len(chunks),
        "threads": threads, "wall_s": round(wall, 4),
        "requests_per_sec": round(len(chunks) / wall, 1),
        "rows_per_sec": round(n / wall, 1),
        "failed_requests": len(errors),
        "first_errors": errors[:3],
        "output": output,
        "metrics": snap,
    }


# -- HTTP mode -------------------------------------------------------------

def _make_http_server(service, host: str, port: int, replica=None,
                      publisher=None):
    """`replica` (fleet.Replica) and `publisher` (fleet.FleetPublisher)
    extend the handler with the fleet endpoints and gate the model-state
    routes: followers refuse /swap, /rollback and /feedback — replicated
    model state enters through the log, never through a follower."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from photon_ml_tpu_torch.fleet.replog import encode_array
    from photon_ml_tpu_torch.serving import DeadlineExceeded, Overloaded
    from photon_ml_tpu_torch.telemetry import distributed, flight

    follower = replica is not None and publisher is None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # requests are metered, not logged
            pass

        def _reply(self, code: int, payload: dict, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def _reply_text(self, code: int, body: str, content_type: str):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/metrics":
                # Prometheus scrape endpoint (text exposition 0.0.4); the
                # JSON snapshot moved to /metrics.json
                self._reply_text(
                    200, service.prometheus_metrics(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                self._reply(200, service.metrics_snapshot())
            elif self.path == "/healthz":
                payload = service.healthz()
                # every probe is also a clock probe: the front estimates
                # this process's wall-clock offset from (pid, wall_s),
                # which is what aligns the merged fleet timeline
                payload["telemetry"] = distributed.clock_info()
                if publisher is not None:
                    fleet = publisher.status()
                    # the publisher IS the source of truth: its applied
                    # seq is the log head (what replica lag measures
                    # against)
                    head = publisher.head_seq()
                    fleet.update({"ready": fleet["failed"] is None,
                                  "applied_seq": head, "head_seq": head,
                                  "lag_seq": 0})
                    payload["fleet"] = fleet
                    if fleet["failed"] is not None:
                        payload["status"] = "degraded"
                elif replica is not None:
                    # joining / draining / failed -> 503 so the front
                    # (or a stock Kubernetes probe) holds traffic until
                    # the replica is converged and warm
                    payload["fleet"] = replica.status()
                    if not replica.healthy():
                        payload["status"] = "degraded"
                # degraded -> 503 so a stock load balancer / Kubernetes
                # probe takes the replica out without parsing the body
                self._reply(200 if payload["status"] == "ok" else 503,
                            payload)
            elif self.path.split("?", 1)[0] == "/fleet/audit":
                from urllib.parse import parse_qs, urlsplit
                q = parse_qs(urlsplit(self.path).query)
                if q.get("shard") and publisher is not None:
                    # the publisher-side half of a per-shard audit: its
                    # FULL tables filtered to shard K's owned rows — a
                    # converged shard-K replica's plain audit reports
                    # the identical sha256 hashes
                    try:
                        self._reply(200, publisher.shard_audit(
                            int(q["shard"][0])))
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                elif replica is not None:
                    self._reply(200, replica.audit())
                else:
                    audit = service.audit()
                    if publisher is not None:
                        audit.update({"role": "publisher",
                                      "applied_seq": publisher.head_seq()})
                    self._reply(200, audit)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                req = self._body()
            except ValueError as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path in ("/score", "/predict"):
                    # the server half of the propagated hop: adopts the
                    # front's X-Photon-Trace/-Parent headers (minting an
                    # id for direct traffic), so this request's spans
                    # join the fleet-wide tree at merge time
                    with distributed.server_span("serve_request",
                                                 self.headers,
                                                 path=self.path):
                        feats = {s: np.asarray(v, np.float64)
                                 for s, v in (req.get("features")
                                              or {}).items()}
                        ids = {t: np.asarray(v, dtype=object)
                               for t, v in (req.get("ids") or {}).items()}
                        timeout = req.get("timeout_ms")
                        timeout = (None if timeout is None
                                   else timeout / 1e3)
                        if self.path == "/score":
                            out = service.score(feats, ids,
                                                timeout=timeout)
                            key = "scores"
                        else:
                            out = service.predict(feats, ids,
                                                  timeout=timeout)
                            key = "predictions"
                    self._reply(200, {key: np.asarray(out).tolist(),
                                      "model_version": service.model_version})
                elif self.path == "/margins":
                    # one leg of an entity-sharded fan-out (fronts call
                    # this; fleet/shards.merge_margins re-folds the
                    # legs).  Margins travel as encode_array payloads —
                    # exact dtype + bytes, since the merge's bit-identity
                    # depends on folding the device compute dtype, not a
                    # JSON float round-trip
                    with distributed.server_span("serve_request",
                                                 self.headers,
                                                 path=self.path):
                        feats = {s: np.asarray(v, np.float64)
                                 for s, v in (req.get("features")
                                              or {}).items()}
                        ids = {t: np.asarray(v, dtype=object)
                               for t, v in (req.get("ids") or {}).items()}
                        out = service.score_margins(feats, ids)
                    out["margins"] = {name: encode_array(m)
                                      for name, m in out["margins"].items()}
                    self._reply(200, out)
                elif self.path == "/feedback":
                    if follower:
                        return self._reply(403, {
                            "error": "this is a follower replica: "
                                     "feedback goes to the publisher "
                                     "(model state enters the fleet "
                                     "through the replication log)"})
                    if service.updater is None:
                        return self._reply(400, {
                            "error": "online updates are not enabled "
                                     "(start with --enable-updates)"})
                    feats = {s: np.asarray(v, np.float64)
                             for s, v in (req.get("features") or {}).items()}
                    ids = {t: np.asarray(v, dtype=object)
                           for t, v in (req.get("ids") or {}).items()}
                    if req.get("labels") is None:
                        return self._reply(400, {"error": "labels required"})
                    # the span scope is what stamps the request id onto
                    # the buffered observations (updater.submit reads the
                    # thread-local context), carrying it into the delta's
                    # replication trace
                    with distributed.server_span("serve_request",
                                                 self.headers,
                                                 path=self.path):
                        out = service.feedback(
                            feats, ids,
                            np.asarray(req["labels"], np.float64),
                            weights=req.get("weights"),
                            offsets=req.get("offsets"),
                            event_ids=req.get("event_ids"))
                    out["version_vector"] = service.version_vector()
                    self._reply(202, out)
                elif self.path == "/flight/dump":
                    # the front's fleet-wide postmortem fan-out (or an
                    # operator asking for the window by hand)
                    bundle = flight.trigger(
                        req.get("reason") or "replica.unhealthy",  # photonlint: disable=PH008 -- forwards the broadcaster's already-validated reason (trigger() re-validates at runtime)
                        trigger_id=req.get("trigger_id"),
                        **{k: str(v)
                           for k, v in (req.get("attrs") or {}).items()})
                    self._reply(200, {"bundle": bundle,
                                      "armed": flight.armed()})
                elif self.path == "/swap":
                    if follower:
                        return self._reply(403, {
                            "error": "this is a follower replica: swap "
                                     "on the publisher (it replicates "
                                     "through the log)"})
                    if not req.get("model_dir"):
                        return self._reply(400,
                                           {"error": "model_dir required"})
                    v = service.swap(req["model_dir"], req.get("version"))
                    self._reply(200, {"version": v})
                elif self.path == "/rollback":
                    if follower:
                        return self._reply(403, {
                            "error": "this is a follower replica: roll "
                                     "back on the publisher (it "
                                     "replicates through the log)"})
                    self._reply(200, {"version": service.rollback()})
                elif self.path == "/fleet/drain" and replica is not None:
                    self._reply(200, replica.drain())
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Overloaded as e:
                headers = None
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    # integer delta-seconds per RFC 9110; derived from
                    # the updater's observed feedback drain rate
                    headers = {"Retry-After":
                               str(max(1, int(round(retry_after))))}
                    self._reply(429, {"error": str(e),
                                      "retry_after_s":
                                          round(retry_after, 3)},
                                headers)
                else:
                    self._reply(429, {"error": str(e)})
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e)})
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def _make_front_server(front, host: str, port: int):
    """The routing front's HTTP server: /score + /predict fan out over
    ready replicas, model-state routes proxy to the publisher, fleet
    introspection aggregates the replicas."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from photon_ml_tpu_torch.fleet import NoReadyReplica
    from photon_ml_tpu_torch.serving import Overloaded
    from photon_ml_tpu_torch.telemetry import distributed, flight

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            pass

        def _reply(self, code: int, payload: dict, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, body: str, content_type: str):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/metrics":
                # the FEDERATED exposition: the front's own registry plus
                # every reachable replica's, per-instance labels, plus
                # the probe-derived per-replica replication lag
                self._reply_text(
                    200, front.federated_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics/front":
                # the front's own registry alone (the parity-contract
                # surface; scrape this to exclude replica fan-out cost)
                self._reply_text(
                    200, front.prometheus_metrics(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                self._reply(200, front.federated_snapshot())
            elif self.path == "/healthz":
                status = front.status()
                # sharded fleets: the front is healthy only while EVERY
                # shard has a healthy replica — a dark shard means part
                # of the entity space cannot be scored exactly, and a
                # stock load balancer should see that without parsing
                shards_down = (status.get("shards") or {}).get(
                    "shards_down") or []
                ok = status["ready_replicas"] > 0 and not shards_down
                status["status"] = "ok" if ok else "degraded"
                status["telemetry"] = distributed.clock_info()
                self._reply(200 if ok else 503, status)
            elif self.path == "/fleet/audit":
                self._reply(200, front.audit())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                req = self._body()
            except ValueError as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path in ("/score", "/predict"):
                    timeout = req.get("timeout_ms")
                    timeout = None if timeout is None else timeout / 1e3
                    # adopt the client's trace context (if any) so
                    # front.route()'s span carries the caller's id
                    distributed.set_context(
                        self.headers.get(distributed.TRACE_HEADER),
                        self.headers.get(distributed.PARENT_HEADER))
                    try:
                        status, payload = front.route(self.path, req,
                                                      timeout=timeout)
                    finally:
                        distributed.set_context(None, None)
                    self._reply(status, payload)
                elif self.path in ("/feedback", "/swap", "/rollback"):
                    distributed.set_context(
                        self.headers.get(distributed.TRACE_HEADER),
                        self.headers.get(distributed.PARENT_HEADER))
                    try:
                        status, payload, headers = front.route_publisher(
                            "POST", self.path, req)
                    finally:
                        distributed.set_context(None, None)
                    self._reply(status, payload, headers)
                elif self.path == "/flight/dump":
                    bundle = flight.trigger(
                        req.get("reason") or "replica.unhealthy",  # photonlint: disable=PH008 -- forwards the broadcaster's already-validated reason (trigger() re-validates at runtime)
                        trigger_id=req.get("trigger_id"),
                        **{k: str(v)
                           for k, v in (req.get("attrs") or {}).items()})
                    self._reply(200, {"bundle": bundle,
                                      "armed": flight.armed()})
                elif self.path == "/fleet/drain":
                    if not req.get("replica"):
                        return self._reply(
                            400, {"error": "replica URL required"})
                    self._reply(200, front.drain(req["replica"]))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Overloaded as e:
                self._reply(429, {"error": str(e)})
            except NoReadyReplica as e:
                self._reply(503, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def _serve_with_graceful_drain(httpd, poll_interval: float = 0.1):
    """Run the HTTP loop until SIGTERM/SIGINT requests a graceful drain
    (or the server dies).  Returns (drained, aborted): on drain the
    server has STOPPED ACCEPTING and in-flight handlers have finished; a
    second signal aborts immediately (aborted=True — skip the flush)."""
    from photon_ml_tpu_torch.utils import faults

    worker = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": poll_interval},
                              daemon=True, name="photon-serve-http")
    drained = aborted = False
    with faults.GracefulPreemption():
        worker.start()
        try:
            while worker.is_alive():
                if faults.preemption_requested():
                    drained = True
                    break
                time.sleep(poll_interval)
        except KeyboardInterrupt:  # second signal: the operator means it
            drained, aborted = True, True
    # stop accepting; ThreadingHTTPServer.shutdown returns after the
    # serve loop exits, and in-flight handler threads complete their
    # responses before the process moves on to flushing state
    httpd.shutdown()
    worker.join(timeout=10.0)
    return drained, aborted


def _run_front(args) -> int:
    from photon_ml_tpu_torch.fleet import Front, FrontConfig
    from photon_ml_tpu_torch.telemetry import flight
    front = Front(
        args.replica_url, publisher_url=args.publisher_url,
        config=FrontConfig(
            probe_interval_s=args.probe_interval_ms / 1e3,
            hedge_after_s=args.hedge_ms / 1e3,
            request_timeout_s=args.front_timeout_ms / 1e3,
            max_inflight=args.max_inflight,
            degraded_policy=args.degraded_policy))
    front.probe_once()  # populate readiness before the first request
    httpd = _make_front_server(front, args.host, args.port)
    print(json.dumps({
        "serving": f"http://{args.host}:{httpd.server_address[1]}",
        "mode": "front",
        "replicas": args.replica_url,
        "publisher": args.publisher_url or args.replica_url[0],
        "degraded_policy": args.degraded_policy,
        "endpoints": ["/score", "/predict", "/feedback", "/metrics",
                      "/metrics/front", "/metrics.json", "/swap",
                      "/rollback", "/healthz", "/fleet/audit",
                      "/fleet/drain", "/flight/dump"],
    }), flush=True)
    try:
        drained, aborted = _serve_with_graceful_drain(httpd)
    finally:
        httpd.server_close()
        front.close()
    if drained:
        flight.trigger("serve.drain", mode="front", aborted=aborted)
        print(json.dumps({"drained": True, "aborted": aborted,
                          "mode": "front"}), flush=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.front:
        if not args.replica_url:
            raise SystemExit("--front requires at least one --replica-url")
    else:
        if not args.model_dir:
            raise SystemExit(
                "--model-dir is required (except in --front mode)")
        if args.replica and not (args.replication_log
                                 and args.replica_state):
            raise SystemExit("--replica requires --replication-log and "
                             "--replica-state")
        if args.enable_updates and args.replica and not args.publish:
            raise SystemExit("a follower replica cannot run the online "
                             "updater (--enable-updates needs --publish): "
                             "model state enters the fleet through the "
                             "replication log")
        if args.shard and args.publish:
            raise SystemExit("the publisher stays unsharded (it holds "
                             "the full model); declare the fleet's "
                             "partition with --shard-count instead")
        if args.shard and args.enable_updates:
            raise SystemExit("a sharded replica cannot run the online "
                             "updater: deltas are solved on the "
                             "publisher and replicate shard-filtered")
        if args.shard_count is not None and not args.publish:
            raise SystemExit("--shard-count is the publisher's flag "
                             "(--replica --publish); shard replicas "
                             "take --shard K/N")
    device = None
    if not args.front:
        from photon_ml_tpu_torch.cli.train import resolve_cli_device
        device = resolve_cli_device(args.device)
    _arm_observability(args, proc_label(args))
    from photon_ml_tpu_torch.telemetry import flight
    try:
        if args.front:
            return _run_front(args)
        return _run_serve(args, device)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:
        # the process is dying on an unhandled error: the ring holds the
        # window that led here — get it on disk before the stack unwinds
        flight.trigger("serve.crash", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        _export_observability(args)


def _run_serve(args, device) -> int:
    from photon_ml_tpu_torch.telemetry import flight
    t0 = time.perf_counter()
    service = _build_service(args, device)
    load_s = time.perf_counter() - t0
    if args.burst:
        try:
            result = run_burst(service, args.burst, args.request_rows,
                               args.threads, args.output)
        finally:
            service.close()
        result["model_load_s"] = round(load_s, 3)
        result["device"] = str(service.device)
        print(json.dumps(result))
        return 1 if result["failed_requests"] else 0

    replica = publisher = None
    join_info = None
    if args.replica:
        from photon_ml_tpu_torch.fleet import (FleetPublisher, Replica,
                                         ReplicaConfig, ReplicationLog)
        log = ReplicationLog(args.replication_log)
        if args.publish:
            shard_spec = None
            if args.shard_count is not None:
                from photon_ml_tpu_torch.fleet import ShardSpec
                shard_spec = ShardSpec(num_shards=args.shard_count,
                                       salt=args.shard_salt,
                                       version=args.shard_spec_version)
            publisher = FleetPublisher(service, log,
                                       model_dir=args.model_dir,
                                       shard_spec=shard_spec)
            if service.updater is not None:
                # started HERE, after the publish hook attached: no delta
                # may ever land unreplicated
                service.updater.start()
        else:
            replica = Replica(
                service, log, args.replica_state,
                ReplicaConfig(poll_interval_s=args.replica_poll_ms / 1e3))
            join_info = replica.join()
            replica.start()

    httpd = _make_http_server(service, args.host, args.port,
                              replica=replica, publisher=publisher)
    _install_metrics_hooks(service, args.metrics_interval)
    print(json.dumps({
        "serving": f"http://{args.host}:{httpd.server_address[1]}",
        "mode": ("publisher" if publisher is not None else
                 "replica" if replica is not None else "standalone"),
        "model_dir": args.model_dir,
        "model_version": service.model_version,
        "model_load_s": round(load_s, 3),
        "buckets": service.registry.scorer.bucket_sizes(),
        "device": str(service.device),
        "updates_enabled": service.updater is not None,
        "health_enabled": service.health is not None,
        "shard": service.registry.scorer.shard_info(),
        "shard_count_published": args.shard_count,
        "join": join_info,
        "endpoints": ["/score", "/predict", "/margins", "/feedback",
                      "/metrics", "/metrics.json", "/swap", "/rollback",
                      "/healthz", "/flight/dump"]
        + (["/fleet/audit", "/fleet/drain"] if args.replica else []),
    }), flush=True)
    try:
        drained, aborted = _serve_with_graceful_drain(httpd)
    finally:
        httpd.server_close()
    if drained:
        # dump the flight ring BEFORE the flush/close teardown mutates
        # state — the drain window is part of the postmortem trail
        flight.trigger("serve.drain", mode=proc_label(args),
                       aborted=aborted)
    flushed = None
    if drained and not aborted and service.updater is not None \
            and not service.updater.paused:
        # the drain contract: everything the intake admitted either
        # publishes (and replicates) or is accounted before exit
        flushed = service.updater.flush()
    if replica is not None:
        replica.close()
    service.close()
    _dump_metrics(service)
    if drained:
        print(json.dumps({
            "drained": True, "aborted": aborted,
            "feedback_flushed": flushed,
            "version_vector": service.version_vector()}), flush=True)
    return 0


def proc_label(args) -> str:
    return ("front" if args.front else
            "publisher" if args.replica and args.publish else
            "replica" if args.replica else "serve")


if __name__ == "__main__":
    raise SystemExit(main())
