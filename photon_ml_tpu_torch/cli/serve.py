"""Online scoring service CLI (port of photon_ml_tpu/cli/serve.py, single
process), on one CUDA device unless `--device cpu` is given; `--x64`
serves in float64.

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
                                              (0.0.4)
  GET  /metrics.json                       -> ServingMetrics JSON snapshot
  POST /swap     {"model_dir": "..."}      -> zero-downtime hot swap
  POST /rollback                           -> delta-aware: pending delta
                                              swaps revert to exact
                                              pre-delta rows, else the
                                              previous full model
  GET  /healthz                            -> status + version vector
                                              + updater vitals (thread
                                              liveness, last-cycle age,
                                              frozen entities, pending
                                              rows) (+ the tiered store's
                                              hit rate)
  GET  /fleet/audit                        -> version vector + per-table
                                              sha256
  POST /flight/dump                        -> a flight-recorder bundle

  429 = Overloaded (queue full; POST /feedback rejections carry a
  Retry-After header derived from the online updater's observed drain
  rate), 504 = DeadlineExceeded, 400 = bad request.  SIGUSR1 dumps a
  metrics snapshot to stderr; --metrics-interval dumps one periodically.
  POST /margins answers 501: the sharded fan-out it serves belongs to the
  fleet (ROADMAP.md queue A item 22), and so do the fleet flags in
  UNPORTED_FLAGS, which exit, as does --health-config (item 22, health).

Graceful drain: SIGTERM/SIGINT stops accepting new requests, finishes the
in-flight micro-batches, flushes the FeedbackBuffer through the online
updater (when updates are enabled), closes everything cleanly, prints a
final {"drained": true, ...} line and exits 0.  A second signal aborts
immediately (utils.faults.GracefulPreemption semantics).

--trace-out / --run-log arm the span tracer with export on exit (the
SIGTERM drain path included); --flight-dir makes the always-armed flight
recorder's dump-on-anomaly bundles durable.

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

_HEALTH = "not ported yet (ROADMAP.md queue A item 22, health)"
_FLEET = "not ported yet (ROADMAP.md queue A item 22, the fleet)"

# flag -> (is it set, the ROADMAP.md queue A item that ports it; the
# health monitor and the fleet are its two remaining slices)
UNPORTED_FLAGS = (
    ("--health-config", lambda a: a.health_config is not None, "22, health"),
    ("--replica", lambda a: a.replica, "22, the fleet"),
    ("--publish", lambda a: a.publish, "22, the fleet"),
    ("--front", lambda a: a.front, "22, the fleet"),
    ("--shard", lambda a: a.shard is not None, "22, the fleet"),
    ("--shard-count", lambda a: a.shard_count is not None, "22, the fleet"),
)
# POST routes of the JAX CLI whose subsystems are not ported
UNPORTED_ROUTES = {"/margins": ("the sharded fan-out", _FLEET)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-serve")
    p.add_argument("--model-dir", default=None,
                   help="GAME model directory (any layout models/io.py "
                        "reads)")
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
    # -- the online learning tier --------------------------------------------
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
    # -- the JAX CLI's health/fleet modes: they exit -----------------------
    p.add_argument("--health-config", default=None, metavar="JSON",
                   help=_HEALTH)
    p.add_argument("--replica", action="store_true", help=_FLEET)
    p.add_argument("--publish", action="store_true", help=_FLEET)
    p.add_argument("--front", action="store_true", help=_FLEET)
    p.add_argument("--shard", default=None, metavar="K/N", help=_FLEET)
    p.add_argument("--shard-count", type=int, default=None, metavar="N",
                   help=_FLEET)
    # -- observability (telemetry + telemetry/flight) -----------------------
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="arm the telemetry span tracer and write a Chrome-"
                        "trace timeline at exit (cli.train parity; also on "
                        "the SIGTERM drain path)")
    p.add_argument("--run-log", default=None, metavar="RUN.jsonl",
                   help="stream span/event records as JSONL while "
                        "serving; arms the tracer like --trace-out.  The "
                        "per-process run logs are what `python -m "
                        "photon_ml_tpu_torch.cli.trace merge` stitches into "
                        "one timeline")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="durable flight-recorder bundle directory: the "
                        "always-on ring of recent spans/events/log lines "
                        "dumps here on rollbacks, SIGTERM drain and crashes "
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
                        "CUDA the run exits non-zero unless --device cpu)")
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
    return ScoringService(model_dir=args.model_dir, config=cfg,
                          emitter=emitter, updates=updates)


def _dump_metrics(service, stream=sys.stderr):
    print(json.dumps(service.metrics_snapshot()), file=stream, flush=True)


def _arm_observability(args, proc: str) -> None:
    """cli.train wiring parity: --trace-out / --run-log arm the span tracer
    (run logs are what `cli.trace merge` stitches); the flight recorder is
    ALWAYS armed — the ring stays in memory until --flight-dir makes its
    dumps durable."""
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

def _make_http_server(service, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    from photon_ml_tpu_torch.serving import DeadlineExceeded, Overloaded
    from photon_ml_tpu_torch.telemetry import distributed, flight

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
                # JSON snapshot is at /metrics.json
                self._reply_text(
                    200, service.prometheus_metrics(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/metrics.json":
                self._reply(200, service.metrics_snapshot())
            elif self.path == "/healthz":
                payload = service.healthz()
                # every probe is also a clock probe (pid, wall_s): what
                # aligns merged run-log timelines
                payload["telemetry"] = distributed.clock_info()
                self._reply(200 if payload["status"] == "ok" else 503,
                            payload)
            elif self.path.split("?", 1)[0] == "/fleet/audit":
                self._reply(200, service.audit())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                req = self._body()
            except ValueError as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path in ("/score", "/predict"):
                    # the server half of a propagated hop: adopts the
                    # caller's X-Photon-Trace/-Parent headers (minting an
                    # id for direct traffic)
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
                elif self.path == "/feedback":
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
                elif self.path in UNPORTED_ROUTES:
                    what, why = UNPORTED_ROUTES[self.path]
                    self._reply(501, {"error": f"POST {self.path} ({what}) "
                                      f"is {why}"})
                elif self.path == "/flight/dump":
                    # an operator asking for the recent window by hand
                    bundle = flight.trigger(
                        req.get("reason") or "replica.unhealthy",
                        trigger_id=req.get("trigger_id"),
                        **{k: str(v)
                           for k, v in (req.get("attrs") or {}).items()})
                    self._reply(200, {"bundle": bundle,
                                      "armed": flight.armed()})
                elif self.path == "/swap":
                    if not req.get("model_dir"):
                        return self._reply(400,
                                           {"error": "model_dir required"})
                    v = service.swap(req["model_dir"], req.get("version"))
                    self._reply(200, {"version": v})
                elif self.path == "/rollback":
                    self._reply(200, {"version": service.rollback()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Overloaded as e:
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    # integer delta-seconds per RFC 9110; derived from
                    # the updater's observed feedback drain rate
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": round(retry_after, 3)},
                                {"Retry-After":
                                 str(max(1, int(round(retry_after))))})
                else:
                    self._reply(429, {"error": str(e)})
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e)})
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def _serve_with_graceful_drain(httpd, poll_interval: float = 0.1):
    """Run the HTTP loop until SIGTERM/SIGINT requests a graceful drain
    (or the server dies).  Returns (drained, aborted): on drain the
    server has STOPPED ACCEPTING and in-flight handlers have finished; a
    second signal aborts immediately (aborted=True)."""
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
    # responses before the process moves on to closing state
    httpd.shutdown()
    worker.join(timeout=10.0)
    return drained, aborted


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from photon_ml_tpu_torch.cli.train import check_unported, resolve_cli_device
    check_unported(args, UNPORTED_FLAGS, ())
    if not args.model_dir:
        raise SystemExit("--model-dir is required")
    device = resolve_cli_device(args.device)
    _arm_observability(args, "serve")
    from photon_ml_tpu_torch.telemetry import flight
    try:
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

    httpd = _make_http_server(service, args.host, args.port)
    _install_metrics_hooks(service, args.metrics_interval)
    print(json.dumps({
        "serving": f"http://{args.host}:{httpd.server_address[1]}",
        "mode": "standalone",
        "model_dir": args.model_dir,
        "model_version": service.model_version,
        "model_load_s": round(load_s, 3),
        "device": str(service.device),
        "buckets": service.registry.scorer.bucket_sizes(),
        "updates_enabled": service.updater is not None,
        "health_enabled": False,
        "endpoints": ["/score", "/predict", "/feedback", "/metrics",
                      "/metrics.json", "/swap", "/rollback", "/healthz",
                      "/fleet/audit", "/flight/dump"],
    }), flush=True)
    try:
        drained, aborted = _serve_with_graceful_drain(httpd)
    finally:
        httpd.server_close()
    if drained:
        # dump the flight ring BEFORE the close teardown mutates state —
        # the drain window is part of the postmortem trail
        flight.trigger("serve.drain", mode="serve", aborted=aborted)
    flushed = None
    if drained and not aborted and service.updater is not None \
            and not service.updater.paused:
        # the drain contract: everything the intake admitted either
        # publishes or is accounted before exit
        flushed = service.updater.flush()
    service.close()
    _dump_metrics(service)
    if drained:
        print(json.dumps({
            "drained": True, "aborted": aborted,
            "feedback_flushed": flushed,
            "version_vector": service.version_vector()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
