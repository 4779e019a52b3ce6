"""Failover front: routes scoring traffic across N replica processes (a
copy of photon_ml_tpu/fleet/front.py: host-only, it imports torch but
touches no device).

The front is model-free — it never loads a scorer.  It holds a handle per
replica URL (the serve HTTP protocol IS the replica protocol) and:

  * PROBES   a background thread GETs each replica's /healthz every
             `probe_interval_s`; an un-ready replica (503: joining,
             draining, failed, health-gate degraded: the health monitor's verdicts)
             leaves the rotation after `unhealthy_after` consecutive
             failures and re-enters after `healthy_after` successes.
             Probe payloads also carry each replica's applied seq, which
             feeds the `fleet.front_max_lag_seq` gauge.
  * ROUTES   /score and /predict round-robin over READY replicas;
             transport errors and 5xx responses fail over to the next
             replica (bounded by `max_attempts`, counted per failover);
             POST /feedback, /swap and /rollback go to the PUBLISHER
             replica only — model state changes enter the fleet through
             the replication log, never through a follower.
  * HEDGES   a scoring attempt still pending after `hedge_after_s` fires
             a duplicate at a different ready replica; first response
             wins, the loser is abandoned (bounded tail latency without
             giving up on the slow replica's in-flight work).
  * SHEDS    beyond `max_inflight` concurrently routed requests the
             front degrades to Overloaded (HTTP 429) instead of queueing
             without bound — queue collapse upstream of the replicas is
             strictly worse than explicit backpressure.
  * DRAINS   `drain(url)` stops routing to a replica, tells it to drain
             (its own /healthz flips 503 for any other front), waits for
             in-flight requests to finish, then detaches it.
  * SHARDS   when probed replicas declare entity-shard ownership
             (serve --shard K/N), scoring fans out as per-shard /margins
             legs — each leg hedged and failed over WITHIN its shard
             group — and the front re-folds the per-coordinate margins
             bit-identically to a monolithic replica
             (fleet/shards.merge_margins).  A shard with zero healthy
             replicas degrades ONLY requests touching its entities:
             `degraded_policy="partial"` folds the lost contributions as
             exactly 0.0 and stamps the response degraded,
             `"error"` fails those requests 503.  Losing a shard's last
             replica fires the shard.lost flight trigger fleet-wide.

The front's routing metrics live on its OWN MetricsRegistry (the
ServingMetrics fleet.* family is the replica-side surface): request /
failover / hedge / retry / shed counters plus ready-replica and lag
gauges, exposed as Prometheus text at the front's /metrics.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from http.client import HTTPConnection
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import distributed, flight
from photon_ml_tpu_torch.telemetry.export import prometheus_text
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry
from photon_ml_tpu_torch.fleet.replog import decode_array
from photon_ml_tpu_torch.fleet.shards import (ShardMergeError, ShardSpec,
                                        merge_margins, shards_touched)
from photon_ml_tpu_torch.serving.batcher import Overloaded, ServingError
from photon_ml_tpu_torch.utils import faults, locktrace

import dataclasses
import logging
import re
import time

logger = logging.getLogger("photon_ml_tpu")


#: the front's metric-surface parity CONTRACT (the ServingMetrics
#: SNAPSHOT_PATHS discipline): every instrument the constructor registers
#: must appear here, every path must resolve in `front_snapshot()`, and
#: tests/port/test_torch_fleet.py diffs all three sets against the Prometheus
#: exposition — a front metric cannot land on one surface only.
FRONT_SNAPSHOT_PATHS = {
    "fleet.front_requests": ("requests",),
    "fleet.front_failovers": ("failovers",),
    "fleet.front_hedges": ("hedges",),
    "fleet.front_hedge_wins": ("hedge_wins",),
    "fleet.front_retries": ("retries",),
    "fleet.front_shed": ("shed",),
    "fleet.front_errors": ("errors",),
    "fleet.front_probe_failures": ("probe_failures",),
    "fleet.front_scrape_failures": ("scrape_failures",),
    "fleet.front_ready_replicas": ("ready_replicas",),
    "fleet.front_max_lag_seq": ("max_lag_seq",),
    "front.requests": ("requests_by_replica",),
    "fleet.shard_requests": ("shard_requests",),
    "fleet.shard_coverage": ("shard_coverage",),
    "fleet.shard_degraded": ("shard_degraded",),
}


class NoReadyReplica(ServingError):
    """Every replica is out of rotation (joining, draining, failed, or
    unreachable) — the front cannot place the request."""


@dataclasses.dataclass(frozen=True)
class FrontConfig:
    """Routing knobs (cli.serve --front maps 1:1)."""

    probe_interval_s: float = 0.25  # /healthz probe period per replica
    probe_timeout_s: float = 2.0
    unhealthy_after: int = 2        # consecutive probe failures -> out
    healthy_after: int = 1          # consecutive successes -> back in
    request_timeout_s: float = 10.0
    hedge_after_s: float = 0.25     # pending this long -> hedge a twin
    max_attempts: int = 3           # total sends per request (incl. hedges)
    max_inflight: int = 256         # routed concurrently before shedding
    # entity-sharded fleets: what a scoring request gets when a shard it
    # touches has NO healthy replica.  "partial": the lost shard's
    # random-effect contributions fold as exactly 0.0 (the unseen-entity
    # default) and the response is stamped degraded=true with the
    # affected rows; "error": the request fails 503 — correctness over
    # availability
    degraded_policy: str = "partial"


class ReplicaHandle:
    """One replica's routing state (all fields guarded by Front._lock)."""

    def __init__(self, url: str, publisher: bool = False):
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 80
        self.publisher = publisher
        self.ready = False
        self.fails = 0
        self.successes = 0
        self.draining = False
        self.detached = False
        self.inflight = 0
        self.applied_seq: Optional[int] = None
        self.last_error: Optional[str] = None
        # which entity shard this replica owns — learned from its probed
        # /healthz payload, never from static config (None: full model)
        self.shard: Optional[int] = None

    def state(self) -> Dict[str, object]:
        return {"url": self.url, "publisher": self.publisher,
                "ready": self.ready, "draining": self.draining,
                "detached": self.detached, "inflight": self.inflight,
                "applied_seq": self.applied_seq, "shard": self.shard,
                "last_error": self.last_error}


class Front:
    def __init__(self, replica_urls: List[str],
                 publisher_url: Optional[str] = None,
                 config: FrontConfig = FrontConfig(),
                 start_probes: bool = True):
        """`publisher_url` names the replica that accepts model-state
        changes (/feedback, /swap, /rollback); defaults to the first URL.
        `start_probes=False` keeps probing manual (`probe_once()`) for
        tests and the bench."""
        if not replica_urls:
            raise ValueError("a front needs at least one replica URL")
        if config.degraded_policy not in ("partial", "error"):
            raise ValueError(f"unknown degraded_policy "
                             f"{config.degraded_policy!r} "
                             "(choose 'partial' or 'error')")
        self.config = config
        self._lock = locktrace.tracked(threading.Lock(), "Front._lock")
        publisher_url = (publisher_url or replica_urls[0]).rstrip("/")
        self._handles = [ReplicaHandle(u, publisher=(u.rstrip("/") ==
                                                     publisher_url))
                         for u in replica_urls]
        self._rr = 0  # photonlint: guarded-by=_lock
        self._inflight_total = 0  # photonlint: guarded-by=_lock
        self.registry = MetricsRegistry()
        r = self.registry
        self._m_requests = r.counter("fleet.front_requests")
        self._m_failovers = r.counter("fleet.front_failovers")
        self._m_hedges = r.counter("fleet.front_hedges")
        self._m_hedge_wins = r.counter("fleet.front_hedge_wins")
        self._m_retries = r.counter("fleet.front_retries")
        self._m_shed = r.counter("fleet.front_shed")
        self._m_errors = r.counter("fleet.front_errors")
        self._m_probe_failures = r.counter("fleet.front_probe_failures")
        self._m_scrape_failures = r.counter("fleet.front_scrape_failures")
        self._m_ready = r.gauge("fleet.front_ready_replicas")
        self._m_max_lag = r.gauge("fleet.front_max_lag_seq")
        # per-(replica, outcome) routing visibility: which replica served,
        # failed over, shed, or was abandoned as a hedge loser
        self._m_by_replica = r.labeled_counter("front.requests",
                                               ("replica", "outcome"))
        # entity-sharded fleets: per-(shard, outcome) leg accounting, the
        # minimum per-shard healthy-replica count (-1: fleet unsharded;
        # 0: some shard is DARK — alert on this), and requests answered
        # degraded because a touched shard was dark
        self._m_shard_requests = r.labeled_counter("fleet.shard_requests",
                                                   ("shard", "outcome"))
        self._m_shard_coverage = r.gauge("fleet.shard_coverage")
        self._m_shard_coverage.set(-1.0)
        self._m_shard_degraded = r.counter("fleet.shard_degraded")
        # the fleet partition, adopted from probed replicas (highest spec
        # version wins; replicas on another spec_id leave rotation), and
        # the coordinate fold order cached off the last merged response
        self._shard_spec: Optional[ShardSpec] = None  # photonlint: guarded-by=_lock
        self._coord_meta: Optional[List[dict]] = None  # photonlint: guarded-by=_lock
        self._lost_shards: set = set()  # photonlint: guarded-by=_lock
        self._seen_shards: set = set()  # photonlint: guarded-by=_lock
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, min(config.max_inflight, 64)),
            thread_name_prefix="photon-front")
        # shard-leg coordinators get their OWN small pool: a leg blocks
        # waiting on sends it submits to _pool, so running coordinators
        # there too could deadlock the pool against itself under load
        self._leg_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="photon-front-shard")
        self._closed = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None  # photonlint: guarded-by=_lock
        if start_probes:
            self.start_probes()

    # -- probing -------------------------------------------------------------

    def probe_once(self) -> Dict[str, bool]:
        """Probe every attached replica once; returns {url: ready}."""
        cfg = self.config
        results: Dict[str, bool] = {}
        with self._lock:
            handles = [h for h in self._handles if not h.detached]
        for h in handles:
            ok, payload = False, None
            t_send = time.time()
            try:
                status, body = self._send(h, "GET", "/healthz", None,
                                          cfg.probe_timeout_s)
                t_recv = time.time()
                payload = json.loads(body) if body else {}
                ok = status == 200
                err = None if ok else f"healthz {status}"
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
            if ok:
                # entity-sharded fleets: the replica's /healthz declares
                # which shard it owns; a replica on an incompatible
                # partition is treated as UNHEALTHY (routing margins from
                # a different partition would merge wrong rows)
                shard_err = self._note_shard_payload(payload)
                if shard_err is not None:
                    ok, err = False, shard_err
            # every health probe doubles as an NTP-style clock probe: the
            # replica's /healthz carries its wall clock, and the minimum-
            # RTT offset estimate is what `cli.trace merge` aligns the
            # per-process timelines with
            remote_clock = (payload or {}).get("telemetry") or {}
            if remote_clock.get("wall_s") is not None:
                telemetry.event(
                    "clock_probe", url=h.url,
                    pid=int(remote_clock.get("pid", 0)),
                    proc=str(remote_clock.get("proc", "proc")),
                    offset_s=round(float(remote_clock["wall_s"])
                                   - (t_send + t_recv) / 2.0, 6),
                    rtt_s=round(t_recv - t_send, 6))
            with self._lock:
                was_ready = h.ready
                if ok:
                    h.successes += 1
                    h.fails = 0
                    if h.successes >= cfg.healthy_after:
                        h.ready = not h.draining
                    h.last_error = None
                    fleet = (payload or {}).get("fleet") or {}
                    if fleet.get("applied_seq") is not None:
                        h.applied_seq = int(fleet["applied_seq"])
                    sh = (payload or {}).get("shard")
                    h.shard = int(sh["index"]) if sh else None
                else:
                    h.fails += 1
                    h.successes = 0
                    h.last_error = err
                    if h.fails >= cfg.unhealthy_after:
                        h.ready = False
                now_ready = h.ready
                results[h.url] = now_ready
            if not ok:
                self._m_probe_failures.inc()
            if was_ready != now_ready:
                telemetry.event("front_replica_health", url=h.url,
                                ready=str(now_ready), error=str(err))
                logger.warning("front: replica %s -> %s%s", h.url,
                               "READY" if now_ready else "OUT",
                               f" ({err})" if err else "")
                if not now_ready:
                    # a replica just left rotation (crash, health gate,
                    # drain elsewhere): capture the window fleet-wide —
                    # dump the front's own ring and fan the SAME trigger
                    # id out so every live process's bundle correlates
                    self._flight_fleet_dump("replica.unhealthy",
                                            url=h.url, error=str(err))
        self._refresh_gauges()
        self._check_lost_shards()
        return results

    def _note_shard_payload(self, payload) -> Optional[str]:
        """Validate/adopt a probed replica's shard spec.  The newest
        spec VERSION wins fleet-wide (a rebalance rolls out by bumping
        it); a replica whose spec_id disagrees with the adopted
        partition gets an error string back — the probe counts it as a
        failed probe, so it leaves rotation instead of merging margins
        from a different partition."""
        info = (payload or {}).get("shard")
        if info is None:
            return None
        try:
            spec = ShardSpec.from_dict(info)
        except (ValueError, KeyError, TypeError) as e:
            return f"unusable shard spec in /healthz: {e}"
        with self._lock:
            cur = self._shard_spec
            if cur is None or spec.version > cur.version:
                self._shard_spec = cur = spec
        if spec.spec_id() != cur.spec_id():
            return (f"shard spec {spec.spec_id()!r} (v{spec.version}) "
                    f"does not match the fleet partition "
                    f"{cur.spec_id()!r} (v{cur.version})")
        return None

    def shard_coverage(self) -> Optional[Dict[int, int]]:
        """Healthy replicas per shard index (None: fleet unsharded).
        A zero anywhere means that slice of the entity space is DARK —
        scoring degrades per FrontConfig.degraded_policy."""
        with self._lock:
            spec = self._shard_spec
            if spec is None:
                return None
            cov = {k: 0 for k in range(spec.num_shards)}
            for h in self._handles:
                if h.ready and not h.detached and h.shard is not None \
                        and h.shard in cov:
                    cov[h.shard] += 1
        return cov

    def _check_lost_shards(self) -> None:
        """Fire the shard.lost flight trigger on the transition of a
        shard's LAST healthy replica leaving rotation (only for shards
        that had coverage before — startup catch-up is not a loss)."""
        cov = self.shard_coverage()
        if cov is None:
            return
        with self._lock:
            for k, n in cov.items():
                if n > 0:
                    self._seen_shards.add(k)
            lost = {k for k, n in cov.items() if n == 0} & self._seen_shards
            fresh = lost - self._lost_shards
            recovered = self._lost_shards - lost
            self._lost_shards = lost
        for k in sorted(recovered):
            telemetry.event("front_shard_recovered", shard=str(k))
            logger.warning("front: shard %d has healthy replicas again",
                           k)
        for k in sorted(fresh):
            logger.error(
                "front: shard %d LOST its last healthy replica — "
                "requests touching its entities now %s", k,
                "degrade to partial scores"
                if self.config.degraded_policy == "partial"
                else "fail 503")
            self._flight_fleet_dump("shard.lost", shard=str(k))

    def _flight_fleet_dump(self, reason: str, **attrs) -> None:
        """Dump the front's flight ring and broadcast the trigger to
        every other attached, reachable replica (fire-and-forget on the
        pool: a postmortem capture must not block probing/routing)."""
        if not flight.armed():
            return
        trigger_id = flight.new_trigger_id(reason)
        flight.trigger(reason, trigger_id=trigger_id, **attrs)  # photonlint: disable=PH008 -- fans out a caller-validated registered reason
        body = json.dumps({"reason": reason, "trigger_id": trigger_id,
                           "attrs": {k: str(v) for k, v in attrs.items()}
                           }).encode()
        with self._lock:
            handles = [h for h in self._handles if not h.detached]
        for h in handles:
            self._pool.submit(self._flight_dump_one, h, body)

    def _flight_dump_one(self, h: "ReplicaHandle", body: bytes) -> None:
        try:
            self._send(h, "POST", "/flight/dump", body,
                       self.config.probe_timeout_s)
        except Exception:
            pass  # the crashed replica itself is expected to be gone

    def _refresh_gauges(self) -> None:
        with self._lock:
            ready = [h for h in self._handles
                     if h.ready and not h.detached]
            seqs = [h.applied_seq for h in self._handles
                    if not h.detached and h.applied_seq is not None]
        self._m_ready.set(len(ready))
        if seqs:
            self._m_max_lag.set(max(seqs) - min(seqs))
        cov = self.shard_coverage()
        if cov is not None:
            # the MIN healthy-replica count across shards: 0 here is the
            # alertable "part of the entity space is dark" signal
            self._m_shard_coverage.set(float(min(cov.values())))

    def start_probes(self) -> None:
        with self._lock:
            if self._probe_thread is not None:
                return
            thread = threading.Thread(target=self._probe_loop, daemon=True,
                                      name="photon-front-probe")
            self._probe_thread = thread
        thread.start()

    def _probe_loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.probe_once()
            except Exception as e:  # the probe loop must never die
                logger.exception("front probe cycle failed: %s", e)
            self._closed.wait(timeout=self.config.probe_interval_s)

    # -- transport -----------------------------------------------------------

    @staticmethod
    def _send(h: ReplicaHandle, method: str, path: str,
              body: Optional[bytes], timeout: float,
              extra_headers: Optional[Dict[str, str]] = None
              ) -> Tuple[int, bytes]:
        conn = HTTPConnection(h.host, h.port, timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if body is not None:
                headers["Content-Length"] = str(len(body))
            if extra_headers:
                headers.update(extra_headers)
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    # -- routing -------------------------------------------------------------

    def _pick(self, exclude=(), shard: Optional[int] = None
              ) -> Optional[ReplicaHandle]:
        """Round-robin over ready replicas; `shard=k` restricts the pick
        to replicas that declared ownership of shard k (which also keeps
        the unsharded publisher out of a sharded fleet's scoring
        rotation — it holds the full model but is not a leg)."""
        with self._lock:
            n = len(self._handles)
            for i in range(n):
                h = self._handles[(self._rr + i) % n]
                if h.ready and not h.draining and not h.detached \
                        and h.url not in exclude \
                        and (shard is None or h.shard == shard):
                    self._rr = (self._rr + i + 1) % n
                    h.inflight += 1
                    return h
        return None

    def _release(self, h: ReplicaHandle) -> None:
        with self._lock:
            h.inflight = max(h.inflight - 1, 0)

    def _mark_failure(self, h: ReplicaHandle, err: str) -> None:
        with self._lock:
            h.fails += 1
            h.successes = 0
            h.last_error = err
            if h.fails >= self.config.unhealthy_after:
                h.ready = False

    def route(self, path: str, payload: dict,
              timeout: Optional[float] = None) -> Tuple[int, dict]:
        """Route one scoring request (POST /score | /predict): bounded
        in-flight, failover across ready replicas, hedging on a slow
        attempt.  Returns (HTTP status, decoded payload)."""
        leaf = path.rstrip("/").rsplit("/", 1)[-1]
        if leaf in ("feedback", "swap", "rollback"):
            # model-state changes are NOT idempotent: a hedge or a blind
            # retry after an ambiguous timeout could apply the same
            # feedback batch or swap twice — those routes go through
            # route_publisher(), single attempt, no duplicates ever
            raise ValueError(
                f"{path!r} is a non-idempotent publisher route; the "
                "front never hedges or retries it — use "
                "route_publisher()")
        cfg = self.config
        with self._lock:
            if self._inflight_total >= cfg.max_inflight:
                shed = True
            else:
                shed = False
                self._inflight_total += 1
        if shed:
            self._m_shed.inc()
            raise Overloaded(
                f"front at capacity ({cfg.max_inflight} requests in "
                "flight); retry after the replicas drain")
        self._m_requests.inc()
        body = json.dumps(payload).encode()
        timeout = timeout if timeout is not None else cfg.request_timeout_s
        # ONE logical request = ONE trace: adopt the caller's propagated
        # request id (X-Photon-Trace via the HTTP front or an enclosing
        # server_span) or mint one; every attempt — failover or hedge —
        # carries the same id with this span as the remote parent, so the
        # merged timeline shows the request crossing processes
        request_id = (distributed.current_request_id()
                      or distributed.new_request_id())
        try:
            with distributed.server_span(
                    "front_request", None, request_id=request_id,
                    remote_parent=distributed.current_ref(),
                    path=path) as scope:
                trace_headers = distributed.outbound_headers(
                    scope.request_id, distributed.current_ref())
                with self._lock:
                    sharded = self._shard_spec is not None
                if sharded:
                    return self._route_sharded(path, payload, body,
                                               timeout, trace_headers)
                return self._route_attempts(path, body, timeout,
                                            trace_headers)
        finally:
            with self._lock:
                self._inflight_total -= 1

    def _route_attempts(self, path: str, body: bytes, timeout: float,
                        trace_headers: Optional[Dict[str, str]] = None,
                        shard: Optional[int] = None) -> Tuple[int, dict]:
        cfg = self.config
        tried: set = set()
        pending: Dict[object, ReplicaHandle] = {}
        is_hedge: Dict[object, bool] = {}
        sends = 0
        last_client_error: Optional[Tuple[int, dict]] = None

        def launch(hedge: bool = False) -> bool:
            nonlocal sends
            h = self._pick(exclude=tried, shard=shard)
            if h is None:
                return False
            tried.add(h.url)
            sends += 1
            fut = self._pool.submit(self._send, h, "POST", path, body,
                                    timeout, trace_headers)
            pending[fut] = h
            is_hedge[fut] = hedge
            return True

        def outcome(h: ReplicaHandle, kind: str) -> None:
            self._m_by_replica.inc(replica=h.url, outcome=kind)

        if not launch():
            self._m_errors.inc()
            raise NoReadyReplica(
                "no ready replica to route to (all joining, draining, "
                "failed, or unreachable)")
        hedged = False
        try:
            while pending:
                wait_s = (cfg.hedge_after_s
                          if not hedged and sends < cfg.max_attempts
                          else timeout + 1.0)
                done, _ = wait(list(pending), timeout=wait_s,
                               return_when=FIRST_COMPLETED)
                if not done:
                    # the attempt is slow, not dead: hedge a duplicate at
                    # a different replica, first response wins
                    hedged = True
                    if launch(hedge=True):
                        self._m_hedges.inc()
                        telemetry.event("front_hedged", path=path)
                    continue
                for fut in done:
                    h = pending.pop(fut)
                    self._release(h)
                    try:
                        status, raw = fut.result()
                    except Exception as e:
                        self._mark_failure(h, f"{type(e).__name__}: {e}")
                        self._m_failovers.inc()
                        outcome(h, "error")
                        continue
                    if status >= 500:
                        self._mark_failure(h, f"http {status}")
                        self._m_failovers.inc()
                        outcome(h, "5xx")
                        continue
                    try:
                        decoded = json.loads(raw) if raw else {}
                    except ValueError:
                        decoded = {"error": "undecodable replica response"}
                    if status == 429:
                        # replica backpressure: one chance elsewhere,
                        # else propagate the shed to the client
                        last_client_error = (status, decoded)
                        self._m_retries.inc()
                        outcome(h, "429")
                        continue
                    outcome(h, "ok")
                    if is_hedge.get(fut):
                        # the duplicate beat the original: the hedge
                        # bought this request its latency back
                        self._m_hedge_wins.inc()
                        telemetry.event("front_hedge_won", path=path,
                                        replica=h.url)
                    return status, decoded
                if not pending and sends < cfg.max_attempts:
                    if launch():
                        self._m_retries.inc()
                        continue
            if last_client_error is not None:
                return last_client_error
            self._m_errors.inc()
            raise NoReadyReplica(
                f"request failed on every reachable replica "
                f"({sends} attempt(s): {sorted(tried)})")
        finally:
            for fut, h in pending.items():
                # abandoned hedges: release accounting; the send itself
                # finishes (or times out) on the pool thread
                outcome(h, "abandoned")
                fut.add_done_callback(
                    lambda _f, _h=h: self._release(_h))

    # -- sharded fan-out -------------------------------------------------------

    def _route_leg(self, shard: int, body: bytes, timeout: float,
                   trace_headers: Optional[Dict[str, str]]
                   ) -> Tuple[int, dict]:
        """One shard group's leg of a fan-out request: POST /margins to
        that shard's replicas with the full hedged/failover discipline.
        Transient injected faults at shard.route retry here (bounded);
        a fatal one fails only this leg — the merge then applies the
        degradation policy, so the blast radius stays one shard."""
        last: Optional[Exception] = None
        for _ in range(self.config.max_attempts):
            try:
                faults.fire("shard.route", shard=str(shard))
            except Exception as e:
                if not faults.is_transient(e):
                    raise
                last = e
                self._m_retries.inc()
                continue
            return self._route_attempts("/margins", body, timeout,
                                        trace_headers, shard=shard)
        raise last  # every attempt was consumed by injected transients

    def _collect_legs(self, shard_list, body, timeout, trace_headers,
                      legs_raw: Dict[int, dict],
                      failed: Dict[int, str]) -> None:
        """Fan one round of legs out on the leg pool and sort the
        responses into `legs_raw` / `failed` (per-shard outcome
        counters included)."""
        futs = {k: self._leg_pool.submit(self._route_leg, k, body,
                                         timeout, trace_headers)
                for k in shard_list}
        for k, fut in futs.items():
            try:
                status, decoded = fut.result()
            except Exception as e:
                failed[k] = f"{type(e).__name__}: {e}"
                self._m_shard_requests.inc(shard=str(k), outcome="failed")
                continue
            if status != 200:
                failed[k] = (f"http {status}: "
                             f"{(decoded or {}).get('error', '')}")
                self._m_shard_requests.inc(shard=str(k), outcome="failed")
                continue
            legs_raw[k] = decoded
            self._m_shard_requests.inc(shard=str(k), outcome="ok")

    def _route_sharded(self, path: str, payload: dict, body: bytes,
                       timeout: float,
                       trace_headers: Optional[Dict[str, str]]
                       ) -> Tuple[int, dict]:
        """Route one scoring request across an entity-sharded fleet:
        fan /margins legs to every shard the request's entity ids touch
        (plus one primary leg for the replicated FE/MF coordinates),
        merge the per-coordinate margins bit-identically to a monolithic
        replica, and degrade per `degraded_policy` when a touched shard
        has no healthy replica."""
        with self._lock:
            spec = self._shard_spec
            meta = self._coord_meta
        ids = payload.get("ids") or {}
        cov = self.shard_coverage() or {}
        covered = sorted(k for k, c in cov.items() if c > 0)
        if not covered:
            self._m_errors.inc()
            raise NoReadyReplica(
                "no shard has a healthy replica — the sharded fleet "
                "cannot place any leg")
        if meta is not None:
            needed = set(shards_touched(spec, meta, ids))
        else:
            # the coordinate fold order is unknown until a first leg
            # answers: fan to every shard rather than guess
            needed = set(range(spec.num_shards))
        # the replicated FE/MF margins come from the lowest covered leg
        needed.add(covered[0])
        legs_raw: Dict[int, dict] = {}
        failed: Dict[int, str] = {}
        self._collect_legs(sorted(k for k in needed if cov.get(k, 0) > 0),
                           body, timeout, trace_headers, legs_raw, failed)
        if not legs_raw:
            self._m_errors.inc()
            raise NoReadyReplica(
                f"every shard leg failed: { {k: failed[k] for k in sorted(failed)} }")
        versions = {str(leg.get("model_version"))
                    for leg in legs_raw.values()}
        if len(versions) > 1:
            # legs scored different model versions: merging them would
            # mix tables — this window closes as the swap replicates
            self._m_errors.inc()
            return 503, {"error": "shard legs disagree on model version "
                                  "(fleet mid-swap); retry",
                         "versions": sorted(versions)}
        meta = legs_raw[min(legs_raw)]["coordinates"]
        with self._lock:
            self._coord_meta = meta
        # a swap can change the coordinate set under a stale cached fold
        # order: fan one catch-up round to any newly-needed shards
        extra = sorted(k for k in shards_touched(spec, meta, ids)
                       if k not in needed and cov.get(k, 0) > 0)
        if extra:
            self._collect_legs(extra, body, timeout, trace_headers,
                               legs_raw, failed)
        legs = {k: {name: decode_array(enc)
                    for name, enc in leg["margins"].items()}
                for k, leg in legs_raw.items()}
        fold = ",".join(m["name"] for m in meta)
        merged = last = None
        for _ in range(self.config.max_attempts):
            try:
                faults.fire("shard.merge", coordinate=fold)
                merged = merge_margins(spec, meta, ids, legs, min(legs),
                                       missing_policy="partial")
                break
            except ShardMergeError as e:
                self._m_errors.inc()
                return 503, {"error": f"shard merge failed: {e}"}
            except Exception as e:
                if not faults.is_transient(e):
                    raise
                # a pure host fold over already-collected legs: the
                # retry is bit-exact by construction
                last = e
                self._m_retries.inc()
        if merged is None:
            raise last
        scores = merged["scores"]
        a_leg = legs_raw[min(legs_raw)]
        out: Dict[str, object] = {
            "model_version": a_leg.get("model_version"),
            "sharded": True,
            "shards": sorted(legs_raw),
        }
        if merged["missing_shards"]:
            self._m_shard_degraded.inc()
            if self.config.degraded_policy == "error":
                self._m_errors.inc()
                return 503, {
                    "error": "shard(s) "
                             f"{merged['missing_shards']} have no healthy "
                             "replica and the degradation policy is "
                             "'error'",
                    "missing_shards": merged["missing_shards"],
                    "partial_rows": merged["partial_rows"]}
            # partial: the lost shards' random-effect contributions fold
            # as exactly 0.0 (the unseen-entity default), stamped so the
            # caller KNOWS these rows are partial
            out["degraded"] = True
            out["missing_shards"] = merged["missing_shards"]
            out["partial_rows"] = merged["partial_rows"]
        if path.rstrip("/").rsplit("/", 1)[-1] == "predict":
            # host-side inverse link, identical to the replica's
            # mean_prediction: f64 margins (+ offsets) through the loss's
            # mean on a CPU tensor — no device
            import torch

            from photon_ml_tpu_torch.ops import TASK_LOSSES
            loss = TASK_LOSSES.get(str(a_leg.get("task_type")))
            if loss is None or getattr(loss, "mean", None) is None:
                self._m_errors.inc()
                return 503, {"error": f"task {a_leg.get('task_type')!r} "
                                      "has no mean function"}
            z = np.asarray(scores, np.float64)
            if payload.get("offsets") is not None:
                z = z + np.asarray(payload["offsets"], np.float64)
            out["predictions"] = loss.mean(
                torch.from_numpy(z)).numpy().tolist()
        else:
            out["scores"] = np.asarray(scores, np.float64).tolist()
        return 200, out

    def publisher_handle(self) -> Optional[ReplicaHandle]:
        with self._lock:
            for h in self._handles:
                if h.publisher and not h.detached:
                    return h
        return None

    def route_publisher(self, method: str, path: str,
                        payload: Optional[dict] = None,
                        timeout: Optional[float] = None
                        ) -> Tuple[int, dict, Dict[str, str]]:
        """Route a model-state request (feedback/swap/rollback) to the
        publisher replica; returns (status, payload, passthrough
        headers) — Retry-After from the publisher's backpressure rides
        through to the client."""
        h = self.publisher_handle()
        if h is None:
            raise NoReadyReplica("no publisher replica attached")
        body = None if payload is None else json.dumps(payload).encode()
        timeout = (timeout if timeout is not None
                   else self.config.request_timeout_s)
        request_id = (distributed.current_request_id()
                      or distributed.new_request_id())
        conn = HTTPConnection(h.host, h.port, timeout=timeout)
        try:
            with distributed.server_span(
                    "front_request", None, request_id=request_id,
                    remote_parent=distributed.current_ref(),
                    path=path) as scope:
                headers = {"Content-Type": "application/json"}
                if body is not None:
                    headers["Content-Length"] = str(len(body))
                headers.update(distributed.outbound_headers(
                    scope.request_id, distributed.current_ref()))
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            passthrough = {}
            retry_after = resp.getheader("Retry-After")
            if retry_after:
                passthrough["Retry-After"] = retry_after
            try:
                decoded = json.loads(raw) if raw else {}
            except ValueError:
                decoded = {"error": "undecodable replica response"}
            return resp.status, decoded, passthrough
        except (ConnectionError, OSError) as e:
            self._mark_failure(h, f"{type(e).__name__}: {e}")
            self._m_errors.inc()
            raise NoReadyReplica(
                f"publisher {h.url} unreachable: {e}") from e
        finally:
            conn.close()

    # -- drain / audit / status ----------------------------------------------

    def drain(self, url: str, timeout: float = 30.0) -> Dict[str, object]:
        """Take one replica out: stop routing, ask it to drain (its own
        /healthz flips 503), wait for in-flight to finish, detach."""
        url = url.rstrip("/")
        with self._lock:
            handle = next((h for h in self._handles if h.url == url), None)
            if handle is None:
                raise ValueError(f"no attached replica at {url!r}")
            handle.draining = True
            handle.ready = False
        try:
            self._send(handle, "POST", "/fleet/drain", b"{}",
                       self.config.probe_timeout_s)
        except Exception as e:  # drain is best-effort on the replica side
            logger.warning("front: drain request to %s failed: %s", url, e)
        waited = 0.0
        step = 0.05
        while waited < timeout:
            with self._lock:
                if handle.inflight == 0:
                    break
            self._closed.wait(timeout=step)
            waited += step
        with self._lock:
            handle.detached = True
            remaining = handle.inflight
        self._refresh_gauges()
        telemetry.event("front_replica_drained", url=url,
                        inflight_left=str(remaining))
        logger.info("front: replica %s drained and detached "
                    "(waited %.2fs, %d in flight left)", url, waited,
                    remaining)
        return {"url": url, "detached": True, "inflight_left": remaining}

    def attach(self, url: str) -> None:
        """(Re-)attach a replica URL; it enters rotation once probes see
        it ready."""
        url = url.rstrip("/")
        with self._lock:
            for h in self._handles:
                if h.url == url:
                    h.detached = False
                    h.draining = False
                    h.fails = h.successes = 0
                    h.ready = False
                    return
            self._handles.append(ReplicaHandle(url))

    def audit(self) -> Dict[str, object]:
        """Fan /fleet/audit out to every attached replica: the fleet
        convergence check in one call."""
        out: Dict[str, object] = {}
        with self._lock:
            handles = [h for h in self._handles if not h.detached]
        for h in handles:
            try:
                status, raw = self._send(h, "GET", "/fleet/audit", None,
                                         self.config.probe_timeout_s)
                out[h.url] = (json.loads(raw) if status == 200
                              else {"error": f"http {status}"})
            except Exception as e:
                out[h.url] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def status(self) -> Dict[str, object]:
        with self._lock:
            replicas = [h.state() for h in self._handles]
            ready = sum(1 for h in self._handles
                        if h.ready and not h.detached)
            spec = self._shard_spec
        out: Dict[str, object] = {"role": "front",
                                  "ready_replicas": ready,
                                  "replicas": replicas}
        cov = self.shard_coverage()
        if cov is not None:
            out["shards"] = {
                "spec": spec.to_dict(),
                "policy": self.config.degraded_policy,
                "coverage": {str(k): v for k, v in sorted(cov.items())},
                "shards_down": sorted(k for k, v in cov.items()
                                      if v == 0),
            }
        return out

    def prometheus_metrics(self) -> str:
        self._refresh_gauges()
        return prometheus_text(self.registry)

    def metrics_snapshot(self) -> Dict[str, object]:
        self._refresh_gauges()
        return self.registry.snapshot()

    # -- federated metrics ----------------------------------------------------

    def front_snapshot(self) -> Dict[str, object]:
        """The front's OWN instruments as the friendly JSON surface —
        the shape FRONT_SNAPSHOT_PATHS (the metric-surface parity
        contract) declares, path for path."""
        self._refresh_gauges()
        snap = self.registry.snapshot()
        c, g = snap["counters"], snap["gauges"]
        return {
            "requests": c["fleet.front_requests"],
            "failovers": c["fleet.front_failovers"],
            "hedges": c["fleet.front_hedges"],
            "hedge_wins": c["fleet.front_hedge_wins"],
            "retries": c["fleet.front_retries"],
            "shed": c["fleet.front_shed"],
            "errors": c["fleet.front_errors"],
            "probe_failures": c["fleet.front_probe_failures"],
            "scrape_failures": c["fleet.front_scrape_failures"],
            "ready_replicas": g["fleet.front_ready_replicas"],
            "max_lag_seq": g["fleet.front_max_lag_seq"],
            "requests_by_replica": snap["labeled"]["front.requests"],
            "shard_requests": snap["labeled"]["fleet.shard_requests"],
            "shard_coverage": g["fleet.shard_coverage"],
            "shard_degraded": c["fleet.shard_degraded"],
        }

    def _fleet_lag(self) -> Dict[str, object]:
        """Per-replica replication lag derived from the probe payloads:
        the publisher's applied seq IS the log head, so every replica's
        record lag is observable from the front alone."""
        with self._lock:
            head = max((h.applied_seq for h in self._handles
                        if h.publisher and h.applied_seq is not None),
                       default=None)
            per = {h.url: {
                "applied_seq": h.applied_seq,
                "lag_records": (None if h.applied_seq is None
                                or head is None
                                else max(head - h.applied_seq, 0)),
                "ready": int(h.ready and not h.detached),
                "publisher": h.publisher,
            } for h in self._handles if not h.detached}
        return {"publisher_head_seq": head, "replicas": per}

    def _scrape(self, h: ReplicaHandle, path: str):
        """(status, body) from one replica's metrics surface, or None —
        scrape failures are counted, never propagated (a dead replica
        must not take the fleet's metrics page down)."""
        try:
            status, body = self._send(h, "GET", path, None,
                                      self.config.probe_timeout_s)
            if status != 200:
                raise RuntimeError(f"http {status}")
            return body
        except Exception as e:
            self._m_scrape_failures.inc()
            logger.debug("front: metrics scrape of %s%s failed: %s",
                         h.url, path, e)
            return None

    def federated_snapshot(self) -> Dict[str, object]:
        """The fleet's JSON metrics surface: the front's own instruments
        plus every attached replica's /metrics.json, keyed by instance,
        plus the probe-derived per-replica replication lag."""
        with self._lock:
            handles = [h for h in self._handles if not h.detached]
        replicas: Dict[str, object] = {}
        for h in handles:
            body = self._scrape(h, "/metrics.json")
            if body is None:
                replicas[h.url] = {"error": "unreachable"}
                continue
            try:
                replicas[h.url] = json.loads(body)
            except ValueError:
                replicas[h.url] = {"error": "undecodable"}
        return {"front": self.front_snapshot(), "replicas": replicas,
                "fleet": self._fleet_lag()}

    _SERIES_RE = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s(.*)$")

    def _relabel(self, text: str, instance: str, lines: List[str],
                 seen_types: set) -> None:
        """Stamp a scraped exposition page with an instance label so the
        per-replica series coexist on one federated page."""
        for line in text.splitlines():
            if line.startswith("# TYPE"):
                if line not in seen_types:
                    seen_types.add(line)
                    lines.append(line)
                continue
            if line.startswith("#") or not line.strip():
                continue
            m = self._SERIES_RE.match(line)
            if not m:
                continue
            name, _brace, labels, value = m.groups()
            inner = f'instance="{instance}"'
            if labels:
                inner += "," + labels
            lines.append(f"{name}{{{inner}}} {value}")

    def federated_prometheus(self) -> str:
        """The fleet's Prometheus surface (the front's GET /metrics):
        the front's own registry plus every healthy replica's and the
        publisher's exposition, per-replica instance labels, plus the
        probe-derived per-replica lag series."""
        self._refresh_gauges()
        lines: List[str] = []
        seen_types: set = set()
        self._relabel(prometheus_text(self.registry), "front", lines,
                      seen_types)
        with self._lock:
            handles = [h for h in self._handles if not h.detached]
        for h in handles:
            body = self._scrape(h, "/metrics")
            if body is None:
                continue
            self._relabel(body.decode("utf-8", "replace"), h.url, lines,
                          seen_types)
        lag = self._fleet_lag()
        for series in ("photon_fleet_replica_applied_seq",
                       "photon_fleet_replica_lag_records",
                       "photon_fleet_replica_ready"):
            lines.append(f"# TYPE {series} gauge")
        for url, st in sorted(lag["replicas"].items()):
            if st["applied_seq"] is not None:
                lines.append(f'photon_fleet_replica_applied_seq'
                             f'{{instance="{url}"}} {st["applied_seq"]}')
            if st["lag_records"] is not None:
                lines.append(f'photon_fleet_replica_lag_records'
                             f'{{instance="{url}"}} {st["lag_records"]}')
            lines.append(f'photon_fleet_replica_ready'
                         f'{{instance="{url}"}} {st["ready"]}')
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            thread, self._probe_thread = self._probe_thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._leg_pool.shutdown(wait=False, cancel_futures=True)
