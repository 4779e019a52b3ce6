"""Replica runtime + publisher bridge: N scorers kept bit-identical (port
of photon_ml_tpu/fleet/replica.py: host logic around the port's registry,
so a replica of either package joins and converges on a log the other's
publisher wrote).

`FleetPublisher` attaches to ONE ScoringService's ModelRegistry (the
publisher — typically the replica running the OnlineUpdater) and turns
its ordered publish-hook events into replication-log records: the
registry assigns a ticket per mutation UNDER its lock, the publisher
reorders racing hook invocations by ticket, and a single-flusher loop
appends to the log with transient-retry backoff — so the log is always
a prefix-exact serialization of the publisher's model state.

`Replica` wraps a follower ScoringService.  Lifecycle:

  join      load the latest snapshot (if the tail was compacted away),
            replay the log tail through the local registry, warm the
            delta scatters (`CompiledScorer.warmup_delta`) — only then
            report ready (/healthz stops returning 503)
  apply     the poll loop tails the log; each record applies through the
            SAME registry primitives the publisher mutated with
            (apply_delta / replay_row_state / load / rollback), so the
            tables converge bit-identically (audited by version vector +
            per-table sha256, GET /fleet/audit)
  crash     the applied seq is durably recorded (state_dir/applied.json,
            atomic write+fsync) TOGETHER with the replica's folded row
            state (base model dir + net changed rows — the same fold the
            log's compaction computes), because a restarted process
            rebuilds its tables from the base model: progress without
            the matching table state would silently skip history.  Every
            record replay is additionally IDEMPOTENT (version-vector
            guards skip what already landed), so a SIGKILLed replica
            resumes from its durable seq and converges bit-identically.
            A state dir that predates a full-model rollback the restart
            cannot replay (the previous scorer is gone) fails LOUDLY
            with a rejoin-fresh hint rather than serving diverged tables
  drain     stop applying + flip /healthz to 503; the front stops
            routing, in-flight requests finish, then the process detaches

Containment mirrors chunk staging (utils/faults.py sites `replica.apply`
and `replog.read`): transient failures retry with jittered exponential
backoff; fatal ones mark the replica failed — loudly visible on
/healthz, never a silently stale scorer.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Dict, Optional

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import flight
from photon_ml_tpu_torch.telemetry.timings import clock

from photon_ml_tpu_torch.fleet.replog import (ReplicationLog, ReplicationLogError,
                                        _FoldState, decode_array,
                                        delta_from_record, record_for_event,
                                        record_for_shard_map)
from photon_ml_tpu_torch.utils import durable, faults, locktrace

logger = logging.getLogger("photon_ml_tpu")

_APPLIED_NAME = "applied.json"


class ReplicaError(RuntimeError):
    """The replica cannot continue applying (fatal apply failure, record
    stream divergence) — surfaced on /healthz as failed."""


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Knobs of the replica runtime (cli.serve --replica maps 1:1)."""

    poll_interval_s: float = 0.05   # log tail poll period
    max_attempts: int = 3           # transient read/apply retries
    backoff_s: float = 0.02         # base of the jittered exp backoff
    warm_delta_rows: int = 64       # delta scatters warmed up to this
                                    # pow-2 delta row count
    ack_every: int = 8              # durable applied-seq write cadence
                                    # (always also written at batch end)


class FleetPublisher:
    """Bridges a publisher registry's ordered mutation events into the
    replication log.  Register BEFORE the updater starts and before any
    swap/rollback traffic: events are ordered by registry ticket, and the
    publisher's base ticket is captured at attach."""

    def __init__(self, service, log: ReplicationLog,
                 model_dir: Optional[str] = None, max_attempts: int = 3,
                 backoff_s: float = 0.02, shard_spec=None):
        """`shard_spec` (a fleet.shards.ShardSpec) declares the fleet's
        entity partition: anchoring an empty log appends a `shard_map`
        record BEFORE the base swap, so every joining replica learns (and
        validates against) the partition it must filter by.  The
        publisher itself stays UNSHARDED — it holds the full model,
        solves online deltas against it, and the per-replica shard
        filtering happens at apply time on the followers."""
        self.service = service
        self.log = log
        self.shard_spec = shard_spec
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self._lock = locktrace.tracked(threading.Lock(),
                                       "FleetPublisher._lock")
        self._buffer: Dict[int, dict] = {}  # photonlint: guarded-by=_lock
        self._flushing = False  # photonlint: guarded-by=_lock
        self._failed: Optional[str] = None  # photonlint: guarded-by=_lock
        self._appended = 0  # photonlint: guarded-by=_lock
        self._jitter = random.Random(0xF1EE7)
        dropped = log.recover()
        if dropped:
            logger.warning("replication log: truncated %d torn tail "
                           "byte(s) left by a previous crash", dropped)
        self._next = service.registry.add_publish_hook(self._on_event)
        # anchor an empty log: the shard map (when the fleet is
        # entity-sharded) and then the CURRENT model as its first swap
        # record, so replicas that joined with a different --model-dir
        # still converge onto the publisher's base model
        if log.head_seq() == 0:
            if shard_spec is not None:
                self._append_with_retry(record_for_shard_map(shard_spec))
            if model_dir is not None:
                self._append_with_retry({
                    "kind": "swap",
                    "version": service.registry.version,
                    "previous_version": None,
                    "source_dir": str(model_dir)})

    def status(self) -> Dict[str, object]:
        with self._lock:
            out = {"role": "publisher", "failed": self._failed,
                   "appended": self._appended,
                   "pending_events": len(self._buffer),
                   "head_seq": None}
        if self.shard_spec is not None:
            out["shard_spec"] = self.shard_spec.to_dict()
        return out

    def shard_audit(self, shard_index: int) -> Dict[str, object]:
        """The publisher-side half of a per-shard audit: sha256 of its
        FULL tables' rows filtered to `shard_index`'s owned entities
        (GET /fleet/audit?shard=K).  A converged shard replica's
        `table_hashes()` reports the identical hashes, since its
        resident tables ARE that filtered slice."""
        if self.shard_spec is None:
            raise ValueError("this publisher has no shard spec "
                             "(cli.serve --shard-count)")
        scorer = self.service.registry.scorer
        return {"version_vector": self.service.version_vector(),
                "shard": {"index": int(shard_index),
                          **self.shard_spec.to_dict()},
                "table_hashes": scorer.shard_table_hashes(
                    self.shard_spec, int(shard_index))}

    # -- the ordered event -> record pump ------------------------------------

    def _on_event(self, ticket: int, event: dict) -> None:
        with self._lock:
            if self._failed is not None:
                return  # a broken log must not block serving
            self._buffer[ticket] = event
        # single-flusher: whoever finds the next expected ticket AND the
        # flusher slot free drains in ticket order; racing threads buffer
        # and leave — file order therefore always equals mutation order
        while True:
            with self._lock:
                if self._flushing or self._next not in self._buffer:
                    return
                self._flushing = True
                event = self._buffer.pop(self._next)
                self._next += 1
            try:
                self._append_with_retry(record_for_event(event))
            except Exception as e:
                msg = f"{type(e).__name__}: {e}"
                with self._lock:
                    self._failed = msg
                logger.error(
                    "replication publish FAILED (%s): the log is behind "
                    "the live model and replicas will stall — restart "
                    "the publisher against a repaired log", msg)
                telemetry.event("fleet_publish_failed", error=msg)
                return
            finally:
                with self._lock:
                    self._flushing = False

    def _append_with_retry(self, record: dict) -> int:
        attempt = 0
        while True:
            attempt += 1
            try:
                seq = self.log.append(record)
                with self._lock:
                    self._appended += 1
                return seq
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or \
                        attempt >= self.max_attempts:
                    raise
                telemetry.event("fleet_append_retry", attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(self.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    def head_seq(self) -> int:
        return self.log.head_seq()


class Replica:
    """A follower ScoringService kept converged with the replication log.

    `join()` is the catch-up path (returns only when the replica is
    bit-identical with the log head and warmed); `start()` runs the
    background poll loop; `poll_once()` is one tail-apply cycle (tests
    and the bench drive it directly for determinism)."""

    def __init__(self, service, log: ReplicationLog, state_dir: str,
                 config: ReplicaConfig = ReplicaConfig()):
        self.service = service
        self.log = log
        self.state_dir = str(state_dir)
        self.config = config
        os.makedirs(self.state_dir, exist_ok=True)
        self._lock = locktrace.tracked(threading.Lock(), "Replica._lock")
        self._applied_seq = 0  # photonlint: guarded-by=_lock
        self._head_seen = 0  # photonlint: guarded-by=_lock
        self._ready = False  # photonlint: guarded-by=_lock
        self._draining = False  # photonlint: guarded-by=_lock
        self._failed: Optional[str] = None  # photonlint: guarded-by=_lock
        self._catchup_s: Optional[float] = None  # photonlint: guarded-by=_lock
        self._thread: Optional[threading.Thread] = None  # photonlint: guarded-by=_lock
        self._closed = threading.Event()
        self._jitter = random.Random(0xD0D0)
        # the replica's own fold of everything it applied (base model dir
        # + net changed rows): persisted WITH the applied seq, because a
        # restarted process rebuilds its tables from the base model and
        # a bare seq would skip the history that produced them.
        # Thread-confined by protocol, not locked: join() runs before
        # start(), and afterwards ONLY the apply path (loop thread or a
        # manual poll_once driver, never both) touches it.
        self._fold: Optional[_FoldState] = None  # photonlint: guarded-by=none

    # -- durable applied-seq + folded row state ------------------------------

    def _applied_path(self) -> str:
        return os.path.join(self.state_dir, _APPLIED_NAME)

    def _load_state(self):
        """-> (applied_seq, fold | None).  No durable fold (or a fold
        that could not track a record) forces a FULL replay from zero —
        correct, just slower than a resume."""
        path = self._applied_path()
        if not os.path.exists(path):
            return 0, None
        with open(path) as f:
            state = json.load(f)
        snap = state.get("snapshot")
        if not snap:
            return 0, None
        return int(state.get("applied_seq", 0)), \
            _FoldState.from_snapshot(snap)

    def _persist_applied(self, applied_seq: int) -> None:
        snap = None
        if self._fold is not None and self._fold.model_dir is not None:
            snap = self._fold.to_snapshot()
        durable.atomic_write_json(self._applied_path(), {
            "applied_seq": int(applied_seq),
            "snapshot": snap,
            "version_vector": self.service.registry.version_vector()})

    def _fold_record(self, env: dict) -> None:
        if self._fold is None:
            return
        try:
            self._fold.fold(env)
        except ReplicationLogError as e:
            # e.g. a full-model rollback whose previous version this
            # fold never saw: the fold can no longer mirror the live
            # state, so stop persisting it — restarts fall back to a
            # full replay instead of trusting a wrong snapshot
            logger.warning("replica fold disabled (%s): restarts will "
                           "replay the full log", e)
            self._fold = None

    # -- lifecycle -----------------------------------------------------------

    def join(self) -> Dict[str, object]:
        """Catch up to the log head and report ready: snapshot bootstrap
        (when the tail before our applied seq was compacted away), tail
        replay, delta-program warmup.  On a restart after a crash this
        resumes from the durably-recorded applied seq; replay is
        idempotent, so re-applying the record the crash interrupted is
        harmless and the tables converge bit-identically."""
        t0 = clock()
        applied, fold = self._load_state()
        self._fold = fold if fold is not None else _FoldState()
        resumed = applied > 0
        with telemetry.span("replica_join", resumed=resumed,
                            applied_seq=applied):
            bootstrapped = False
            if resumed:
                # restore the durable fold's table state onto the fresh
                # registry (the process restart threw the tables away)
                self._bootstrap(fold.to_snapshot())
                bootstrapped = True
            snap = self.log.latest_snapshot()
            if snap is not None and applied < int(snap["upto_seq"]):
                self._bootstrap(snap)
                self._fold = _FoldState.from_snapshot(snap)
                applied = int(snap["upto_seq"])
                bootstrapped = True
            applied, records = self._apply_tail(applied)
            self._persist_applied(applied)
            warmup_s = self.service.registry.scorer.warmup_delta(
                self.config.warm_delta_rows)
        catchup_s = clock() - t0
        with self._lock:
            self._applied_seq = applied
            self._head_seen = max(self._head_seen, applied)
            self._ready = True
            self._catchup_s = catchup_s
        self.service.metrics.observe_replica_ready(True, catchup_s)
        self.service.metrics.observe_replica_applied(
            applied_seq=applied, lag_seq=0, records=records)
        logger.info("replica ready: applied_seq=%d (%s, %d record(s) "
                    "replayed, catch-up %.3fs)", applied,
                    "resumed" if resumed else "fresh join", records,
                    catchup_s)
        return {"applied_seq": applied, "records_replayed": records,
                "resumed": resumed, "bootstrapped": bootstrapped,
                "catchup_s": catchup_s, "delta_warmup_s": warmup_s}

    def _bootstrap(self, snap: dict) -> None:
        """Fast-forward to a compaction snapshot: load its base model and
        scatter the folded net rows."""
        registry = self.service.registry
        with telemetry.span("replica_bootstrap",
                            upto_seq=int(snap["upto_seq"])):
            if registry.version != snap["version"]:
                registry.load(snap["model_dir"], version=snap["version"])
            restored = {
                lane: (decode_array(enc["rows"]),
                       decode_array(enc["values"]))
                for lane, enc in snap.get("restored", {}).items()}
            registry.replay_row_state(restored, snap["version"],
                                      int(snap["delta_seq"]))

    def _apply_tail(self, applied: int):
        """Apply every durable record past `applied`; returns (new
        applied seq, records applied)."""
        records = self._read_with_retry(applied)
        count = 0
        for env in records:
            self._apply_with_retry(env)
            self._fold_record(env)
            applied = int(env["log_seq"])
            count += 1
            now = time.time()
            # log-append -> replica-apply latency (the record envelope
            # carries its append wall time) + end-to-end feedback ->
            # fleet-visible latency for delta records whose trace names
            # the oldest intake time
            self.service.metrics.observe_replica_record(
                apply_latency_s=max(now - float(env.get("t", now)), 0.0),
                feedback_visible_s=self._feedback_visible_s(env, now))
            if count % max(self.config.ack_every, 1) == 0:
                self._persist_applied(applied)
        with self._lock:
            if records:
                self._head_seen = max(self._head_seen,
                                      int(records[-1]["log_seq"]))
        return applied, count

    @staticmethod
    def _feedback_visible_s(env: dict, now: float):
        trace = env["record"].get("trace") or {}
        oldest = trace.get("enqueued_wall_s")
        if env["record"].get("kind") != "delta" or not oldest:
            return None
        return max(now - float(oldest), 0.0)

    def poll_once(self) -> int:
        """One tail-apply cycle (the poll loop's body).  Returns the
        number of records applied; 0 while draining/failed."""
        with self._lock:
            if self._draining or self._failed is not None:
                return 0
            applied = self._applied_seq
        try:
            new_applied, count = self._apply_tail(applied)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            msg = f"{type(e).__name__}: {e}"
            with self._lock:
                self._failed = msg
            self.service.metrics.observe_replica_ready(False)
            logger.error("replica apply FAILED (%s): marking this "
                         "replica failed — /healthz degrades and the "
                         "front stops routing here", msg)
            telemetry.event("replica_failed", error=msg)
            # the postmortem window is NOW: dump the flight ring before
            # the operator (or the orchestrator) restarts the process
            flight.trigger("replica.failed", error=msg)
            return 0
        if count:
            self._persist_applied(new_applied)
        with self._lock:
            self._applied_seq = new_applied
            self._head_seen = max(self._head_seen, new_applied)
            head = self._head_seen
        self.service.metrics.observe_replica_applied(
            applied_seq=new_applied, lag_seq=head - new_applied,
            records=count)
        return count

    def _read_with_retry(self, applied: int):
        cfg = self.config
        attempt = 0
        while True:
            attempt += 1
            try:
                return self.log.read(applied)
            except (KeyboardInterrupt, SystemExit):
                raise
            except ReplicationLogError:
                raise  # structural: gap/corruption/compaction, not transient
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise
                self.service.metrics.observe_replica_apply_retry()
                telemetry.event("replica_read_retry", attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    def _apply_with_retry(self, env: dict) -> None:
        cfg = self.config
        attempt = 0
        trace = env["record"].get("trace") or {}
        while True:
            attempt += 1
            try:
                with telemetry.span(
                        "replica_apply", seq=int(env["log_seq"]),
                        kind=env["record"]["kind"],
                        request_ids=",".join(
                            trace.get("request_ids") or ()),
                        remote_parent=trace.get("parent")):
                    self._apply_record(env)
                return
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise
                self.service.metrics.observe_replica_apply_retry()
                telemetry.event("replica_apply_retry", attempt=attempt,
                                seq=int(env["log_seq"]),
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    def _apply_record(self, env: dict) -> str:
        """Replay ONE record through the local registry.  Every branch is
        idempotent (guarded on the version vector), so crash-replay of an
        already-applied record is a no-op — the property that makes the
        at-least-once applied-seq persistence safe."""
        rec = env["record"]
        kind = rec["kind"]
        faults.fire("replica.apply", kind=kind)
        registry = self.service.registry
        shard = getattr(registry.scorer, "shard", None)
        if shard is not None:
            # sharded catch-up fault site: fired INSIDE the apply retry
            # loop, so injected transients exercise the same backoff
            # discipline as any replicated apply; fatals mark the
            # replica failed exactly like replica.apply
            faults.fire("shard.catchup", shard=str(shard.index))
        if kind == "shard_map":
            if shard is None:
                return "skipped"  # full-model replica: owns everything
            from photon_ml_tpu_torch.fleet.shards import ShardSpec
            try:
                spec = ShardSpec.from_dict(rec["spec"])
            except ValueError as e:
                raise ReplicaError(
                    f"shard_map record at seq {env['log_seq']} is "
                    f"unusable ({e})") from e
            if spec != shard.spec:
                raise ReplicaError(
                    f"shard_map record at seq {env['log_seq']} announces "
                    f"partition {spec.to_dict()} but this replica was "
                    f"built for {shard.spec.to_dict()} — a replica "
                    "cannot re-partition live; restart it with the "
                    "fleet's spec (cli.serve --shard K/N matching the "
                    "publisher's --shard-count)")
            return "applied"
        if kind == "swap":
            if registry.version == rec["version"]:
                return "skipped"  # same version: the join-time base model
            if not rec.get("source_dir"):
                raise ReplicaError(
                    f"swap record seq {env['log_seq']} has no model "
                    "directory (the publisher installed an in-memory "
                    "model) — replicas cannot replay it")
            registry.load(rec["source_dir"], version=rec["version"])
            return "applied"
        if kind == "delta":
            vv = registry.version_vector()
            if vv["version"] == rec["version"] and \
                    vv["delta_seq"] >= int(rec["delta_seq"]):
                return "skipped"  # crash-replay of an applied delta
            registry.apply_delta(delta_from_record(rec))
            return "applied"
        if kind == "delta_rollback":
            vv = registry.version_vector()
            if vv["version"] == rec["version"] and \
                    vv["delta_seq"] == int(rec["to_delta_seq"]) and \
                    registry.pending_deltas() == 0:
                return "skipped"
            restored = {lane: (decode_array(enc["rows"]),
                               decode_array(enc["values"]))
                        for lane, enc in rec["restored"].items()}
            registry.replay_row_state(restored, rec["version"],
                                      int(rec["to_delta_seq"]))
            return "applied"
        if kind == "rollback":
            if registry.version == rec["version"]:
                return "skipped"
            try:
                got = registry.rollback()
            except RuntimeError as e:
                raise ReplicaError(
                    f"cannot replay the full-model rollback at seq "
                    f"{env['log_seq']} ({e}): this process never held "
                    f"the previous version {rec['version']!r} in memory "
                    "— rejoin with a FRESH state directory so the whole "
                    "history replays") from e
            if got != rec["version"]:
                raise ReplicaError(
                    f"full-model rollback replay landed on {got!r} but "
                    f"the record (seq {env['log_seq']}) expects "
                    f"{rec['version']!r} — this replica's version "
                    "history diverged; rejoin from a snapshot")
            return "applied"
        raise ReplicaError(
            f"unknown record kind {kind!r} at seq {env['log_seq']} — "
            "this replica is older than the publisher; upgrade it")

    # -- status / audit ------------------------------------------------------

    def status(self) -> Dict[str, object]:
        with self._lock:
            out = {"role": "replica", "ready": self._ready,
                   "draining": self._draining, "failed": self._failed,
                   "applied_seq": self._applied_seq,
                   "lag_seq": max(self._head_seen - self._applied_seq, 0),
                   "catchup_s": (None if self._catchup_s is None
                                 else round(self._catchup_s, 3))}
        shard = self.service.registry.scorer.shard_info()
        if shard is not None:
            out["shard"] = shard
        return out

    def audit(self) -> Dict[str, object]:
        """Version vector + table hashes + applied seq: the convergence
        identity (GET /fleet/audit)."""
        out = self.service.audit()
        out.update(self.status())
        return out

    def healthy(self) -> bool:
        with self._lock:
            return self._ready and not self._draining \
                and self._failed is None

    # -- drain / background loop ---------------------------------------------

    def drain(self) -> Dict[str, object]:
        """Stop applying and flip /healthz to 503 so the front stops
        routing here; in-flight requests finish on the live scorer, then
        the process can detach."""
        with self._lock:
            already = self._draining
            self._draining = True
        if not already:
            self.service.metrics.observe_replica_ready(False)
            telemetry.event("replica_draining")
            logger.info("replica draining: new traffic refused, log "
                        "apply stopped")
        return self.status()

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._closed.clear()
            thread = threading.Thread(target=self._loop, daemon=True,
                                      name="photon-fleet-replica")
            self._thread = thread
        thread.start()

    def _loop(self) -> None:
        while not self._closed.is_set():
            self._closed.wait(timeout=self.config.poll_interval_s)
            if self._closed.is_set():
                break
            try:
                self.poll_once()
            except Exception as e:  # the loop must never die silently
                logger.exception("replica poll cycle failed: %s", e)

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
