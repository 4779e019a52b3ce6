"""Versioned scorer registry: zero-downtime hot swap, row-level delta
swaps, and delta-aware rollback (a copy of photon_ml_tpu/serving/
registry.py over the port's CompiledScorer).

`load(version_dir)` does ALL the heavy work — model load, device transfer,
bucket warm-up — on the calling (or a background) thread while the
previous scorer keeps serving; only the final reference swap happens under
the lock.  In-flight batches hold their own reference to the old scorer
(the batcher resolves the current scorer per batch), so a swap is atomic
at batch granularity and nothing is dropped.  The previous version is kept
for `rollback()`.

Row-level deltas (the online tier, photon_ml_tpu_torch/online/):
`apply_delta` scatters a ModelDelta's changed random-effect rows into the
LIVE scorer's device tables under the registry lock — no full-model
cutover; each scatter writes a copy of the table, so batches in flight
keep the tables they started on.  The delta's version vector must match
the live version
(`StaleDeltaError` otherwise: rows solved against a superseded model must
never land on its successor), and every applied delta is kept on an undo
log so `rollback()` is DELTA-AWARE: with pending deltas it restores the
exact pre-delta rows (newest first — bit-exact round trip); with none it
falls back to the full-model previous-version swap.  A full-model rollback
restores the previous scorer AS LAST SERVED, i.e. including any deltas it
had absorbed before being swapped out.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.serving.scorer import CompiledScorer
from photon_ml_tpu_torch.telemetry import flight
from photon_ml_tpu_torch.utils import faults, locktrace
from photon_ml_tpu_torch.utils.events import (EventEmitter, ModelDeltaEvent,
                                              ModelSwapEvent)

logger = logging.getLogger("photon_ml_tpu_torch")


class StaleDeltaError(RuntimeError):
    """A delta's base_version no longer matches the live scorer (a full
    swap landed between solve and publish).  The publisher should re-solve
    against the new version — applying anyway would scatter rows computed
    against stale residual margins."""


#: default undo-log depth: deltas are a few KB each, so this bounds
#: memory at a few MB while keeping hours of update history rollback-able.
#: The bound is configurable (`ModelRegistry(max_delta_log=...)`,
#: ServingConfig.max_delta_log, cli.serve --max-delta-log).  When the log
#: overflows, the OLDEST records drop — LOUDLY (warning log + the
#: serve.rollback_degraded counter when a rollback then has to fall back)
#: — and `rollback()` DEGRADES to a full-model rollback, because partial
#: delta restoration would not be the exact pre-delta state.
MAX_DELTA_LOG = 4096


class ModelRegistry:
    def __init__(self, scorer_factory: Optional[Callable] = None,
                 emitter: Optional[EventEmitter] = None,
                 metrics=None, max_delta_log: int = MAX_DELTA_LOG):
        """`scorer_factory(version_dir, version)` -> warmed CompiledScorer;
        defaults to `CompiledScorer.from_model_dir` (on cuda, in
        float32)."""
        self._factory = scorer_factory or (
            lambda d, v: CompiledScorer.from_model_dir(d, version=v))
        self._emitter = emitter
        self._metrics = metrics
        self._lock = locktrace.tracked(threading.Lock(),
                                       "ModelRegistry._lock")
        self._counter = 0
        self._current: Optional[Tuple[str, CompiledScorer]] = None
        self._previous: Optional[Tuple[str, CompiledScorer]] = None
        self._max_delta_log = int(max_delta_log)
        self._delta_log: deque = deque()
        self._delta_log_truncated = False
        self._delta_seq = 0
        self._swap_hooks: list = []
        # ordered model-state change feed (fleet/replog.py's
        # record_for_event turns each event into a replication record):
        # every mutation reserves a ticket UNDER the lock, hooks run
        # OUTSIDE it with (ticket, event) so a publisher can restore the
        # mutation order even when hook invocations race
        self._publish_hooks: list = []
        self._publish_ticket = 0  # photonlint: guarded-by=_lock

    def add_publish_hook(self, fn: Callable[[int, dict], None]) -> int:
        """`fn(ticket, event)` runs after EVERY model-state change —
        full-model install, row-level delta, delta-aware rollback,
        full-model rollback — outside the registry lock.  Tickets are
        assigned under the lock at mutation time, so sorting events by
        ticket reconstructs the exact mutation order even when two hook
        invocations race on different threads (fleet.FleetPublisher
        relies on this to keep the replication log ordered).  Returns the
        next ticket that will be assigned, so a publisher attaching to a
        live registry knows where its event stream starts."""
        with self._lock:
            self._publish_hooks.append(fn)
            return self._publish_ticket

    def _run_publish_hooks(self, ticket: int, event: dict) -> None:
        for fn in list(self._publish_hooks):
            try:
                fn(ticket, event)
            except Exception:  # a broken publisher must not block serving
                logger.exception("publish hook %r failed for ticket %d %r",
                                 fn, ticket, event.get("kind"))

    def add_swap_hook(self, fn: Callable[[str, str], None]) -> None:
        """`fn(version, action)` runs after every FULL-model change —
        install ("swap") and full-model rollback ("rollback"), never a
        row-level delta — outside the registry lock.  The health monitor
        registers here to snapshot its drift baseline per install."""
        self._swap_hooks.append(fn)

    def _run_swap_hooks(self, version: str, action: str) -> None:
        for fn in list(self._swap_hooks):
            try:
                fn(version, action)
            except Exception:  # a broken observer must not block a swap
                logger.exception("swap hook %r failed for %s %r",
                                 fn, action, version)

    @property
    def scorer(self) -> CompiledScorer:
        with self._lock:
            if self._current is None:
                raise RuntimeError("no model loaded")
            return self._current[1]

    @property
    def version(self) -> Optional[str]:
        with self._lock:
            return None if self._current is None else self._current[0]

    @property
    def previous_version(self) -> Optional[str]:
        with self._lock:
            return None if self._previous is None else self._previous[0]

    def _emit(self, event) -> None:
        if self._emitter is not None:
            self._emitter.send_event(event)

    def load(self, version_dir: str, version: Optional[str] = None) -> str:
        """Build + warm the new scorer, then swap atomically.  Blocks until
        the new model is live; use `load_async` to keep serving the old
        model from the calling thread too."""
        with self._lock:
            self._counter += 1
            if version is None:
                import os
                base = os.path.basename(str(version_dir).rstrip("/"))
                version = f"{base or 'model'}@{self._counter}"
        scorer = self._factory(version_dir, version)  # heavy, outside lock
        return self.install(scorer, version, source_dir=version_dir)

    def install(self, scorer: CompiledScorer, version: str,
                source_dir: Optional[str] = None) -> str:
        """Atomically make an already-built scorer the live one (the tail
        of `load`; also the path for swapping in an in-memory model).
        `source_dir` is the model directory the scorer was built from
        (None for in-memory models) — the replication publisher records
        it so replicas can replay the swap."""
        if not getattr(scorer, "warmed", True):
            scorer.warmup()
        # the scorer must carry the version it is installed under: delta
        # publishers stamp `scorer.version` into their version vector, and
        # a None/mismatched version would refuse every delta as stale
        scorer.version = version
        with self._lock:
            previous = self._current
            self._previous = previous
            self._current = (version, scorer)
            # the undo log belongs to the outgoing version: a new full
            # model starts pristine (the previous scorer keeps its
            # absorbed deltas in its tables — that is the state it last
            # served, and what a full-model rollback restores)
            self._delta_log.clear()
            self._delta_log_truncated = False
            self._delta_seq = 0
            ticket = self._publish_ticket
            self._publish_ticket += 1
        if self._metrics is not None:
            self._metrics.observe_swap()
        self._emit(ModelSwapEvent(
            time=time.time(), version=version,
            previous_version=None if previous is None else previous[0],
            action="swap", warmup_s=getattr(scorer, "warmup_s", 0.0)))
        self._run_publish_hooks(ticket, {
            "kind": "swap", "version": version,
            "previous_version": None if previous is None else previous[0],
            "source_dir": None if source_dir is None else str(source_dir)})
        self._run_swap_hooks(version, "swap")
        return version

    def load_async(self, version_dir: str,
                   version: Optional[str] = None) -> "Future[str]":
        """Background hot swap: returns a Future resolving to the new
        version id once it is live."""
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.load(version_dir, version))
            except BaseException as e:  # surface through the future
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="photon-serving-swap").start()
        return fut

    # -- row-level delta swaps (the online tier's publish path) -------------

    def next_delta_seq(self) -> int:
        """Reserve the next delta sequence number for the live version
        (the publisher stamps it into the ModelDelta it is building)."""
        with self._lock:
            return self._delta_seq + 1

    def apply_delta(self, delta, publish_s: float = 0.0) -> dict:
        """Scatter a ModelDelta's rows into the LIVE scorer under the
        lock.  Verifies the version vector (StaleDeltaError on mismatch)
        and appends the delta to the undo log.  Returns the resulting
        version vector."""
        faults.fire("online.publish",
                    coordinate=",".join(sorted(delta.coordinates)))
        with self._lock:
            if self._current is None:
                raise RuntimeError("no model loaded")
            version, scorer = self._current
            if delta.base_version != version:
                raise StaleDeltaError(
                    f"delta was solved against version "
                    f"{delta.base_version!r} but {version!r} is live — "
                    "re-solve against the current model")
            scorer.apply_delta(delta)
            self._delta_seq = delta.seq
            self._delta_log.append(delta)
            overflowed = len(self._delta_log) > self._max_delta_log
            if overflowed:
                self._delta_log.popleft()
                first_overflow = not self._delta_log_truncated
                self._delta_log_truncated = True
            pending = len(self._delta_log)
            ticket = self._publish_ticket
            self._publish_ticket += 1
        if overflowed and first_overflow:
            # LOUD, once per overflow episode: from here on an exact
            # delta-aware rollback is impossible and rollback() will
            # degrade to a full-model swap (serve.rollback_degraded)
            logger.error(
                "delta undo log overflowed its bound of %d: oldest "
                "records dropped — delta-aware rollback DEGRADES to a "
                "full-model rollback until the next install (raise "
                "max_delta_log / --max-delta-log if exact rollback "
                "across this much update history is required)",
                self._max_delta_log)
        if self._metrics is not None:
            self._metrics.observe_delta(rows=delta.num_rows,
                                        publish_s=publish_s)
        self._emit(ModelDeltaEvent(
            time=time.time(), version=version, delta_seq=delta.seq,
            coordinates={n: cd.num_rows
                         for n, cd in delta.coordinates.items()},
            num_rows=delta.num_rows, publish_s=publish_s))
        self._run_publish_hooks(ticket, {"kind": "delta", "delta": delta,
                                         "version": version})
        return {"version": version, "delta_seq": delta.seq,
                "pending_deltas": pending}

    def pending_deltas(self) -> int:
        """Deltas applied to the live version and still rollback-able."""
        with self._lock:
            return len(self._delta_log)

    def applied_deltas(self) -> tuple:
        """Snapshot of the live version's undo log, oldest first (audit /
        replication)."""
        with self._lock:
            return tuple(self._delta_log)

    def version_vector(self) -> dict:
        with self._lock:
            version = None if self._current is None else self._current[0]
            seq = self._delta_seq
        return {"version": version, "delta_seq": seq}

    def rollback(self) -> str:
        """Delta-aware single-level undo.

        With pending deltas: restore the exact pre-delta rows (reverting
        newest-first, so rows touched by several deltas land back on their
        original values bit-exactly) and stay on the current full-model
        version.  With none: swap back to the previous full model.  With a
        TRUNCATED undo log (overflow dropped the oldest records): an exact
        pre-delta restore is impossible, so the rollback DEGRADES to the
        full-model path — loudly (error log + serve.rollback_degraded on
        both metric surfaces)."""
        degraded = False
        with self._lock:
            if self._delta_log and self._delta_log_truncated:
                if self._previous is None:
                    raise RuntimeError(
                        "delta undo log overflowed (oldest records "
                        "dropped) and no previous full model exists: "
                        "neither an exact pre-delta restore nor a "
                        "full-model rollback is possible — swap in a "
                        "known-good model version instead")
                degraded = True
                self._delta_log.clear()
                self._delta_log_truncated = False
            if self._delta_log:
                version, scorer = self._current
                # fold the restored row state (oldest delta's prior wins
                # per row: that is the value the newest-first revert loop
                # below lands on) for the replication publish hook
                restored: dict = {}
                for delta in self._delta_log:          # oldest first
                    for lane, cd in delta.coordinates.items():
                        lane_rows = restored.setdefault(lane, {})
                        for r, p in zip(cd.rows.tolist(), cd.prior):
                            if r not in lane_rows:
                                lane_rows[r] = p
                reverted = 0
                while self._delta_log:
                    scorer.revert_delta(self._delta_log.pop())
                    reverted += 1
                self._delta_seq = 0
                rolled_from = None
            else:
                if self._previous is None:
                    raise RuntimeError(
                        "no previous model version to roll back to")
                rolled_from = self._current
                self._current, self._previous = self._previous, rolled_from
                version = self._current[0]
                reverted = 0
                restored = {}
                self._delta_seq = self._current[1].delta_seq
            ticket = self._publish_ticket
            self._publish_ticket += 1
        if degraded:
            if self._metrics is not None:
                self._metrics.observe_rollback_degraded()
            logger.error(
                "rollback DEGRADED to a full-model swap (-> %r): the "
                "delta undo log had overflowed, so the exact pre-delta "
                "rows are gone — the restored state is the previous "
                "version AS LAST SERVED, not the pre-delta tables",
                version)
        if self._metrics is not None:
            self._metrics.observe_swap(rollback=True)
        self._emit(ModelSwapEvent(
            time=time.time(), version=version,
            previous_version=(None if rolled_from is None
                              else rolled_from[0]),
            action="delta_rollback" if reverted else "rollback"))
        if reverted:
            self._run_publish_hooks(ticket, {
                "kind": "delta_rollback", "version": version,
                "to_delta_seq": 0,
                "restored": {lane: (np.asarray(sorted(rows), np.int64),
                                    np.stack([rows[r]
                                              for r in sorted(rows)]))
                             for lane, rows in restored.items()}})
        else:
            self._run_publish_hooks(ticket, {
                "kind": "rollback", "version": version,
                "previous_version": (None if rolled_from is None
                                     else rolled_from[0]),
                "degraded": degraded})
            # delta rollback keeps the same full-model version live: the
            # health baseline is carried, exactly like a delta publish
            self._run_swap_hooks(version, "rollback")
        # a rollback IS the postmortem moment: flush the flight ring so
        # the window that led here (gate trips, stale deltas, the
        # operator action) is on disk in every process that executes one
        # — publishers directly, replicas when they replay the record
        flight.trigger("model.rollback", version=str(version),
                       kind="delta_rollback" if reverted else "rollback",
                       degraded=degraded)
        return version

    def replay_row_state(self, restored: dict, version: str,
                         to_delta_seq: int) -> None:
        """Replication replay primitive: scatter explicit row states into
        the LIVE scorer and pin the delta seq — how a replica applies a
        delta_rollback record (the restored rows ride in the record, so
        even a snapshot-bootstrapped replica with no local undo history
        converges bit-identically) and how a snapshot bootstrap lands its
        folded rows.  `restored` maps lane -> (rows [k], values [k, d])."""
        with self._lock:
            if self._current is None:
                raise RuntimeError("no model loaded")
            if self._current[0] != version:
                raise StaleDeltaError(
                    f"row-state replay targets version {version!r} but "
                    f"{self._current[0]!r} is live — the replicated "
                    "record stream is out of order")
            scorer = self._current[1]
            for lane, (rows, values) in restored.items():
                scorer.scatter_rows(lane, rows, values)
            scorer.delta_seq = int(to_delta_seq)
            self._delta_seq = int(to_delta_seq)
            # the explicit row state replaces whatever per-delta undo
            # history this registry held for the current version
            self._delta_log.clear()
            self._delta_log_truncated = False
            # the explicit row state replaces whatever per-delta undo
            # history this registry held for the current version
            self._delta_log.clear()
            self._delta_log_truncated = False
