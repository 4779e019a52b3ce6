"""OnlineUpdater: re-solve touched entities, publish row-level deltas (port
of photon_ml_tpu/online/updater.py).

The background loop of the online tier.  Each cycle it drains pending
entities from the FeedbackBuffer (per updatable coordinate), groups them
into the batched random-effect solver's padded layout — entity lanes fixed
at `micro_batch`, samples padded to a power-of-two S-bucket, exactly the
shape discipline training's RandomEffectDataset uses — and runs ONE
anchored batched solve (game/anchored.py) warm-started at the current
coefficients.  The changed rows then scatter into the live scorer as a
ModelDelta under the registry lock: no full-model cutover.  The port
compiles nothing: the solve is the host-stepped batched LBFGS over torch
`bmm`s (optim/batched.py), the blocks reach the device in ONE packed copy
in the scorer's table dtype, and the scatter is the scorer's out-of-place
`index_copy_`.  Every device operation runs on the default stream the
scoring threads share, so a table a delta replaces is freed only after
the scoring work queued before the swap.

Residual algebra: the anchored delta-space subproblem needs each row's
offset to be `base_offset + margin of every OTHER coordinate + x . c0`,
and since the full model margin already contains `x . c0`, that is simply
`base_offset + full-model margin` — one scorer.score() call per
micro-batch, no per-coordinate margin decomposition (see
game/anchored.py).

Containment mirrors chunk staging's discipline (utils/faults.py sites
`online.solve` / `online.publish`): transient failures retry with jittered
exponential backoff; a non-finite solved row FREEZES that entity (its
row never reaches the live table, later feedback for it is dropped and
counted) — quarantine, not poison.  A full-model swap racing a publish
surfaces as StaleDeltaError: the feedback re-enqueues and re-solves
against the new version next cycle.
"""
# photonlint: flush-point markers below: the updater thread's read-backs
# (margins through scorer.score, the solver's per-round convergence read,
# solved + prior rows) ARE its flush boundary — each cycle reads the solved
# and prior rows back in ONE copy per coordinate.
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import distributed
from photon_ml_tpu_torch.telemetry.timings import clock

from photon_ml_tpu_torch.game.anchored import lane_all_finite, solve_anchored
from photon_ml_tpu_torch.online.delta import CoordinateDelta, ModelDelta
from photon_ml_tpu_torch.online.feedback import (EntityFeedback, FeedbackBuffer,
                                           Observation)
from photon_ml_tpu_torch.ops import losses as L
from photon_ml_tpu_torch.optim import OptimizerConfig
from photon_ml_tpu_torch.parallel.random_effect import EntityBlocks
from photon_ml_tpu_torch.serving.registry import StaleDeltaError
from photon_ml_tpu_torch.serving.scorer import to_device
from photon_ml_tpu_torch.store.entity import _NUMPY_DTYPES, scatter_rows
from photon_ml_tpu_torch.utils import faults, locktrace
from photon_ml_tpu_torch.utils.math import ceil_pow2

logger = logging.getLogger("photon_ml_tpu")

#: padding label value valid for every loss family (mask zeroes the cell)
_SAFE_LABEL = 0.5


@dataclasses.dataclass(frozen=True)
class OnlineUpdateConfig:
    """Knobs of the online tier (cli.serve --enable-updates maps 1:1)."""

    micro_batch: int = 16           # entity lanes per anchored solve (pow-2)
    max_rows_per_entity: int = 64   # S ceiling (pow-2); newest rows win
    min_rows_bucket: int = 4        # smallest padded S-bucket
    anchor_weight: float = 1.0      # lambda of the ||c - c0||^2 prior pull
    max_iterations: int = 100       # per-entity LBFGS cap
    tolerance: float = 1e-9
    interval_s: float = 0.02        # idle poll period of the update loop
    max_pending_rows: int = 8192    # buffer bound -> Overloaded
    entity_window: int = 128        # per-entity coalescing window
    dedup_window: int = 8192        # event-id dedup window
    max_attempts: int = 3           # transient solve/publish retries
    backoff_s: float = 0.02         # base of the jittered exp backoff

    def __post_init__(self):
        if self.micro_batch < 1 or self.max_rows_per_entity < 1:
            raise ValueError("micro_batch and max_rows_per_entity must be "
                             ">= 1")
        if self.entity_window > self.max_rows_per_entity:
            # more window than solve capacity would silently discard the
            # overflow at solve time; clamp loudly instead
            object.__setattr__(self, "entity_window",
                               self.max_rows_per_entity)

    @property
    def lanes_pow2(self) -> int:
        return int(ceil_pow2(self.micro_batch))


class OnlineUpdater:
    """Accepts labeled feedback, re-solves ONLY the touched entities'
    anchored subproblems, and publishes delta swaps into the live scorer.

    `submit()` is the intake (thread-safe, called from request threads);
    `run_once()` is one drain-solve-publish cycle (the background loop
    calls it; tests and the bench call it directly for determinism)."""

    def __init__(self, registry, metrics=None,
                 config: OnlineUpdateConfig = OnlineUpdateConfig(),
                 emitter=None, health=None, feedback_log=None):
        """`health` (a health.HealthMonitor) receives per-delta magnitude
        and freeze vitals, and is what `pause()`/`resume()` exist for:
        the monitor's gates stop the update loop while the model is
        degrading and restart it on recovery.  `feedback_log` (a
        fleet.FeedbackLog) makes every admitted batch durable before
        intake returns — the refit compactor's complete replay source."""
        self.registry = registry
        self.metrics = metrics
        self.config = config
        self.emitter = emitter
        self.health = health
        self.feedback_log = feedback_log
        self.buffer = FeedbackBuffer(max_rows=config.max_pending_rows,
                                     entity_window=config.entity_window,
                                     dedup_window=config.dedup_window)
        self._solver = OptimizerConfig(max_iterations=config.max_iterations,
                                       tolerance=config.tolerance)
        # mutable updater state crosses three threads (request intake, the
        # background loop, operator introspection): everything below is
        # guarded by _state_lock, which the armed locktrace tracker
        # observes
        self._state_lock = locktrace.tracked(threading.Lock(),
                                             "OnlineUpdater._state_lock")
        self._frozen: set = set()    # (lane, entity_id)  # photonlint: guarded-by=_state_lock
        self._thread: Optional[threading.Thread] = None  # photonlint: guarded-by=_state_lock
        self.cycles = 0  # photonlint: guarded-by=_state_lock
        self.deltas_published = 0  # photonlint: guarded-by=_state_lock
        self.last_error: Optional[str] = None  # photonlint: guarded-by=_state_lock
        self._paused = False  # photonlint: guarded-by=_state_lock
        self.pause_reason: Optional[str] = None  # photonlint: guarded-by=_state_lock
        self._last_cycle_at: Optional[float] = None  # photonlint: guarded-by=_state_lock
        self._drain_rate: float = 0.0  # photonlint: guarded-by=_state_lock
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._jitter = random.Random(0xC0FFEE)
        self.warmed = False
        self.warmup_s = 0.0

    # -- intake -------------------------------------------------------------

    def submit(self, features: Dict[str, np.ndarray],
               ids: Dict[str, np.ndarray], labels: np.ndarray,
               weights: Optional[np.ndarray] = None,
               offsets: Optional[np.ndarray] = None,
               event_ids: Optional[List[str]] = None) -> Dict[str, int]:
        """Enqueue a labeled feedback batch (request-shaped: features per
        shard, raw ids per entity type, labels per row).  Returns intake
        accounting; raises Overloaded when the buffer is full.  Rows whose
        entity is unseen by a coordinate (no table row to anchor at) or
        frozen (quarantined by a non-finite solve) are dropped for that
        coordinate and counted."""
        scorer = self.registry.scorer
        n = scorer.validate_request(features, ids)
        labels = np.asarray(labels, np.float64)
        if labels.shape != (n,):
            raise ValueError(f"labels must be [{n}], got {labels.shape}")
        weights_a = (np.ones(n) if weights is None
                     else np.asarray(weights, np.float64))
        offsets_a = (np.zeros(n) if offsets is None
                     else np.asarray(offsets, np.float64))
        for name, a in (("weights", weights_a), ("offsets", offsets_a)):
            if a.shape != (n,):
                raise ValueError(f"{name} must be [{n}], got {a.shape}")
        if event_ids is not None and len(event_ids) != n:
            raise ValueError(f"event_ids must have {n} entries, got "
                             f"{len(event_ids)}")
        feats = {s: np.asarray(x) for s, x in features.items()}
        now = clock()
        wall_now = time.time()
        trace_id = distributed.current_request_id()
        entries: List[Tuple[str, object, int, Observation]] = []
        unseen = frozen = 0
        lane_meta = scorer.updatable_coordinates()
        # one coherent snapshot of the quarantine set for the whole batch
        # (the updater thread freezes entities concurrently)
        with self._state_lock:
            frozen_now = set(self._frozen)
        for i in range(n):
            obs = Observation(
                features={s: feats[s][i] for s in feats},
                ids={t: np.asarray(ids[t])[i] for t in ids},
                label=float(labels[i]), weight=float(weights_a[i]),
                offset=float(offsets_a[i]), enqueued_at=now,
                event_id=None if event_ids is None else event_ids[i],
                trace_id=trace_id, enqueued_wall_s=wall_now)
            for lane, _shard, re_type in lane_meta:
                entity_id = obs.ids.get(re_type)
                row = scorer.entity_row(lane, entity_id)
                if row < 0:
                    unseen += 1
                    continue
                if (lane, entity_id) in frozen_now:
                    frozen += 1
                    continue
                entries.append((lane, entity_id, row, obs))
        try:
            out = self.buffer.offer_batch(entries)
        except Exception:
            if self.metrics is not None:
                self.metrics.observe_feedback_shed()
            raise
        if self.feedback_log is not None:
            # durable BEFORE intake returns: an admitted batch the refit
            # compactor can never replay is an admitted batch lost to the
            # next full refit
            self._persist_feedback_with_retry(
                feats, ids, labels, weights_a, offsets_a,
                event_ids=event_ids, trace_id=trace_id, wall_s=wall_now)
        out.update({"rows": n, "dropped_unseen": unseen,
                    "dropped_frozen": frozen})
        if self.metrics is not None:
            self.metrics.observe_feedback(
                rows=n, lane_rows=out["accepted"], unseen=unseen,
                frozen=frozen, deduped=out["deduped"],
                coalesced=out["coalesced"])
        self._wake.set()
        return out

    # -- warmup -------------------------------------------------------------

    def warmup(self) -> float:
        """Run every shape an update cycle can meet once — the anchored
        batched solve at each pow-2 S-bucket, the prior gather/mask chain,
        and the delta scatter at each pow-2 row count — before the first
        drain (the online twin of CompiledScorer.warmup; the background
        loop runs this first).  The JAX package compiles its programs
        here; the port compiles nothing, so this warms the allocator and
        the libraries the cycle calls, and callers still wait on
        `warmed`."""
        cfg = self.config
        scorer = self.registry.scorer
        t0 = clock()
        E = cfg.lanes_pow2
        with telemetry.span("online_warmup"):
            for lane, shard, _re_type in scorer.updatable_coordinates():
                d = scorer.feature_shards[shard]
                table = scorer.re_table(lane)
                # the prior prep chain (gather on the table -> mask), as a
                # cycle runs it
                rows0 = np.zeros(E, np.int64)
                prior = self._masked_prior(scorer, lane, rows0,
                                           torch.ones(E, dtype=torch.bool,
                                                      device=table.device))
                S = int(ceil_pow2(cfg.min_rows_bucket))
                s_max = int(ceil_pow2(cfg.max_rows_per_entity))
                while True:
                    blocks = EntityBlocks(
                        x=torch.zeros((E, S, d), dtype=table.dtype,
                                      device=table.device),
                        labels=torch.full((E, S), _SAFE_LABEL,
                                          dtype=table.dtype,
                                          device=table.device),
                        mask=torch.zeros((E, S), dtype=table.dtype,
                                         device=table.device),
                        weights=torch.zeros((E, S), dtype=table.dtype,
                                            device=table.device),
                        offsets=torch.zeros((E, S), dtype=table.dtype,
                                            device=table.device))
                    new_rows, _res = solve_anchored(
                        blocks, prior, self._loss(), self._solver,
                        cfg.anchor_weight)
                    lane_all_finite(new_rows).cpu()
                    if S >= s_max:
                        break
                    S <<= 1
                # one scatter per pow-2 delta row count (results discarded
                # — the live table is never touched)
                k = 1
                while k <= E:
                    rows = np.arange(min(k, table.shape[0]), dtype=np.int64)
                    vals = np.zeros((len(rows), table.shape[1]))
                    scatter_rows(table, rows, vals)[:1].cpu()
                    k <<= 1
        self.warmup_s = clock() - t0
        self.warmed = True
        return self.warmup_s

    # -- the update cycle ---------------------------------------------------

    def run_once(self) -> Dict[str, int]:
        """One drain-solve-publish cycle over every coordinate with
        pending feedback.  Returns {"entities": ..., "rows": ...,
        "deltas": ...} for what was published.  A no-op while paused
        (health gate / operator): pending feedback stays buffered."""
        totals = {"entities": 0, "rows": 0, "deltas": 0}
        if self.paused:
            return totals
        t0 = clock()
        scorer = self.registry.scorer  # ONE version for the whole cycle
        for lane, shard, re_type in scorer.updatable_coordinates():
            if self.buffer.pending_entities(lane) == 0:
                continue
            drained = self.buffer.drain(lane, self.config.micro_batch)
            if not drained:
                continue
            # the propagated request ids this cycle aggregates: the span
            # attr (and the delta's replication-trace metadata) is what
            # lets `cli.trace merge` stitch a /feedback request through
            # the asynchronous cycle into one tree
            trace_ids, oldest_wall = self._trace_meta(drained)
            with telemetry.span("online_update", coordinate=lane,
                                entities=len(drained),
                                request_ids=",".join(trace_ids)):
                published = self._solve_and_publish(
                    scorer, lane, shard, drained,
                    trace_ids=trace_ids, oldest_wall=oldest_wall)
            if published:
                totals["entities"] += published["entities"]
                totals["rows"] += published["rows"]
                totals["deltas"] += 1
        cycle_s = clock() - t0
        with self._state_lock:
            self._last_cycle_at = clock()
            if totals["rows"] and cycle_s > 0:
                # EMA of lane-rows drained per second: what the 429
                # Retry-After derivation divides the backlog by
                rate = totals["rows"] / cycle_s
                self._drain_rate = (rate if self._drain_rate == 0.0 else
                                    0.7 * self._drain_rate + 0.3 * rate)
        return totals

    def flush(self, max_cycles: int = 1000) -> Dict[str, int]:
        """Drain the buffer to empty (tests / bench determinism)."""
        totals = {"entities": 0, "rows": 0, "deltas": 0}
        for _ in range(max_cycles):
            if not self.buffer.lanes() or self.paused:
                break
            out = self.run_once()
            for k in totals:
                totals[k] += out[k]
            if out["deltas"] == 0 and out["entities"] == 0:
                break  # nothing publishable remains (all frozen/stale)
        return totals

    # -- health gating --------------------------------------------------------

    def pause(self, reason: Optional[str] = None) -> None:
        """Stop publishing updates (the loop idles; `submit` keeps
        buffering so recovery detection still sees labels).  Idempotent."""
        with self._state_lock:
            if self._paused:
                return
            self._paused = True
            self.pause_reason = reason
        telemetry.event("online_updates_paused", reason=str(reason))
        logger.warning("online updates PAUSED (%s)", reason)

    def resume(self) -> None:
        """Resume publishing; buffered feedback drains on the next cycle."""
        with self._state_lock:
            if not self._paused:
                return
            self._paused = False
            self.pause_reason = None
        telemetry.event("online_updates_resumed")
        logger.info("online updates resumed")
        self._wake.set()

    @property
    def paused(self) -> bool:
        with self._state_lock:
            return self._paused

    def retry_after_s(self) -> float:
        """How long a 429'd feedback client should wait before retrying,
        derived from the updater's observed drain rate: the pending
        backlog divided by the EMA of lane-rows drained per second
        (clamped to [interval_s, 30]).  Before the first drain there is
        no rate yet — the poll interval is the honest floor."""
        pending = self.buffer.pending_rows
        with self._state_lock:
            rate = self._drain_rate
        if rate <= 0.0:
            return max(self.config.interval_s, 0.05)
        return float(min(max(pending / rate, self.config.interval_s, 0.05),
                         30.0))

    def last_cycle_age_s(self) -> Optional[float]:
        """Seconds since the last completed update cycle (None before
        the first)."""
        with self._state_lock:
            last = self._last_cycle_at
        return None if last is None else clock() - last

    def alive(self) -> bool:
        """Is the background loop thread running?  (False under manual
        `run_once()` driving — tests/bench — and after close().)"""
        with self._state_lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    def probe(self) -> Dict[str, object]:
        """Live vitals for the metric surfaces and /healthz (refreshed at
        render by ServingMetrics._refresh_online_gauges)."""
        with self._state_lock:
            frozen = len(self._frozen)
            paused = self._paused
            reason = self.pause_reason
            last = self._last_cycle_at
            thread = self._thread
        return {"frozen": frozen, "paused": paused, "pause_reason": reason,
                "alive": thread is not None and thread.is_alive(),
                "last_cycle_age_s": (None if last is None
                                     else clock() - last)}

    #: distinct request ids carried per update cycle / delta record (the
    #: trace metadata is a sample, not an unbounded join table)
    MAX_TRACE_IDS = 16

    @classmethod
    def _trace_meta(cls, drained: List[EntityFeedback]):
        """-> (distinct propagated request ids, oldest intake wall time)
        across the drained entities' observations."""
        ids: List[str] = []
        seen = set()
        oldest = None
        for ef in drained:
            for obs in ef.observations:
                w = obs.enqueued_wall_s
                if w and (oldest is None or w < oldest):
                    oldest = w
                t = obs.trace_id
                if t and t not in seen and len(ids) < cls.MAX_TRACE_IDS:
                    seen.add(t)
                    ids.append(t)
        return ids, oldest

    def _blocks_for(self, scorer, lane: str, shard: str,
                    drained: List[EntityFeedback]):
        """Drained entities -> the batched solver's padded layout:
        [micro_batch lanes, pow-2 S, d] blocks + the flat request that
        prices every real row's full-model margin.  Built on the host in
        float64 and sent in ONE packed copy in the table's dtype, with
        the lanes' row-valid flags; returns (blocks, host table rows with
        -1 on empty lanes, the device row-valid flags, real rows)."""
        cfg = self.config
        E = cfg.lanes_pow2
        d = scorer.feature_shards[shard]
        s_real = max(len(ef.observations) for ef in drained)
        S = int(min(max(int(ceil_pow2(s_real)), cfg.min_rows_bucket),
                    int(ceil_pow2(cfg.max_rows_per_entity))))
        x = np.zeros((E, S, d))
        labels = np.full((E, S), _SAFE_LABEL)
        mask = np.zeros((E, S))
        weights = np.zeros((E, S))
        offsets = np.zeros((E, S))
        flat_feats = {s: [] for s in scorer.feature_shards}
        flat_ids = {t: [] for t in scorer.entity_types}
        cells: List[Tuple[int, int]] = []
        for e, ef in enumerate(drained):
            obs_list = ef.observations[-cfg.max_rows_per_entity:]
            for s, obs in enumerate(obs_list):
                x[e, s] = obs.features[shard]
                labels[e, s] = obs.label
                mask[e, s] = 1.0
                weights[e, s] = obs.weight
                offsets[e, s] = obs.offset
                for sh in flat_feats:
                    flat_feats[sh].append(obs.features[sh])
                for t in flat_ids:
                    flat_ids[t].append(obs.ids[t])
                cells.append((e, s))
        feats = {s: np.stack(v) for s, v in flat_feats.items()}
        ids = {t: np.asarray(v, dtype=object) for t, v in flat_ids.items()}
        # full-model margins against THIS scorer version: own-coordinate
        # contribution included, which is exactly the delta-space fold
        margins = scorer.score(feats, ids).scores
        for (e, s), m in zip(cells, margins):
            offsets[e, s] += m
        rows = np.full(E, -1, np.int64)
        rows[:len(drained)] = [ef.row for ef in drained]
        table = scorer.re_table(lane)
        np_dtype = _NUMPY_DTYPES[table.dtype]
        dev = to_device({"x": x.astype(np_dtype),
                         "labels": labels.astype(np_dtype),
                         "mask": mask.astype(np_dtype),
                         "weights": weights.astype(np_dtype),
                         "offsets": offsets.astype(np_dtype),
                         "valid": rows >= 0}, table.device)
        blocks = EntityBlocks(
            x=dev["x"], labels=dev["labels"], mask=dev["mask"],
            weights=dev["weights"], offsets=dev["offsets"])
        return blocks, rows, dev["valid"], len(cells)

    @staticmethod
    def _masked_prior(scorer, lane: str, rows: np.ndarray,
                      valid: torch.Tensor) -> torch.Tensor:
        """The lanes' current rows (clamped gather: a -1 lane never
        addresses the table, which on CUDA would be a device assert),
        zeroed on lanes with no entity."""
        prior = scorer.gather_rows(lane, np.maximum(rows, 0))
        return torch.where(valid[:, None], prior, torch.zeros_like(prior))

    def _persist_feedback_with_retry(self, feats, ids, labels, weights,
                                     offsets, *, event_ids, trace_id,
                                     wall_s) -> int:
        """Append one admitted batch to the durable feedback lane under
        the standard transient retry/backoff discipline (the lane's
        `replog.append` fault site fires with kind="feedback"), then
        refresh the fleet.log_records/log_bytes gauges."""
        from photon_ml_tpu_torch.fleet.replog import record_for_feedback
        cfg = self.config
        rec = record_for_feedback(feats, ids, labels, weights, offsets,
                                  event_ids=event_ids, trace_id=trace_id,
                                  wall_s=wall_s)
        attempt = 0
        while True:
            attempt += 1
            try:
                seq = self.feedback_log.append(rec)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise
                telemetry.event("online_feedback_log_retry",
                                attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))
        if self.metrics is not None:
            self.metrics.observe_feedback_log(
                records=self.feedback_log.live_records(),
                bytes=self.feedback_log.live_bytes())
        return seq

    def _solve_with_retry(self, lane: str, blocks, prior):
        """The anchored solve under the staging retry discipline:
        transient failures back off and retry; `poison` corrupts the
        solved rows so the freeze path is exercised end to end."""
        cfg = self.config
        attempt = 0
        while True:
            attempt += 1
            try:
                action = faults.fire("online.solve", coordinate=lane)
                new_rows, res = solve_anchored(
                    blocks, prior, self._loss(), self._solver,
                    cfg.anchor_weight)
                if action == "poison":
                    new_rows = new_rows * float("nan")
                # the cycle's one batched read-back: solved and prior rows
                # in a single copy; the finite flags are lane_all_finite's
                # predicate on the host copy
                both = torch.stack([new_rows, prior]).cpu().numpy()  # photonlint: disable=PH001 -- the cycle's one batched readback: solved rows + prior rows (+ finite flags on the host)
                finite = np.isfinite(both[0]).all(axis=-1)
                return both[0], both[1], finite, res
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise
                if self.metrics is not None:
                    self.metrics.observe_solve_retry()
                telemetry.event("online_solve_retry", coordinate=lane,
                                attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    def _note_error(self, exc: BaseException) -> str:
        msg = f"{type(exc).__name__}: {exc}"
        with self._state_lock:
            self.last_error = msg
        return msg

    def _loss(self):
        task = self.registry.scorer.model.task_type
        loss = L.TASK_LOSSES.get(task)
        if loss is None:
            raise ValueError(f"task {task!r} has no pointwise loss to "
                             "refit against")
        return loss

    def _solve_and_publish(self, scorer, lane: str, shard: str,
                           drained: List[EntityFeedback],
                           trace_ids: Optional[List[str]] = None,
                           oldest_wall: Optional[float] = None
                           ) -> Optional[Dict[str, int]]:
        cfg = self.config
        t0 = clock()
        blocks, rows, valid, num_rows = self._blocks_for(scorer, lane,
                                                         shard, drained)
        prior = self._masked_prior(scorer, lane, rows, valid)
        try:
            new_rows, prior_np, finite, _res = self._solve_with_retry(
                lane, blocks, prior)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            # a fatal solve failure drops the micro-batch: re-enqueueing
            # would retry a deterministic failure forever
            msg = self._note_error(e)
            if self.metrics is not None:
                self.metrics.observe_solve_failure()
            telemetry.event("online_solve_failed", coordinate=lane,
                            error=msg)
            logger.warning("online solve failed for %r: %s", lane, msg)
            return None
        if self.metrics is not None:
            self.metrics.observe_update_cycle(entities=len(drained),
                                              rows=num_rows)
        keep_rows, keep_values, keep_prior, latencies = [], [], [], []
        now = clock()
        for e, ef in enumerate(drained):
            if not finite[e]:
                # quarantine: the non-finite row NEVER reaches the live
                # table; the entity freezes until an operator full-refit
                with self._state_lock:
                    self._frozen.add((lane, ef.entity_id))
                self.buffer.drop_entity(lane, ef.entity_id)
                if self.metrics is not None:
                    self.metrics.observe_frozen_entity()
                if self.health is not None:
                    self.health.observe_freeze(lane)
                telemetry.event("online_quarantine", coordinate=lane,
                                entity=str(ef.entity_id))
                logger.warning("online solve for %r entity %r produced "
                               "non-finite coefficients: entity FROZEN "
                               "(live table untouched)", lane, ef.entity_id)
                continue
            keep_rows.append(ef.row)
            keep_values.append(new_rows[e])
            keep_prior.append(prior_np[e])
            latencies.append(now - ef.first_enqueued_at)
        if not keep_rows:
            return None
        if self.paused:
            # a health gate paused us MID-CYCLE (and may be rolling the
            # pending deltas back): rows solved against the pre-pause
            # state must not land after the rollback — requeue them and
            # let the post-recovery cycle re-solve against whatever
            # model is live then
            self.buffer.requeue(lane, drained)
            telemetry.event("online_publish_skipped_paused",
                            coordinate=lane)
            return None
        delta = ModelDelta(
            base_version=scorer.version, seq=self.registry.next_delta_seq(),
            coordinates={lane: CoordinateDelta(
                rows=np.asarray(keep_rows, np.int64),
                values=np.stack(keep_values),
                prior=np.stack(keep_prior))},
            created_at=time.time(),
            trace={"request_ids": list(trace_ids or ()),
                   "parent": distributed.span_ref(
                       telemetry.current_span_id()),
                   "enqueued_wall_s": oldest_wall})
        try:
            self._publish_with_retry(lane, delta, t0)
        except StaleDeltaError:
            # a full swap landed between solve and publish: the rows were
            # solved against a superseded model — re-enqueue and re-solve
            # against the new version next cycle
            if self.metrics is not None:
                self.metrics.observe_stale_delta()
            telemetry.event("online_stale_delta", coordinate=lane,
                            base_version=str(delta.base_version))
            self.buffer.requeue(lane, drained)
            self._wake.set()
            return None
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            msg = self._note_error(e)
            if self.metrics is not None:
                self.metrics.observe_solve_failure()
            telemetry.event("online_publish_failed", coordinate=lane,
                            error=msg)
            logger.warning("online publish failed for %r: %s (feedback "
                           "re-enqueued)", lane, msg)
            self.buffer.requeue(lane, drained)
            return None
        if self.metrics is not None:
            for lat in latencies:
                self.metrics.observe_feedback_to_publish(lat)
        if self.health is not None:
            # delta-magnitude vitals: L2 of each published row's move away
            # from its prior (the health monitor gates on the window max)
            self.health.observe_published(
                lane, np.linalg.norm(
                    np.stack(keep_values) - np.stack(keep_prior), axis=1))
        with self._state_lock:
            self.deltas_published += 1
        return {"entities": len(keep_rows), "rows": num_rows}

    def _publish_with_retry(self, lane: str, delta: ModelDelta,
                            t0: float) -> None:
        cfg = self.config
        attempt = 0
        while True:
            attempt += 1
            try:
                self.registry.apply_delta(delta, publish_s=clock() - t0)
                return
            except (KeyboardInterrupt, SystemExit, StaleDeltaError):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise
                if self.metrics is not None:
                    self.metrics.observe_publish_retry()
                telemetry.event("online_publish_retry", coordinate=lane,
                                attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    # -- introspection ------------------------------------------------------

    def frozen_entities(self) -> List[Tuple[str, object]]:
        with self._state_lock:
            return sorted(self._frozen, key=str)

    def stats(self) -> Dict[str, object]:
        buffer_stats = self.buffer.stats()   # buffer takes its own lock
        with self._state_lock:
            return {"cycles": self.cycles,
                    "deltas_published": self.deltas_published,
                    "frozen": len(self._frozen),
                    "paused": self._paused,
                    "pause_reason": self.pause_reason,
                    "buffer": buffer_stats,
                    "last_error": self.last_error}

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        # test and spawn under the lock: two racing start() calls must
        # not each launch a loop thread
        with self._state_lock:
            if self._thread is not None:
                return
            self._closed.clear()
            thread = threading.Thread(target=self._loop, daemon=True,
                                      name="photon-online-updater")
            self._thread = thread
        thread.start()

    def _loop(self) -> None:
        try:
            if not self.warmed:
                self.warmup()
        except Exception as e:  # a failed warmup must not kill the loop
            logger.exception("online updater warmup failed: %s",
                             self._note_error(e))
        while not self._closed.is_set():
            self._wake.wait(timeout=self.config.interval_s)
            self._wake.clear()
            if self._closed.is_set():
                break
            try:
                while self.buffer.lanes() and not self._closed.is_set():
                    with self._state_lock:
                        self.cycles += 1
                    out = self.run_once()
                    if out["deltas"] == 0 and out["entities"] == 0:
                        break  # nothing publishable; wait for fresh rows
            except Exception as e:  # the loop must never die silently
                logger.exception("online update cycle failed: %s",
                                 self._note_error(e))
                if self.metrics is not None:
                    self.metrics.observe_solve_failure()

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._wake.set()
        # detach under the lock, join OUTSIDE it: the loop thread takes
        # _state_lock (cycle counters, freezes), so joining while holding
        # it would deadlock
        with self._state_lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
