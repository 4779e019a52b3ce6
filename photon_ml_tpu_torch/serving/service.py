"""ScoringService: the assembled in-process online scorer (port of
photon_ml_tpu/serving/service.py).

Wires the pieces together: a ModelRegistry holding the live CompiledScorer,
a MicroBatcher coalescing concurrent `score()` calls into padded device
batches, and ServingMetrics + ScoringBatchEvent observability.  This is the
object the serve CLI (and any embedding process) talks to:

    svc = ScoringService(model_dir="out/best")          # on cuda, float32
    scores = svc.score({"global": x, "per_user": xu},
                       {"userId": ids}, timeout=0.05)
    svc.swap("out/next")        # zero-downtime hot swap
    svc.rollback()              # back to the previous version
    svc.metrics_snapshot()      # JSON observability
"""
from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.serving.batcher import (BatcherConfig, MicroBatcher,
                                                 ServingError)
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.registry import ModelRegistry
from photon_ml_tpu_torch.serving.scorer import CompiledScorer
from photon_ml_tpu_torch.utils import locktrace
from photon_ml_tpu_torch.utils.events import EventEmitter, ScoringBatchEvent


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Service knobs (CLI flags map 1:1 onto these)."""

    max_wait_s: float = 0.002       # micro-batch coalescing window
    max_batch: int = 1024           # rows per device call (pow-2 rounded)
    max_queue: int = 4096           # pending requests before shedding
    min_bucket: int = 8             # smallest padded batch bucket
    default_timeout_s: Optional[float] = None  # per-request deadline
    latency_window: int = 8192      # latency ring for percentiles
    max_delta_log: int = 4096       # delta undo-log bound (overflow ->
                                    # rollback degrades to full-model)
    # tiered entity store (photon_ml_tpu_torch/store/): a non-None budget
    # serves every RE table through a device hot set of store_budget_rows
    # rows, a host warm tier, and sealed cold segments under store_dir
    # (REQUIRED with a budget; each installed version gets a subdir)
    store_budget_rows: Optional[int] = None
    store_dir: Optional[str] = None
    store_warm_segments: int = 64
    store_seg_rows: int = 16384
    # entity-sharded serving (fleet/shards.py): a non-None shard_count
    # makes every scorer this service builds hold ONLY shard
    # shard_index's slice of the random-effect entity space (FE/MF
    # coordinates replicate in full), filter replicated deltas to owned
    # rows, and warm the score_margins() fan-out path
    shard_index: Optional[int] = None
    shard_count: Optional[int] = None
    shard_salt: str = "photon"
    shard_version: int = 1
    # where every scorer this service builds lives (None = cuda, which
    # raises without CUDA) and the dtype its tables are loaded in
    device: Optional[str] = None
    dtype: torch.dtype = torch.float32


class ScoringService:
    def __init__(self, model_dir: Optional[str] = None,
                 model=None, config: Optional[ServingConfig] = None,
                 emitter: Optional[EventEmitter] = None,
                 updates=None, start_updater: bool = True,
                 health=None, feedback_log_dir: Optional[str] = None):
        """Serve `model_dir` (any layout the port's models/io.py reads) or
        an in-memory `model` whose tensors the scorer copies onto the
        config's device.

        `updates` (an online.OnlineUpdateConfig) enables the online
        learning tier: `feedback()` accepts labeled observations and a
        background OnlineUpdater re-solves ONLY the touched entities'
        random-effect subproblems, publishing row-level delta swaps into
        the live scorer.  `start_updater=False` keeps the updater manual
        (tests and chip_smoke.py drive `service.updater.run_once()`
        themselves).

        `health` (a health.HealthConfig) arms the model-health monitor:
        streaming calibration over feedback-joined labels, score-
        distribution drift vs a per-install baseline, and gates that
        flip /healthz to degraded, pause the updater, and optionally
        trigger the delta-aware rollback (cli.serve --health-config).

        `feedback_log_dir` arms the durable feedback lane
        (fleet.FeedbackLog): every admitted `feedback()` batch is
        persisted with the replication log's sha256/torn-tail discipline
        before intake returns, so a refit compactor
        (photon_ml_tpu_torch/refit/) can replay the fleet's own exhaust
        into training chunks.  Requires `updates`."""
        if (model_dir is None) == (model is None):
            raise ValueError("pass exactly one of model_dir / model")
        # refused before any thread starts, so a refusal leaks none
        from photon_ml_tpu_torch.health import HealthConfig, HealthMonitor
        if health is not None and not isinstance(health, HealthConfig):
            raise TypeError("health must be a health.HealthConfig, got "
                            f"{type(health).__name__}")
        if feedback_log_dir is not None and updates is None:
            raise ValueError("feedback_log_dir requires updates (the "
                             "feedback lane persists the online intake)")
        self.config = config or ServingConfig()
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.emitter = emitter
        self.metrics = ServingMetrics(cfg.latency_window)
        self.health = None
        if health is not None:
            self.health = HealthMonitor(health, metrics=self.metrics)

        self.shard = None
        if (cfg.shard_index is None) != (cfg.shard_count is None):
            raise ValueError("shard_index and shard_count come together "
                             "(cli.serve --shard K/N)")
        if cfg.shard_count is not None:
            from photon_ml_tpu_torch.fleet.shards import (ShardAssignment,
                                                          ShardSpec)
            self.shard = ShardAssignment(
                spec=ShardSpec(num_shards=cfg.shard_count,
                               salt=cfg.shard_salt,
                               version=cfg.shard_version),
                index=cfg.shard_index)
            if updates is not None:
                raise ValueError(
                    "a sharded service cannot run the online updater: "
                    "deltas are solved on the (full-model) publisher and "
                    "replicate shard-filtered through the log")

        store_cfg = None
        if cfg.store_budget_rows is not None:
            if cfg.store_dir is None:
                raise ValueError("store_budget_rows requires store_dir "
                                 "(the cold tier's segment directory)")
            from photon_ml_tpu_torch.store import StoreConfig
            store_cfg = StoreConfig(hot_rows=cfg.store_budget_rows,
                                    warm_segments=cfg.store_warm_segments,
                                    seg_rows=cfg.store_seg_rows)

        def _store_kw(version):
            if store_cfg is None:
                return {}
            sub = re.sub(r"[^A-Za-z0-9._-]", "_", str(version))
            return {"store": store_cfg,
                    "store_dir": os.path.join(cfg.store_dir, sub)}

        def factory(version_dir, version):
            if version_dir is None:  # initial in-memory model
                scorer = CompiledScorer(model, max_batch=cfg.max_batch,
                                        min_bucket=cfg.min_bucket,
                                        version=version, shard=self.shard,
                                        device=self.device,
                                        **_store_kw(version))
                scorer.warmup()
                return scorer
            return CompiledScorer.from_model_dir(
                version_dir, max_batch=cfg.max_batch,
                min_bucket=cfg.min_bucket, version=version,
                shard=self.shard, device=self.device, dtype=cfg.dtype,
                **_store_kw(version))

        self.registry = ModelRegistry(factory, emitter=emitter,
                                      metrics=self.metrics,
                                      max_delta_log=cfg.max_delta_log)
        # the fan-out margins path bypasses the micro-batcher (its legs
        # are already device-batch-shaped by the front); this lock gives
        # it the batcher's one-scoring-thread-at-a-time guarantee, which
        # is what the tiered store's staging bookkeeping assumes
        self._margins_lock = locktrace.tracked(
            threading.Lock(), "ScoringService._margins_lock")
        if store_cfg is not None:
            # both metric surfaces sync the store.* counters to the live
            # scorer's cumulative tier totals at render
            self.metrics.set_store_probe(
                lambda: self.registry.scorer.store_totals())
        if self.shard is not None:
            self.metrics.set_shard_probe(
                lambda: self.registry.scorer.shard_info())
        if self.health is not None:
            # registered BEFORE the initial load so the first install
            # stamps the version and starts the drift baseline
            self.registry.add_swap_hook(self.health.on_model_event)
        self.registry.load(model_dir, version=None if model_dir else "inline@1")
        self._batcher = MicroBatcher(
            self._score_batch,
            BatcherConfig(max_wait_s=cfg.max_wait_s, max_batch=cfg.max_batch,
                          max_queue=cfg.max_queue),
            on_shed=self.metrics.observe_shed,
            on_deadline=self.metrics.observe_deadline)
        self.updater = None
        self.feedback_log = None
        if updates is not None:
            from photon_ml_tpu_torch.online import OnlineUpdater
            if feedback_log_dir is not None:
                from photon_ml_tpu_torch.fleet.replog import FeedbackLog
                self.feedback_log = FeedbackLog(feedback_log_dir)
                self.feedback_log.recover()
            self.updater = OnlineUpdater(self.registry,
                                         metrics=self.metrics,
                                         config=updates, emitter=emitter,
                                         health=self.health,
                                         feedback_log=self.feedback_log)
            self.metrics.set_online_probe(self.updater.probe)
            if start_updater:
                self.updater.start()
        if self.health is not None:
            self.health.bind(registry=self.registry, updater=self.updater,
                             task_type=self.registry.scorer.model.task_type)
        self._closed = False
        # one telemetry.snapshot() returns serving state alongside the
        # training/streaming registries (latest-constructed service wins
        # the name; close() unregisters)
        telemetry.register_collector("serving", self.metrics_snapshot)

    # -- scoring -----------------------------------------------------------

    def score(self, features: Dict[str, np.ndarray],
              ids: Optional[Dict[str, np.ndarray]] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        """Margins for one request (batched with concurrent callers).
        Raises Overloaded / DeadlineExceeded under load, ValueError on a
        malformed request."""
        ids = ids or {}
        # validate against the CURRENT scorer before queueing so malformed
        # requests fail their caller alone, never a whole device batch
        n = self.registry.scorer.validate_request(features, ids)
        if timeout is None:
            timeout = self.config.default_timeout_s
        t0 = time.monotonic()
        try:
            scores = self._batcher.score(features, ids, n, timeout=timeout)
        except ServingError:
            raise  # shed/deadline already counted by the batcher hooks
        except Exception:
            self.metrics.observe_error()
            raise
        self.metrics.observe_request(time.monotonic() - t0, n)
        return scores

    def predict(self, features, ids=None, offsets=None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Mean predictions (inverse link), like GameModel.predict."""
        scores = self.score(features, ids, timeout=timeout)
        return self.registry.scorer.mean_prediction(scores, offsets)

    def score_margins(self, features: Dict[str, np.ndarray],
                      ids: Optional[Dict[str, np.ndarray]] = None) -> Dict:
        """One leg of a sharded fan-out request: per-coordinate margins
        from this replica's slice of the entity space, in the scorer's
        fold order (POST /margins; the front merges legs with
        fleet.shards.merge_margins).  Unowned/unseen entities contribute
        exactly 0.0 to their coordinate's margin — the owner's leg holds
        the real contribution.  Serialized by a dedicated lock rather
        than the micro-batcher: legs arrive pre-batched by the front."""
        ids = ids or {}
        # resolved OUTSIDE _margins_lock: the registry property takes the
        # registry lock, and a swap landing mid-request is caught by the
        # front's cross-leg version check either way
        scorer = self.registry.scorer
        n = scorer.validate_request(features, ids)
        t0 = time.monotonic()
        try:
            with self._margins_lock:
                with telemetry.span("serve_margins", rows=n,
                                    version=scorer.version):
                    margins = scorer.score_margins(features, ids)
        except Exception:
            self.metrics.observe_error()
            raise
        self.metrics.observe_request(time.monotonic() - t0, n)
        return {"margins": margins,
                "coordinates": scorer.coordinate_meta(),
                "model_version": scorer.version,
                "task_type": scorer.model.task_type,
                "shard": scorer.shard_info()}

    def _score_batch(self, features, ids, *, num_requests: int,
                     queue_wait_s: float):
        scorer = self.registry.scorer  # resolved per batch: swap boundary
        t0 = time.monotonic()
        # span on the micro-batcher worker thread: serving gets its own
        # track in the trace, one span per coalesced device batch
        with telemetry.span("serve_batch", requests=num_requests,
                            version=scorer.version):
            result = scorer.score(features, ids)
        score_s = time.monotonic() - t0
        self.metrics.observe_batch(
            rows=result.num_rows, bucket_rows=sum(result.buckets),
            num_requests=num_requests, entity_hits=result.entity_hits,
            entity_lookups=result.entity_lookups,
            new_compiles=result.new_compiles,
            queue_wait_s=queue_wait_s, score_s=score_s)
        if self.emitter is not None:
            self.emitter.send_event(ScoringBatchEvent(
                time=time.time(), num_requests=num_requests,
                num_rows=result.num_rows, bucket_size=max(result.buckets),
                queue_wait_s=queue_wait_s, score_s=score_s,
                model_version=scorer.version))
        if self.health is not None:  # faults.fire()-style disarm: one
            # None check when health is off, one histogram add per BATCH on
            self.health.observe_scores(result.scores)
        return result

    # -- online updates ----------------------------------------------------

    def feedback(self, features: Dict[str, np.ndarray],
                 ids: Dict[str, np.ndarray], labels: np.ndarray,
                 weights=None, offsets=None, event_ids=None) -> Dict:
        """Enqueue labeled feedback for the online tier: the touched
        entities' random-effect rows re-solve in the background and
        publish as delta swaps.  Raises Overloaded under backpressure
        (with `retry_after_s` stamped from the updater's drain rate);
        RuntimeError when updates are not enabled."""
        if self.updater is None:
            raise RuntimeError(
                "online updates are not enabled — construct the service "
                "with updates=OnlineUpdateConfig() (or cli.serve "
                "--enable-updates)")
        from photon_ml_tpu_torch.serving.batcher import Overloaded
        try:
            out = self.updater.submit(features, ids, labels,
                                      weights=weights, offsets=offsets,
                                      event_ids=event_ids)
        except Overloaded as e:
            # whole-batch rejection surfaced to the caller: count it on
            # both metric surfaces and stamp the backpressure hint the
            # HTTP layer turns into a Retry-After header (derived from
            # the updater's observed drain rate)
            self.metrics.observe_feedback_rejected()
            e.retry_after_s = self.updater.retry_after_s()
            raise
        if self.health is not None:
            # the delayed-label join: score the admitted batch once through
            # the live scorer and feed calibration/loss/AUC
            self.health.observe_feedback(
                self.registry.scorer, features, ids, labels,
                weights=weights, offsets=offsets)
        return out

    def version_vector(self) -> Dict:
        """(full-model version, delta seq): the staleness identity of the
        live scorer."""
        return self.registry.version_vector()

    def audit(self) -> Dict:
        """The fleet convergence audit: version vector + per-table sha256
        of the live scorer's exact device bytes.  Two replicas whose
        audits agree converged bit-identically (GET /fleet/audit)."""
        return {"version_vector": self.version_vector(),
                "table_hashes": self.registry.scorer.table_hashes()}

    def healthz(self) -> Dict:
        """The /healthz payload: overall status (degraded when a health
        gate is tripped), the version vector, updater vitals (thread
        liveness, last-cycle age, frozen entities, pause state, pending
        rows), the shard identity of a sharded service, the tiered store's
        hit rate when the model serves through it, and the per-gate health
        verdict."""
        out = {
            "status": "ok",
            "model_version": self.model_version,
            "version_vector": self.version_vector(),
            "updates_enabled": self.updater is not None,
            "health_enabled": self.health is not None,
        }
        shard = self.registry.scorer.shard_info()
        if shard is not None:
            # the front learns shard membership from this key: probed
            # /healthz payloads are how replicas declare which slice of
            # the entity space they own (no static fleet topology file)
            out["shard"] = shard
        store = self.registry.scorer.store_health()
        if store is not None:
            # the tiered store's hit rate is first-class health: a
            # collapsing hot tier shows up here before it shows up as
            # latency
            out["store"] = {"hit_rate": store["hit_rate"],
                            "promotions": store["promotions"],
                            "spills": store["spills"]}
        if self.updater is not None:
            probe = self.updater.probe()
            probe["pending_rows"] = self.updater.buffer.pending_rows
            age = probe["last_cycle_age_s"]
            if age is not None:
                probe["last_cycle_age_s"] = round(age, 3)
            out["updater"] = probe
        if self.health is not None:
            verdict = self.health.verdict()
            out["health"] = verdict
            if verdict["status"] == "degraded":
                out["status"] = "degraded"
        return out

    # -- model lifecycle ---------------------------------------------------

    def swap(self, model_dir: str, version: Optional[str] = None) -> str:
        """Blocking zero-downtime swap; requests keep flowing on the old
        model until the new one is warm."""
        return self.registry.load(model_dir, version)

    def swap_async(self, model_dir: str, version: Optional[str] = None):
        return self.registry.load_async(model_dir, version)

    def rollback(self) -> str:
        return self.registry.rollback()

    @property
    def model_version(self) -> Optional[str]:
        return self.registry.version

    # -- observability / lifecycle ----------------------------------------

    def metrics_snapshot(self) -> Dict:
        snap = self.metrics.snapshot(model_version=self.registry.version)
        snap["version_vector"] = self.registry.version_vector()
        if self.updater is not None:
            snap["online"]["pending_rows"] = self.updater.buffer.pending_rows
            snap["online"]["frozen"] = len(self.updater.frozen_entities())
            snap["online"]["pending_deltas"] = self.registry.pending_deltas()
        return snap

    def prometheus_metrics(self) -> str:
        """Prometheus text exposition (the serving /metrics endpoint)."""
        return self.metrics.prometheus(model_version=self.registry.version)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            telemetry.unregister_collector("serving")
            if self.updater is not None:
                self.updater.close()
            self._batcher.close()
            try:
                # seal the cold tier: after close the store directory
                # alone reproduces every online-updated row
                self.registry.scorer.flush_stores()
            except RuntimeError:
                pass  # no model ever loaded

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
