"""Serving observability on the telemetry metrics registry (a copy of
photon_ml_tpu/serving/metrics.py: the same instruments, JSON paths and
Prometheus series, the SNAPSHOT_PATHS contract included).

Counts requests/rows/batches, shed and deadline failures, entity hit-rate,
bucket compiles, and model swaps; request latencies live in the registry's
BOUNDED histogram reservoir (the unbounded-percentile-list failure mode is
structurally impossible), and batch occupancy (rows actually scored /
padded bucket rows — the padding waste of the power-of-two bucketing rule,
the serving twin of `RandomEffectDataset.padding_stats`) stays a running
ratio of counters.

Two render paths off the same instruments:

  * `snapshot()` — the JSON surface (p50/p90/p95/p99 latency included):
    the serve CLI dumps it on SIGUSR1 / a periodic timer and at
    `GET /metrics.json`, and prints it in its burst line.
  * `prometheus()` — text exposition 0.0.4 for `GET /metrics` (counters
    as `photon_serving_*_total`, the latency histogram as a summary with
    quantile series), scrapeable by a stock Prometheus.

Each ServingMetrics owns a PRIVATE MetricsRegistry, so concurrent services
in one process never cross their numbers; `telemetry.snapshot()` still
sees the live service because ScoringService registers its snapshot as a
telemetry collector.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from photon_ml_tpu_torch.telemetry.export import prometheus_text
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry
from photon_ml_tpu_torch.utils import locktrace


#: instrument name -> key path in the `snapshot()` JSON surface.  This map
#: is the metric-surface parity CONTRACT: every instrument the constructor
#: registers must appear here, and every path must resolve in a rendered
#: snapshot — tests/port/test_torch_serving.py diffs all three sets (and
#: holds them equal to the JAX package's), so a new metric cannot land on
#: the Prometheus surface without its JSON twin (or vice versa).  Several
#: counters render as one derived ratio (occupancy, hit rate): they share
#: a path.
SNAPSHOT_PATHS = {
    "serving.requests": ("requests",),
    "serving.rows": ("rows",),
    "serving.batches": ("batches",),
    "serving.batched_rows": ("batch_occupancy",),
    "serving.bucket_rows": ("batch_occupancy",),
    "serving.shed": ("shed",),
    "serving.deadline_exceeded": ("deadline_exceeded",),
    "serving.errors": ("errors",),
    "serving.entity_lookups": ("entity_hit_rate",),
    "serving.entity_hits": ("entity_hit_rate",),
    "serving.bucket_compiles": ("bucket_compiles",),
    "serving.swaps": ("swaps",),
    "serving.rollbacks": ("rollbacks",),
    "serve.rollback_degraded": ("rollback_degraded",),
    "serving.requests_per_batch_sum": ("requests_per_batch",),
    "serving.queue_wait_s": ("mean_queue_wait_ms",),
    "serving.batch_score_s": ("mean_batch_score_ms",),
    "serving.latency_s": ("latency_ms",),
    "serve.model_age_s": ("model_age_s",),
    "online.feedback_requests": ("online", "feedback_requests"),
    "online.feedback_rows": ("online", "feedback_rows"),
    "online.feedback_lane_rows": ("online", "feedback_lane_rows"),
    "online.feedback_dropped_unseen": ("online", "dropped_unseen"),
    "online.feedback_dropped_frozen": ("online", "dropped_frozen"),
    "online.feedback_deduped": ("online", "deduped"),
    "online.feedback_coalesced": ("online", "coalesced"),
    "online.feedback_shed": ("online", "shed"),
    "online.feedback_rejected": ("online", "feedback_rejected"),
    "online.update_cycles": ("online", "update_cycles"),
    "online.entities_updated": ("online", "entities_updated"),
    "online.rows_trained": ("online", "rows_trained"),
    "online.deltas_published": ("online", "deltas_published"),
    "online.delta_rows": ("online", "delta_rows"),
    "online.stale_deltas": ("online", "stale_deltas"),
    "online.freezes": ("online", "freezes"),
    "online.frozen_entities": ("online", "frozen_entities"),
    "online.last_cycle_age_s": ("online", "last_cycle_age_s"),
    "online.updater_alive": ("online", "updater_alive"),
    "online.solve_retries": ("online", "solve_retries"),
    "online.publish_retries": ("online", "publish_retries"),
    "online.solve_failures": ("online", "solve_failures"),
    "online.publish_s": ("online", "mean_publish_ms"),
    "online.feedback_to_publish_s": ("online", "feedback_to_publish_ms"),
    "health.label_windows": ("health", "label_windows"),
    "health.score_windows": ("health", "score_windows"),
    "health.labels": ("health", "labels"),
    "health.breaches": ("health", "breaches"),
    "health.gate_trips": ("health", "gate_trips"),
    "health.recoveries": ("health", "recoveries"),
    "health.rollbacks": ("health", "rollbacks"),
    "health.evaluate_skipped": ("health", "evaluate_skipped"),
    "health.degraded": ("health", "degraded"),
    "health.baseline_ready": ("health", "baseline_ready"),
    "health.updates_paused": ("health", "updates_paused"),
    "health.hl_chi2": ("health", "hl_chi2"),
    "health.hl_p_value": ("health", "hl_p_value"),
    "health.psi": ("health", "psi"),
    "health.ks": ("health", "ks"),
    "health.window_auc": ("health", "window_auc"),
    "health.window_loss": ("health", "window_loss"),
    "health.delta_l2_mean": ("health", "delta_l2_mean"),
    "health.delta_l2_max": ("health", "delta_l2_max"),
    "health.freezes_window": ("health", "freezes_window"),
    "store.hot_hits": ("store", "hot_hits"),
    "store.warm_hits": ("store", "warm_hits"),
    "store.cold_misses": ("store", "cold_misses"),
    "store.promotions": ("store", "promotions"),
    "store.spills": ("store", "spills"),
    "fleet.applied_seq": ("fleet", "applied_seq"),
    "fleet.lag_seq": ("fleet", "lag_seq"),
    "fleet.lag_seconds": ("fleet", "lag_seconds"),
    "fleet.ready": ("fleet", "ready"),
    "fleet.records_applied": ("fleet", "records_applied"),
    "fleet.apply_retries": ("fleet", "apply_retries"),
    "fleet.catchup_s": ("fleet", "catchup_s"),
    "fleet.apply_latency_s": ("fleet", "apply_latency_ms"),
    "fleet.feedback_visible_s": ("fleet", "feedback_visible_ms"),
    "fleet.log_records": ("fleet", "log_records"),
    "fleet.log_bytes": ("fleet", "log_bytes"),
    "fleet.shard_index": ("fleet", "shard_index"),
    "fleet.shard_count": ("fleet", "shard_count"),
    "fleet.shard_owned_rows": ("fleet", "shard_owned_rows"),
    "fleet.shard_rows_dropped": ("fleet", "shard_rows_dropped"),
    "refit.runs": ("refit", "runs"),
    "refit.swaps": ("refit", "swaps"),
    "refit.failures": ("refit", "failures"),
    "refit.last_success_age_s": ("refit", "last_success_age_s"),
}


class ServingMetrics:
    """All instruments behind one registry; compound updates take the
    local lock so ratios stay coherent."""

    #: the metric-surface parity contract (module constant, re-exported
    #: on the class so embedding callers can introspect it)
    SNAPSHOT_PATHS = SNAPSHOT_PATHS

    def __init__(self, latency_window: int = 8192,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = locktrace.tracked(threading.Lock(),
                                       "ServingMetrics._lock")
        self._t0 = time.monotonic()
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._requests = r.counter("serving.requests")
        self._rows = r.counter("serving.rows")
        self._batches = r.counter("serving.batches")
        self._batched_rows = r.counter("serving.batched_rows")
        self._bucket_rows = r.counter("serving.bucket_rows")
        self._shed = r.counter("serving.shed")
        self._deadline = r.counter("serving.deadline_exceeded")
        self._errors = r.counter("serving.errors")
        self._entity_lookups = r.counter("serving.entity_lookups")
        self._entity_hits = r.counter("serving.entity_hits")
        self._bucket_compiles = r.counter("serving.bucket_compiles")
        self._swaps = r.counter("serving.swaps")
        self._rollbacks = r.counter("serving.rollbacks")
        self._rollback_degraded = r.counter("serve.rollback_degraded")
        self._requests_per_batch_sum = r.counter(
            "serving.requests_per_batch_sum")
        self._queue_wait = r.counter("serving.queue_wait_s")
        self._score_time = r.counter("serving.batch_score_s")
        self._latency = r.histogram("serving.latency_s",
                                    reservoir=latency_window)
        # -- online-update tier (photon_ml_tpu/online/) --------------------
        # staleness: seconds since the live model last changed (full swap
        # OR row-level delta publish); the gauge is refreshed at render
        # time so a scrape always sees the current age
        self._model_age = r.gauge("serve.model_age_s")
        self._last_model_change = time.monotonic()
        self._feedback_requests = r.counter("online.feedback_requests")
        self._feedback_rows = r.counter("online.feedback_rows")
        self._feedback_lanes = r.counter("online.feedback_lane_rows")
        self._feedback_unseen = r.counter("online.feedback_dropped_unseen")
        self._feedback_frozen = r.counter("online.feedback_dropped_frozen")
        self._feedback_deduped = r.counter("online.feedback_deduped")
        self._feedback_coalesced = r.counter("online.feedback_coalesced")
        self._feedback_shed = r.counter("online.feedback_shed")
        self._feedback_rejected = r.counter("online.feedback_rejected")
        self._updates = r.counter("online.update_cycles")
        self._entities_updated = r.counter("online.entities_updated")
        self._rows_trained = r.counter("online.rows_trained")
        self._deltas = r.counter("online.deltas_published")
        self._delta_rows = r.counter("online.delta_rows")
        self._stale_deltas = r.counter("online.stale_deltas")
        self._freezes = r.counter("online.freezes")
        self._solve_retries = r.counter("online.solve_retries")
        self._publish_retries = r.counter("online.publish_retries")
        self._solve_failures = r.counter("online.solve_failures")
        self._publish_time = r.counter("online.publish_s")
        # per-entity feedback-to-publish latency (enqueue of an entity's
        # OLDEST pending observation -> its row live in the scorer tables)
        self._f2p = r.histogram("online.feedback_to_publish_s",
                                reservoir=latency_window)
        # updater vitals that used to stop at OnlineUpdater.stats(): the
        # service installs a probe and BOTH render paths refresh these
        # gauges from it, so a scrape and a JSON snapshot always agree
        # (the same refresh discipline as serve.model_age_s)
        self._online_frozen = r.gauge("online.frozen_entities")
        self._online_cycle_age = r.gauge("online.last_cycle_age_s")
        self._online_alive = r.gauge("online.updater_alive")
        self._online_probe = None
        # -- model-health tier (photon_ml_tpu/health/) ----------------------
        # instruments exist whether or not a HealthMonitor is armed (all
        # zeros disarmed — the same contract as the online.* family)
        self._health_label_windows = r.counter("health.label_windows")
        self._health_score_windows = r.counter("health.score_windows")
        self._health_labels = r.counter("health.labels")
        self._health_breaches = r.counter("health.breaches")
        self._health_trips = r.counter("health.gate_trips")
        self._health_recoveries = r.counter("health.recoveries")
        self._health_rollbacks = r.counter("health.rollbacks")
        self._health_skipped = r.counter("health.evaluate_skipped")
        self._health_degraded = r.gauge("health.degraded")
        self._health_baseline_ready = r.gauge("health.baseline_ready")
        self._health_paused = r.gauge("health.updates_paused")
        self._health_hl_chi2 = r.gauge("health.hl_chi2")
        self._health_hl_p = r.gauge("health.hl_p_value")
        self._health_psi = r.gauge("health.psi")
        self._health_ks = r.gauge("health.ks")
        self._health_auc = r.gauge("health.window_auc")
        self._health_loss = r.gauge("health.window_loss")
        self._health_delta_mean = r.gauge("health.delta_l2_mean")
        self._health_delta_max = r.gauge("health.delta_l2_max")
        self._health_freezes = r.gauge("health.freezes_window")
        # -- tiered entity store (photon_ml_tpu_torch/store/) ----------------
        # scorer miss accounting: a row lookup served device-resident
        # (hot), one promoted out of the host warm tier, one that needed
        # a cold segment read — plus tier movements.  Counters sync to
        # the store's cumulative totals at render time on BOTH surfaces
        # (the set_store_probe discipline); all zeros when the model is
        # fully resident.
        self._store_hot = r.counter("store.hot_hits")
        self._store_warm = r.counter("store.warm_hits")
        self._store_cold = r.counter("store.cold_misses")
        self._store_promotions = r.counter("store.promotions")
        self._store_spills = r.counter("store.spills")
        self._store_probe = None
        # -- replicated-serving tier (photon_ml_tpu/fleet/) ------------------
        # replica-side replication vitals (all zeros outside --replica
        # mode — the same exists-either-way contract as online./health.*);
        # the FRONT's routing counters live on its own registry, not here
        self._fleet_applied_seq = r.gauge("fleet.applied_seq")
        self._fleet_lag_seq = r.gauge("fleet.lag_seq")
        self._fleet_lag_seconds = r.gauge("fleet.lag_seconds")
        self._fleet_ready = r.gauge("fleet.ready")
        self._fleet_records = r.counter("fleet.records_applied")
        self._fleet_apply_retries = r.counter("fleet.apply_retries")
        self._fleet_catchup = r.gauge("fleet.catchup_s")
        # log-append -> replica-apply latency per record, and the
        # end-to-end feedback -> fleet-visible latency (the fleet-wide
        # extension of online.feedback_to_publish_s: intake on the
        # publisher -> the delta live in THIS replica's tables)
        self._fleet_apply_latency = r.histogram("fleet.apply_latency_s",
                                                reservoir=latency_window)
        self._fleet_feedback_visible = r.histogram(
            "fleet.feedback_visible_s", reservoir=latency_window)
        # durable feedback-lane size (FeedbackLog segments on disk): the
        # refit compactor's raw-material backlog, and the retention
        # pressure replog compaction relieves
        self._fleet_log_records = r.gauge("fleet.log_records")
        self._fleet_log_bytes = r.gauge("fleet.log_bytes")
        # entity-sharded serving (fleet/shards.py): which slice of the
        # random-effect entity space this replica owns.  shard_index is
        # -1 / shard_count 0 when unsharded; owned_rows is the summed
        # logical RE rows resident; rows_dropped counts replicated rows
        # the shard filter discarded as unowned (synced from the live
        # scorer's cumulative total at render, set_store_probe-style)
        self._shard_index = r.gauge("fleet.shard_index")
        self._shard_index.set(-1.0)
        self._shard_count = r.gauge("fleet.shard_count")
        self._shard_owned_rows = r.gauge("fleet.shard_owned_rows")
        self._shard_rows_dropped = r.counter("fleet.shard_rows_dropped")
        self._shard_probe = None
        # -- continuous-training tier (photon_ml_tpu/refit/) -----------------
        # all zeros until a refit driver binds; last_success_age_s is -1
        # until the first successful cycle (alert on it growing past the
        # expected cadence — see COMPONENTS.md "Continuous training")
        self._refit_runs = r.counter("refit.runs")
        self._refit_swaps = r.counter("refit.swaps")
        self._refit_failures = r.counter("refit.failures")
        self._refit_age = r.gauge("refit.last_success_age_s")
        self._refit_age.set(-1.0)
        self._refit_last_success: Optional[float] = None  # photonlint: guarded-by=_lock

    # counter-value conveniences (tests and embedding callers read these
    # like the old plain-int attributes)
    @property
    def requests(self) -> int: return self._requests.value

    @property
    def rows(self) -> int: return self._rows.value

    @property
    def batches(self) -> int: return self._batches.value

    @property
    def shed(self) -> int: return self._shed.value

    @property
    def deadline_exceeded(self) -> int: return self._deadline.value

    @property
    def errors(self) -> int: return self._errors.value

    @property
    def swaps(self) -> int: return self._swaps.value

    @property
    def rollbacks(self) -> int: return self._rollbacks.value

    @property
    def bucket_compiles(self) -> int: return self._bucket_compiles.value

    # -- recording ---------------------------------------------------------

    def observe_request(self, latency_s: float, rows: int) -> None:
        self._requests.inc()
        self._rows.inc(rows)
        self._latency.observe(latency_s)

    def observe_batch(self, *, rows: int, bucket_rows: int,
                      num_requests: int, entity_hits: int,
                      entity_lookups: int, new_compiles: int,
                      queue_wait_s: float, score_s: float) -> None:
        with self._lock:
            self._batches.inc()
            self._batched_rows.inc(rows)
            self._bucket_rows.inc(bucket_rows)
            self._requests_per_batch_sum.inc(num_requests)
            self._entity_hits.inc(entity_hits)
            self._entity_lookups.inc(entity_lookups)
            self._bucket_compiles.inc(new_compiles)
            self._queue_wait.inc(queue_wait_s)
            self._score_time.inc(score_s)

    def observe_shed(self) -> None:
        self._shed.inc()

    def observe_deadline(self) -> None:
        self._deadline.inc()

    def observe_error(self) -> None:
        self._errors.inc()

    def observe_swap(self, rollback: bool = False) -> None:
        (self._rollbacks if rollback else self._swaps).inc()
        with self._lock:
            self._last_model_change = time.monotonic()

    def observe_rollback_degraded(self) -> None:
        """A rollback could not restore exact pre-delta rows (undo-log
        overflow) and fell back to a full-model swap."""
        self._rollback_degraded.inc()

    # -- online-update tier -------------------------------------------------

    def observe_feedback(self, *, requests: int = 1, rows: int = 0,
                         lane_rows: int = 0, unseen: int = 0,
                         frozen: int = 0, deduped: int = 0,
                         coalesced: int = 0) -> None:
        with self._lock:
            self._feedback_requests.inc(requests)
            self._feedback_rows.inc(rows)
            self._feedback_lanes.inc(lane_rows)
            self._feedback_unseen.inc(unseen)
            self._feedback_frozen.inc(frozen)
            self._feedback_deduped.inc(deduped)
            self._feedback_coalesced.inc(coalesced)

    def observe_feedback_shed(self) -> None:
        self._feedback_shed.inc()

    def observe_feedback_rejected(self) -> None:
        """A whole feedback batch was rejected with backpressure (the
        HTTP 429 + Retry-After path, counted at the service surface)."""
        self._feedback_rejected.inc()

    # -- replicated-serving tier ---------------------------------------------

    def observe_replica_applied(self, *, applied_seq: int, lag_seq: int,
                                records: int = 0) -> None:
        """A replica apply cycle finished: refresh the replication
        gauges and count the records that landed."""
        self._fleet_applied_seq.set(int(applied_seq))
        self._fleet_lag_seq.set(max(int(lag_seq), 0))
        if records:
            self._fleet_records.inc(records)
        elif lag_seq <= 0:
            # an empty poll at the log head: the replica is caught up
            self._fleet_lag_seconds.set(0.0)

    def observe_replica_record(self, *, apply_latency_s: float,
                               feedback_visible_s=None) -> None:
        """One replicated record landed: append->apply latency (and, for
        delta records carrying intake trace metadata, the end-to-end
        feedback->fleet-visible latency)."""
        self._fleet_apply_latency.observe(apply_latency_s)
        self._fleet_lag_seconds.set(round(float(apply_latency_s), 6))
        if feedback_visible_s is not None:
            self._fleet_feedback_visible.observe(feedback_visible_s)

    def observe_replica_ready(self, ready: bool,
                              catchup_s: float = None) -> None:
        self._fleet_ready.set(int(bool(ready)))
        if catchup_s is not None:
            self._fleet_catchup.set(round(float(catchup_s), 3))

    def observe_replica_apply_retry(self) -> None:
        self._fleet_apply_retries.inc()

    def observe_feedback_log(self, *, records: int, bytes: int) -> None:
        """Durable feedback-lane size after an append or a compaction
        (records/bytes live in `feedback-*.seg` segments)."""
        self._fleet_log_records.set(int(records))
        self._fleet_log_bytes.set(int(bytes))

    def observe_refit_run(self, *, swapped: bool, failed: bool = False
                          ) -> None:
        """One completed refit cycle: every cycle counts a run, a winning
        candidate counts a swap (and stamps last-success), a cycle that
        died counts a failure."""
        self._refit_runs.inc()
        if failed:
            self._refit_failures.inc()
            return
        if swapped:
            self._refit_swaps.inc()
        with self._lock:
            self._refit_last_success = time.monotonic()
        self._refresh_refit_age()

    def observe_update_cycle(self, *, entities: int, rows: int) -> None:
        with self._lock:
            self._updates.inc()
            self._entities_updated.inc(entities)
            self._rows_trained.inc(rows)

    def observe_delta(self, *, rows: int, publish_s: float = 0.0) -> None:
        """A delta landed in the live tables: the model just changed."""
        with self._lock:
            self._deltas.inc()
            self._delta_rows.inc(rows)
            self._publish_time.inc(publish_s)
            self._last_model_change = time.monotonic()

    def observe_feedback_to_publish(self, latency_s: float) -> None:
        self._f2p.observe(latency_s)

    def observe_stale_delta(self) -> None:
        self._stale_deltas.inc()

    def observe_frozen_entity(self, n: int = 1) -> None:
        self._freezes.inc(n)

    def observe_solve_retry(self) -> None:
        self._solve_retries.inc()

    def observe_publish_retry(self) -> None:
        self._publish_retries.inc()

    def observe_solve_failure(self) -> None:
        self._solve_failures.inc()

    def set_online_probe(self, fn) -> None:
        """`fn() -> {"frozen": int, "alive": bool, "paused": bool,
        "last_cycle_age_s": float|None}` — the OnlineUpdater's live
        vitals, refreshed on BOTH render paths (snapshot + prometheus)."""
        with self._lock:
            self._online_probe = fn

    # -- tiered entity store -------------------------------------------------

    def set_store_probe(self, fn) -> None:
        """`fn() -> {"hot_hits": int, "warm_hits": int, ...}` — the live
        scorer's cumulative tier totals (CompiledScorer.store_totals),
        synced into the counters on BOTH render paths."""
        with self._lock:
            self._store_probe = fn

    def set_shard_probe(self, fn) -> None:
        """`fn() -> CompiledScorer.shard_info()` (None when unsharded) —
        the live scorer's shard identity + filter totals, refreshed on
        BOTH render paths."""
        with self._lock:
            self._shard_probe = fn

    def _refresh_shard_gauges(self) -> None:
        with self._lock:
            probe = self._shard_probe
        if probe is None:
            return
        try:
            info = probe()
        except Exception:
            return  # a swapping scorer must not take the scrape down
        if info is None:
            return
        self._shard_index.set(int(info.get("index", -1)))
        self._shard_count.set(int(info.get("num_shards", 0)))
        self._shard_owned_rows.set(
            int(sum(info.get("owned_rows", {}).values())))
        gap = int(info.get("rows_dropped", 0)) - self._shard_rows_dropped.value
        if gap > 0:  # monotonic: a swap resets the scorer's total
            self._shard_rows_dropped.inc(gap)

    def _refresh_store_counters(self) -> None:
        """Sync the store.* counters to the probe's cumulative totals
        (monotonic: a model swap resets the scorer's totals, never the
        counters)."""
        with self._lock:
            probe = self._store_probe
        if probe is None:
            return
        try:
            totals = probe()
        except Exception:
            return  # a swapping scorer must not take the scrape down
        for counter, key in ((self._store_hot, "hot_hits"),
                             (self._store_warm, "warm_hits"),
                             (self._store_cold, "cold_misses"),
                             (self._store_promotions, "promotions"),
                             (self._store_spills, "spills")):
            gap = int(totals.get(key, 0)) - counter.value
            if gap > 0:
                counter.inc(gap)

    # -- model-health tier ---------------------------------------------------

    @staticmethod
    def _set_if(gauge, value) -> None:
        """Gauges keep their last value across windows that could not
        produce one (single-class AUC, no deltas published)."""
        if value is not None:
            gauge.set(round(float(value), 6))

    def observe_health_label_window(self, *, rows: int, hl_chi2, hl_p,
                                    auc, loss, delta_l2_mean, delta_l2_max,
                                    freezes: int, breaches: int) -> None:
        with self._lock:
            self._health_label_windows.inc()
            self._health_labels.inc(rows)
            self._health_breaches.inc(breaches)
        self._set_if(self._health_hl_chi2, hl_chi2)
        self._set_if(self._health_hl_p, hl_p)
        self._set_if(self._health_auc, auc)
        self._set_if(self._health_loss, loss)
        self._set_if(self._health_delta_mean, delta_l2_mean)
        self._set_if(self._health_delta_max, delta_l2_max)
        self._health_freezes.set(int(freezes))

    def observe_health_score_window(self, *, rows: int, psi, ks,
                                    breaches: int) -> None:
        with self._lock:
            self._health_score_windows.inc()
            self._health_breaches.inc(breaches)
        self._set_if(self._health_psi, psi)
        self._set_if(self._health_ks, ks)

    def observe_health_status(self, *, degraded: bool, paused: bool,
                              baseline_ready: bool) -> None:
        self._health_degraded.set(int(degraded))
        self._health_paused.set(int(paused))
        self._health_baseline_ready.set(int(baseline_ready))

    def observe_health_trip(self) -> None:
        self._health_trips.inc()

    def observe_health_recovery(self) -> None:
        self._health_recoveries.inc()

    def observe_health_rollback(self) -> None:
        self._health_rollbacks.inc()

    def observe_health_skipped(self) -> None:
        self._health_skipped.inc()

    def _refresh_model_age(self) -> float:
        with self._lock:
            age = time.monotonic() - self._last_model_change
        self._model_age.set(round(age, 3))
        return age

    def _refresh_refit_age(self) -> float:
        """-1 until the first successful refit cycle, then the age of the
        newest success — the staleness signal refit alerting scrapes."""
        with self._lock:
            last = self._refit_last_success
        age = -1.0 if last is None else round(time.monotonic() - last, 3)
        self._refit_age.set(age)
        return age

    def _refresh_online_gauges(self) -> None:
        """Pull the updater's live vitals into the gauges (both render
        paths call this, so neither surface can go stale alone).
        `last_cycle_age_s` is -1 until the first completed cycle."""
        with self._lock:
            probe = self._online_probe
        if probe is None:
            return
        try:
            st = probe()
        except Exception:
            return  # a dying updater must not take the scrape down
        self._online_frozen.set(int(st.get("frozen", 0)))
        self._online_alive.set(int(bool(st.get("alive", False))))
        age = st.get("last_cycle_age_s")
        self._online_cycle_age.set(-1.0 if age is None else round(age, 3))

    # -- reporting ---------------------------------------------------------

    def snapshot(self, model_version: Optional[str] = None) -> Dict:
        self._refresh_online_gauges()
        self._refresh_store_counters()
        self._refresh_shard_gauges()
        with self._lock:
            batches = self._batches.value
            bucket_rows = self._bucket_rows.value
            lookups = self._entity_lookups.value
            out = {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "requests": self._requests.value,
                "rows": self._rows.value,
                "batches": batches,
                "requests_per_batch": round(
                    self._requests_per_batch_sum.value / batches, 3)
                if batches else None,
                "batch_occupancy": round(
                    self._batched_rows.value / bucket_rows, 4)
                if bucket_rows else None,
                "entity_hit_rate": round(
                    self._entity_hits.value / lookups, 4)
                if lookups else None,
                "bucket_compiles": self._bucket_compiles.value,
                "shed": self._shed.value,
                "deadline_exceeded": self._deadline.value,
                "errors": self._errors.value,
                "swaps": self._swaps.value,
                "rollbacks": self._rollbacks.value,
                "rollback_degraded": self._rollback_degraded.value,
                "mean_queue_wait_ms": round(
                    1e3 * self._queue_wait.value / batches, 3)
                if batches else None,
                "mean_batch_score_ms": round(
                    1e3 * self._score_time.value / batches, 3)
                if batches else None,
            }
        h = self._latency.snapshot()
        if h["count"]:
            out["latency_ms"] = {
                key: round(1e3 * h[src], 3)
                for key, src in (("p50", "p50"), ("p90", "p90"),
                                 ("p95", "p95"), ("p99", "p99"),
                                 ("max", "max"))
            }
            out["latency_ms"]["window"] = h["window"]
        else:
            out["latency_ms"] = None
        out["model_age_s"] = round(self._refresh_model_age(), 3)
        out["online"] = self._online_snapshot()
        out["health"] = self._health_snapshot()
        out["store"] = self._store_snapshot()
        out["fleet"] = self._fleet_snapshot()
        out["refit"] = self._refit_snapshot()
        if model_version is not None:
            out["model_version"] = model_version
        return out

    def _online_snapshot(self) -> Dict:
        """The online-update tier's state (all zeros when updates are
        disabled — the instruments exist either way)."""
        f2p = self._f2p.snapshot()
        deltas = self._deltas.value
        out = {
            "feedback_requests": self._feedback_requests.value,
            "feedback_rows": self._feedback_rows.value,
            "feedback_lane_rows": self._feedback_lanes.value,
            "dropped_unseen": self._feedback_unseen.value,
            "dropped_frozen": self._feedback_frozen.value,
            "deduped": self._feedback_deduped.value,
            "coalesced": self._feedback_coalesced.value,
            "shed": self._feedback_shed.value,
            "feedback_rejected": self._feedback_rejected.value,
            "update_cycles": self._updates.value,
            "entities_updated": self._entities_updated.value,
            "rows_trained": self._rows_trained.value,
            "deltas_published": deltas,
            "delta_rows": self._delta_rows.value,
            "stale_deltas": self._stale_deltas.value,
            "freezes": self._freezes.value,
            "frozen_entities": self._online_frozen.value,
            "last_cycle_age_s": self._online_cycle_age.value,
            "updater_alive": self._online_alive.value,
            "solve_retries": self._solve_retries.value,
            "publish_retries": self._publish_retries.value,
            "solve_failures": self._solve_failures.value,
            "mean_publish_ms": round(
                1e3 * self._publish_time.value / deltas, 3)
            if deltas else None,
        }
        if f2p["count"]:
            out["feedback_to_publish_ms"] = {
                key: round(1e3 * f2p[src], 3)
                for key, src in (("p50", "p50"), ("p99", "p99"),
                                 ("max", "max"))
            }
            out["feedback_to_publish_ms"]["window"] = f2p["window"]
        else:
            out["feedback_to_publish_ms"] = None
        return out

    def _health_snapshot(self) -> Dict:
        """The model-health tier's state (all zeros when no HealthMonitor
        is armed — the instruments exist either way)."""
        return {
            "label_windows": self._health_label_windows.value,
            "score_windows": self._health_score_windows.value,
            "labels": self._health_labels.value,
            "breaches": self._health_breaches.value,
            "gate_trips": self._health_trips.value,
            "recoveries": self._health_recoveries.value,
            "rollbacks": self._health_rollbacks.value,
            "evaluate_skipped": self._health_skipped.value,
            "degraded": self._health_degraded.value,
            "baseline_ready": self._health_baseline_ready.value,
            "updates_paused": self._health_paused.value,
            "hl_chi2": self._health_hl_chi2.value,
            "hl_p_value": self._health_hl_p.value,
            "psi": self._health_psi.value,
            "ks": self._health_ks.value,
            "window_auc": self._health_auc.value,
            "window_loss": self._health_loss.value,
            "delta_l2_mean": self._health_delta_mean.value,
            "delta_l2_max": self._health_delta_max.value,
            "freezes_window": self._health_freezes.value,
        }

    def _store_snapshot(self) -> Dict:
        """The tiered entity store's state (all zeros when the model is
        fully resident — the instruments exist either way).  `hit_rate`
        is the derived hot fraction of all row lookups."""
        hot = self._store_hot.value
        warm = self._store_warm.value
        cold = self._store_cold.value
        lookups = hot + warm + cold
        return {
            "hot_hits": hot,
            "warm_hits": warm,
            "cold_misses": cold,
            "promotions": self._store_promotions.value,
            "spills": self._store_spills.value,
            "hit_rate": round(hot / lookups, 4) if lookups else None,
        }

    @staticmethod
    def _latency_ms(h: Dict) -> Optional[Dict]:
        if not h["count"]:
            return None
        out = {key: round(1e3 * h[src], 3)
               for key, src in (("p50", "p50"), ("p99", "p99"),
                                ("max", "max"))}
        out["window"] = h["window"]
        return out

    def _fleet_snapshot(self) -> Dict:
        """The replicated-serving tier's replica-side state (all zeros
        outside --replica mode — the instruments exist either way)."""
        return {
            "applied_seq": self._fleet_applied_seq.value,
            "lag_seq": self._fleet_lag_seq.value,
            "lag_seconds": self._fleet_lag_seconds.value,
            "ready": self._fleet_ready.value,
            "records_applied": self._fleet_records.value,
            "apply_retries": self._fleet_apply_retries.value,
            "catchup_s": self._fleet_catchup.value,
            "apply_latency_ms": self._latency_ms(
                self._fleet_apply_latency.snapshot()),
            "feedback_visible_ms": self._latency_ms(
                self._fleet_feedback_visible.snapshot()),
            "log_records": self._fleet_log_records.value,
            "log_bytes": self._fleet_log_bytes.value,
            "shard_index": self._shard_index.value,
            "shard_count": self._shard_count.value,
            "shard_owned_rows": self._shard_owned_rows.value,
            "shard_rows_dropped": self._shard_rows_dropped.value,
        }

    def _refit_snapshot(self) -> Dict:
        """The continuous-training tier's state (all zeros / -1 when no
        refit driver is bound — the instruments exist either way)."""
        return {
            "runs": self._refit_runs.value,
            "swaps": self._refit_swaps.value,
            "failures": self._refit_failures.value,
            "last_success_age_s": self._refresh_refit_age(),
        }

    def prometheus(self, model_version: Optional[str] = None) -> str:
        """Prometheus text exposition of every serving instrument
        (including the online tier's staleness + updater-vitals gauges and
        the health.* family) — refreshed-at-render gauges get the SAME
        refresh here as on the JSON surface."""
        self._refresh_model_age()
        self._refresh_online_gauges()
        self._refresh_store_counters()
        self._refresh_shard_gauges()
        self._refresh_refit_age()
        info = {"model_version": model_version} if model_version else None
        return prometheus_text(self.registry, extra_info=info)
