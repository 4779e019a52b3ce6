"""HealthMonitor: continuous model-quality gates on the serving path
(port of photon_ml_tpu/health/monitor.py).

The live counterpart of the offline diagnostics tier (`diagnostics/`):
where `cli.diagnose` judges a model once against a held-out set, this
monitor judges the SERVING model continuously against its own traffic —
and acts on the verdict.  Four signal families, two window clocks:

  * score-distribution drift (every scored row, `window_scores` per
    window): PSI + binned KS against a baseline histogram snapshotted at
    each `ModelRegistry.install()` — reset on full-model swap, carried
    across row-level delta publishes (drift.py).
  * streaming calibration (every feedback-joined label, `window_labels`
    per window): Hosmer–Lemeshow chi^2 over probability deciles, the
    same per-bin algebra as `diagnostics/hl.py` (calibration.py).
  * sliding-window loss + AUC on the same labeled rows (host numpy f64,
    `evaluation.area_under_roc_curve` as the AUC).
  * online-update vitals from the OnlineUpdater: per-coordinate delta
    magnitudes (L2 of published row - prior) and the freeze rate.

Each closed window updates its gates (`HealthConfig.thresholds()`); a
gate that breaches `sustain_windows` consecutive windows TRIPS: /healthz
flips to degraded, the OnlineUpdater pauses (`pause_updates`), and gates
named in `rollback_on` trigger the registry's delta-aware rollback.
`recovery_windows` consecutive clean windows recover: updates resume,
status returns to ok.

Hot-path discipline: the scoring thread pays one lock + a `searchsorted`
/ `bincount` pair per BATCH (never per row, never a device op: the
scorer already returns its scores as host numpy); with no monitor constructed the service's hook is a
plain None check — the same disarm shape as `faults.fire()`.  Window
EVALUATION (chi^2 CDF, PSI, AUC) runs on whichever thread closed the
window, OUTSIDE the monitor lock, on an O(bins)/O(window) snapshot; the
`health.evaluate` fault site makes the evaluation path chaos-testable.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.telemetry import flight
from photon_ml_tpu_torch.evaluation.evaluators import area_under_roc_curve
from photon_ml_tpu_torch.health.calibration import StreamingCalibration
from photon_ml_tpu_torch.health.config import GATE_NAMES, HealthConfig
from photon_ml_tpu_torch.health.drift import DriftDetector
from photon_ml_tpu_torch.utils import faults, locktrace

logger = logging.getLogger("photon_ml_tpu")


def _np_sigmoid(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.tanh(0.5 * z))


#: task -> host-numpy inverse link producing a PROBABILITY (calibration
#: is only defined where the mean is one); margins stay the drift signal
#: for every task.
INVERSE_LINKS = {"logistic_regression": _np_sigmoid}

#: task -> host-numpy per-row loss on (margin+offset, label).  Host numpy
#: keeps window evaluation off the device entirely: no launches and no
#: read-backs with health armed.
NP_LOSSES = {
    "logistic_regression": lambda z, y: np.logaddexp(0.0, z) - y * z,
    "linear_regression": lambda z, y: 0.5 * (z - y) ** 2,
    "poisson_regression": lambda z, y: np.exp(z) - y * z,
}


class GateState:
    """One gate's consecutive-window bookkeeping."""

    __slots__ = ("threshold", "value", "breaches", "clean", "tripped",
                 "windows", "trips")

    def __init__(self, threshold: Optional[float]):
        self.threshold = threshold
        self.value: Optional[float] = None
        self.breaches = 0        # consecutive breached windows
        self.clean = 0           # consecutive clean windows
        self.tripped = False
        self.windows = 0         # windows this gate evaluated
        self.trips = 0           # lifetime trip count

    def to_dict(self) -> dict:
        return {"threshold": self.threshold, "value": self.value,
                "breaches": self.breaches, "tripped": self.tripped,
                "windows": self.windows, "trips": self.trips}


class HealthMonitor:
    """Streaming calibration + drift + online-update vitals -> gates.

    Constructed by `ScoringService(health=HealthConfig())`; standalone
    construction (tests, replay tooling) needs only a config — `metrics`,
    `bind()` and the swap hook are optional wiring.
    """

    def __init__(self, config: HealthConfig, metrics=None,
                 task_type: Optional[str] = None):
        self.config = config
        self.metrics = metrics            # ServingMetrics (or None)
        self._lock = locktrace.tracked(threading.Lock(),
                                       "HealthMonitor._lock")
        # action targets, wired by bind(); read under the lock
        self._registry = None  # photonlint: guarded-by=_lock
        self._updater = None  # photonlint: guarded-by=_lock
        self._task = task_type  # photonlint: guarded-by=_lock
        # -- drift state (scoring path) --------------------------------
        self._drift = DriftDetector(config.drift_bins,
                                    config.baseline_scores)  # photonlint: guarded-by=_lock
        # -- label-window state (feedback path) ------------------------
        self._cal = StreamingCalibration(config.calibration_bins)  # photonlint: guarded-by=_lock
        w = config.window_labels
        self._margins = np.empty(w)  # photonlint: guarded-by=_lock
        self._labels = np.empty(w)  # photonlint: guarded-by=_lock
        self._weights = np.empty(w)  # photonlint: guarded-by=_lock
        self._label_n = 0  # photonlint: guarded-by=_lock
        self._loss_sum = 0.0  # photonlint: guarded-by=_lock
        self._loss_wsum = 0.0  # photonlint: guarded-by=_lock
        # -- online-update vitals (updater thread) ---------------------
        self._delta_sum = 0.0  # photonlint: guarded-by=_lock
        self._delta_max = 0.0  # photonlint: guarded-by=_lock
        self._delta_n = 0  # photonlint: guarded-by=_lock
        self._delta_by_coord: Dict[str, float] = {}  # photonlint: guarded-by=_lock
        self._freezes = 0  # photonlint: guarded-by=_lock
        # -- gates -----------------------------------------------------
        self._gates = {name: GateState(t)
                       for name, t in config.thresholds().items()}  # photonlint: guarded-by=_lock
        self._degraded = False  # photonlint: guarded-by=_lock
        self._we_paused = False  # photonlint: guarded-by=_lock
        self._windows = 0  # photonlint: guarded-by=_lock
        self._skipped = 0  # photonlint: guarded-by=_lock
        self._rollbacks = 0  # photonlint: guarded-by=_lock
        self.version: Optional[str] = None  # photonlint: guarded-by=_lock

    # -- wiring -------------------------------------------------------------

    def bind(self, registry=None, updater=None,
             task_type: Optional[str] = None) -> None:
        """Attach the action targets (pause/resume on the updater, the
        delta-aware rollback on the registry)."""
        with self._lock:
            if registry is not None:
                self._registry = registry
            if updater is not None:
                self._updater = updater
            if task_type is not None:
                self._task = task_type

    def on_model_event(self, version: str, action: str) -> None:
        """ModelRegistry swap hook: a new full model is live.  The drift
        baseline, open windows, and every gate's breach history belong to
        the OUTGOING model — reset everything and (if the PAUSE was ours)
        let the updater run against the fresh version."""
        with self._lock:
            self.version = version
            self._drift.reset_baseline()
            self._cal.reset()
            self._label_n = 0
            self._loss_sum = self._loss_wsum = 0.0
            self._delta_sum = self._delta_max = 0.0
            self._delta_n = 0
            self._delta_by_coord = {}
            self._freezes = 0
            for g in self._gates.values():
                g.value = None
                g.breaches = g.clean = 0
                g.tripped = False
            was_degraded, self._degraded = self._degraded, False
            resume, self._we_paused = self._we_paused, False
            updater = self._updater
        if was_degraded:
            telemetry.event("health_reset", version=str(version),
                            action=action)
        if resume and updater is not None:
            updater.resume()
        self._publish_status()

    # -- observation: the scoring path --------------------------------------

    def observe_scores(self, scores: np.ndarray) -> None:
        """Every served batch's margins (called by the service's batch
        worker — one lock + histogram add per batch)."""
        s = np.asarray(scores, np.float64)
        closed: List[dict] = []
        with self._lock:
            lo = 0
            while lo < len(s):
                room = self.config.window_scores - self._drift.window_count
                hi = min(len(s), lo + max(room, 1))
                self._drift.observe(s[lo:hi])
                lo = hi
                if self._drift.window_count >= self.config.window_scores:
                    win = self._drift.take()
                    if win is not None:
                        closed.append({"kind": "drift", "window": win})
        for snap in closed:
            self._evaluate(snap)

    # -- observation: the feedback path --------------------------------------

    def observe_feedback(self, scorer, features, ids, labels,
                         weights=None, offsets=None) -> None:
        """A feedback batch joined back to the live model: score it once
        through the live scorer (its margins come back once, as host
        numpy), fold offsets, and accumulate
        calibration/loss/AUC windows.  Called on the feedback request
        thread (off the scoring hot path)."""
        labels = np.asarray(labels, np.float64)
        n = len(labels)
        w = (np.ones(n) if weights is None
             else np.asarray(weights, np.float64))
        off = (np.zeros(n) if offsets is None
               else np.asarray(offsets, np.float64))
        margins = scorer.score(features, ids).scores + off
        with self._lock:
            task = self._task
        task = task or scorer.model.task_type
        inv = INVERSE_LINKS.get(task)
        loss_fn = NP_LOSSES.get(task)
        probs = inv(margins) if inv is not None else None
        losses = loss_fn(margins, labels) if loss_fn is not None else None
        closed: List[dict] = []
        with self._lock:
            lo = 0
            while lo < n:
                room = self.config.window_labels - self._label_n
                hi = min(n, lo + room)
                k = hi - lo
                self._margins[self._label_n:self._label_n + k] = margins[lo:hi]
                self._labels[self._label_n:self._label_n + k] = labels[lo:hi]
                self._weights[self._label_n:self._label_n + k] = w[lo:hi]
                self._label_n += k
                if probs is not None:
                    self._cal.update(probs[lo:hi], labels[lo:hi])
                if losses is not None:
                    self._loss_sum += float(np.sum(w[lo:hi] * losses[lo:hi]))
                    self._loss_wsum += float(np.sum(w[lo:hi]))
                lo = hi
                if self._label_n >= self.config.window_labels:
                    closed.append(self._take_label_window_locked())
        for snap in closed:
            self._evaluate(snap)

    def _take_label_window_locked(self) -> dict:
        """Snapshot + reset the label-window accumulators (lock held)."""
        k = self._label_n
        snap = {
            "kind": "labels",
            "rows": k,
            "calibration": self._cal.take(),
            "margins": self._margins[:k].copy(),
            "labels": self._labels[:k].copy(),
            "weights": self._weights[:k].copy(),
            "loss": (self._loss_sum / self._loss_wsum
                     if self._loss_wsum > 0 else None),
            "delta_l2_mean": (self._delta_sum / self._delta_n
                              if self._delta_n else None),
            "delta_l2_max": self._delta_max if self._delta_n else None,
            "delta_by_coordinate": dict(self._delta_by_coord),
            "freezes": self._freezes,
        }
        self._label_n = 0
        self._loss_sum = self._loss_wsum = 0.0
        self._delta_sum = self._delta_max = 0.0
        self._delta_n = 0
        self._delta_by_coord = {}
        self._freezes = 0
        return snap

    # -- observation: the online updater -------------------------------------

    def observe_published(self, coordinate: str,
                          magnitudes: np.ndarray) -> None:
        """Per-row L2 of (published value - prior) for one delta."""
        m = np.asarray(magnitudes, np.float64)
        if not len(m):
            return
        mx = float(np.max(m))
        with self._lock:
            self._delta_sum += float(np.sum(m))
            self._delta_n += len(m)
            self._delta_max = max(self._delta_max, mx)
            prev = self._delta_by_coord.get(coordinate, 0.0)
            self._delta_by_coord[coordinate] = max(prev, mx)

    def observe_freeze(self, coordinate: str) -> None:
        with self._lock:
            self._freezes += 1

    # -- evaluation -----------------------------------------------------------

    def _evaluate(self, snap: dict) -> None:
        """One closed window -> gate values -> transitions -> actions.
        Runs OUTSIDE the monitor lock on a private snapshot."""
        kind = snap["kind"]
        try:
            faults.fire("health.evaluate", kind=kind)
        except BaseException as e:
            if faults.is_transient(e):
                with self._lock:
                    self._skipped += 1
                if self.metrics is not None:
                    self.metrics.observe_health_skipped()
                telemetry.event("health_evaluate_skipped", kind=kind,
                                error=f"{type(e).__name__}: {e}")
                return
            raise
        with telemetry.span("health_evaluate", kind=kind):
            if kind == "drift":
                results = self._drift_results(snap)
            else:
                results = self._label_results(snap)
            outcome = self._apply_window(kind, results)
        self._publish_window(kind, snap, results, outcome)
        self._act(outcome)

    def _drift_results(self, snap) -> Dict[str, tuple]:
        win = snap["window"]
        c = self.config
        return {
            "drift_psi": (win.psi, c.psi_max is not None
                          and win.psi > c.psi_max),
            "drift_ks": (win.ks, c.ks_max is not None and win.ks > c.ks_max),
        }

    def _label_results(self, snap) -> Dict[str, tuple]:
        c = self.config
        results: Dict[str, tuple] = {}
        cal = snap["calibration"]
        if cal is not None:
            results["calibration"] = (
                cal.p_value, c.calibration_p_min is not None
                and cal.p_value < c.calibration_p_min)
            snap["hl_chi2"] = cal.chi_squared
        auc = area_under_roc_curve(snap["margins"], snap["labels"],
                                   snap["weights"])
        if np.isfinite(auc):
            results["auc"] = (float(auc),
                              c.auc_min is not None and auc < c.auc_min)
            snap["auc"] = float(auc)
        if snap["loss"] is not None:
            results["loss"] = (snap["loss"], c.loss_max is not None
                               and snap["loss"] > c.loss_max)
        if snap["delta_l2_max"] is not None:
            results["delta_l2"] = (
                snap["delta_l2_max"], c.delta_l2_max is not None
                and snap["delta_l2_max"] > c.delta_l2_max)
        results["freeze_rate"] = (
            float(snap["freezes"]), c.freeze_max is not None
            and snap["freezes"] > c.freeze_max)
        return results

    def _apply_window(self, kind: str,
                      results: Dict[str, tuple]) -> dict:
        """Fold one window's gate values into the consecutive-breach
        state machine (brief lock) and return the transition outcome."""
        c = self.config
        tripped: List[str] = []
        recovered: List[str] = []
        breaches = 0
        with self._lock:
            for name, (value, breach) in results.items():
                g = self._gates[name]
                g.value = value
                g.windows += 1
                if breach:
                    breaches += 1
                    g.breaches += 1
                    g.clean = 0
                    if not g.tripped and g.breaches >= c.sustain_windows:
                        g.tripped = True
                        g.trips += 1
                        tripped.append((name, value, g.threshold))
                else:
                    g.clean += 1
                    g.breaches = 0
                    if g.tripped and g.clean >= c.recovery_windows:
                        g.tripped = False
                        recovered.append(name)
            was_degraded = self._degraded
            self._degraded = any(g.tripped for g in self._gates.values())
            now_degraded = self._degraded
            self._windows += 1
            pause = (tripped and c.pause_updates and not self._we_paused
                     and self._updater is not None)
            if pause:
                self._we_paused = True
            resume = (was_degraded and not now_degraded and self._we_paused)
            if resume:
                self._we_paused = False
            rollback = [n for n, _v, _t in tripped if n in c.rollback_on]
            updater = self._updater
            registry = self._registry
        return {"tripped": tripped, "recovered": recovered,
                "breaches": breaches, "degraded": now_degraded,
                "was_degraded": was_degraded, "pause": bool(pause),
                "resume": bool(resume), "rollback": rollback,
                "updater": updater, "registry": registry}

    def _act(self, outcome: dict) -> None:
        """Execute the transitions decided by `_apply_window` — pause /
        resume / delta-aware rollback — outside every monitor lock."""
        updater, registry = outcome["updater"], outcome["registry"]
        for name, value, threshold in outcome["tripped"]:
            telemetry.event("health_gate_tripped", gate=name, value=value)
            logger.warning("health gate %r TRIPPED (value=%s threshold=%s)",
                           name, value, threshold)
            if self.metrics is not None:
                self.metrics.observe_health_trip()
        if outcome["tripped"]:
            # the flight ring holds the windows that led to the trip —
            # dump BEFORE acting (pause/rollback mutate the state the
            # postmortem needs to see)
            flight.trigger("health.gate_trip",
                           gates=",".join(n for n, _v, _t
                                          in outcome["tripped"]))
        for name in outcome["recovered"]:
            telemetry.event("health_gate_recovered", gate=name)
            logger.info("health gate %r recovered", name)
            if self.metrics is not None:
                self.metrics.observe_health_recovery()
        if outcome["pause"] and updater is not None:
            gates = ",".join(n for n, _v, _t in outcome["tripped"])
            updater.pause(reason=f"health: {gates}")
            telemetry.event("health_updates_paused", gates=gates)
        if outcome["rollback"] and registry is not None:
            if registry.pending_deltas() > 0:
                registry.rollback()
                with self._lock:
                    self._rollbacks += 1
                if self.metrics is not None:
                    self.metrics.observe_health_rollback()
                telemetry.event("health_rollback",
                                gates=",".join(outcome["rollback"]))
                logger.warning("health gates %s triggered delta-aware "
                               "rollback", outcome["rollback"])
            else:
                telemetry.event("health_rollback_skipped",
                                reason="no pending deltas")
        if outcome["resume"] and updater is not None:
            updater.resume()
            telemetry.event("health_updates_resumed")
        self._publish_status()

    def _publish_window(self, kind, snap, results, outcome) -> None:
        if self.metrics is None:
            return
        values = {name: v for name, (v, _b) in results.items()}
        if kind == "drift":
            self.metrics.observe_health_score_window(
                rows=snap["window"].count, psi=values.get("drift_psi"),
                ks=values.get("drift_ks"), breaches=outcome["breaches"])
        else:
            self.metrics.observe_health_label_window(
                rows=snap["rows"], hl_chi2=snap.get("hl_chi2"),
                hl_p=values.get("calibration"), auc=values.get("auc"),
                loss=values.get("loss"),
                delta_l2_mean=snap["delta_l2_mean"],
                delta_l2_max=snap["delta_l2_max"],
                freezes=snap["freezes"], breaches=outcome["breaches"])

    def _publish_status(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            degraded = self._degraded
            paused = self._we_paused
            ready = self._drift.baseline_ready
        self.metrics.observe_health_status(
            degraded=degraded, paused=paused, baseline_ready=ready)

    # -- introspection --------------------------------------------------------

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def verdict(self) -> dict:
        """The health verdict the /healthz endpoint embeds: overall status
        plus per-gate detail."""
        with self._lock:
            gates = {name: self._gates[name].to_dict()
                     for name in GATE_NAMES}
            return {
                "status": "degraded" if self._degraded else "ok",
                "model_version": self.version,
                "baseline_ready": self._drift.baseline_ready,
                "windows_evaluated": self._windows,
                "windows_skipped": self._skipped,
                "rollbacks": self._rollbacks,
                "updates_paused_by_health": self._we_paused,
                "delta_l2_by_coordinate": dict(self._delta_by_coord),
                "gates": gates,
            }
