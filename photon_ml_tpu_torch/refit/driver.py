"""Warm refit driver: compacted feedback -> anchored GAME fit -> validated
fleet swap (port of photon_ml_tpu/refit/driver.py).

The driver closes the continuous-training loop's middle leg.  One
`run_once()` cycle:

  1. COMPACT — `LogCompactor.compact()` seals the feedback lane's
     unconsumed suffix into durable chunks; the unsealed tail is read
     live (`tail_rows()`) so the fit trains on every admitted row.
  2. WARM FIT — alternating coordinate passes anchored on the CURRENT
     serving model: the fixed effect re-fits through the full
     `GameEstimator` machinery (offsets carry the random-effect margins;
     `initial_model` warm-starts at the incumbent; an optional
     `SolverSchedule` routes the pass through the stochastic single-pass
     lane; on a CUDA registry a dense fixed effect runs the fused
     value-and-gradient kernel, one launch per pass), and each random effect re-solves through
     `game.anchored.offline_anchored_refit` — the SAME prior-anchored
     objective the online tier publishes deltas from, anchored at the
     incumbent's live rows, so the refit is a strict generalization of
     the delta path rather than a divergent second trainer.
  3. VALIDATE — candidate vs incumbent on a held-back TAIL of the log
     (the newest rows, never shown to the fit): host-f64 loss, plus AUC
     for logistic tasks.  The candidate must win by
     `min_loss_improvement` or the incumbent keeps serving.
  4. SWAP — `models.io.save_game_model` to a version directory, then
     `ModelRegistry.load()` (the tail of which is `install()`): the
     publish hook ships the swap down the replication log fleet-wide,
     the swap hook resets the health gates and resumes the paused
     updater, and rollback semantics stay exactly those of any other
     full-model swap.

Fault sites (utils.faults): `refit.validate` and `refit.swap` fire under
the standard transient retry/backoff discipline; a fatal fault aborts
the cycle with the incumbent still serving and NO swap record written —
the swap is the last step precisely so a failed publish never strands a
half-installed candidate.  (`refit.compact` fires inside the compactor.)

Determinism: the fit consumes rows in log order, splits train/holdout by
position, and runs fixed-seed solvers — the objective history of a refit
from the log is bit-identical to one from the same rows in memory (the
parity gate in tests/port/test_torch_refit.py and chip_smoke.py's
refit_config4).

Device: the fit runs where the incumbent lives (the registry's scorer
tables) and in its dtype; every coordinate's margins are read back to the
host once per coordinate per pass, for the host-f64 residual folds.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.utils import faults

#: tasks the host-f64 validation oracle (and the anchored RE objective)
#: supports — the same pair `game.anchored.anchored_objective_np` handles
_SUPPORTED_TASKS = ("logistic_regression", "linear_regression")


class RefitError(RuntimeError):
    """A refit cycle aborted: unsupported model shape, a fatal injected
    fault, or a validate/swap step that exhausted its retries.  The
    incumbent model keeps serving."""


@dataclasses.dataclass(frozen=True)
class RefitConfig:
    """Knobs of one refit cycle (cli.refit maps 1:1)."""

    #: newest fraction of the log held back for candidate-vs-incumbent
    #: validation (never shown to the fit)
    holdout_frac: float = 0.2
    #: floor on the holdout row count (clamped to leave >= 1 train row)
    min_holdout_rows: int = 8
    #: alternating FE/RE passes over the training slice
    outer_iterations: int = 2
    #: per-pass LBFGS caps
    fe_iterations: int = 50
    re_iterations: int = 100
    tolerance: float = 1e-9
    #: lambda of the ||c - c0||^2 pull toward the incumbent's RE rows
    anchor_weight: float = 1.0
    #: L2 weight of the fixed-effect re-fit (0 = unregularized)
    fe_l2_weight: float = 0.0
    #: the candidate must beat the incumbent's holdout loss by this much
    min_loss_improvement: float = 0.0
    #: transient validate/swap retries (staging parity)
    max_attempts: int = 3
    backoff_s: float = 0.02
    #: route the FE pass through the stochastic single-pass lane
    #: (game.config.SolverSchedule); None = full-batch LBFGS
    solver_schedule: Optional[object] = None
    #: train on the unsealed log tail too (False = sealed chunks only)
    include_tail: bool = True

    def __post_init__(self):
        if not (0.0 < self.holdout_frac < 1.0):
            raise ValueError("holdout_frac must be in (0, 1), got "
                             f"{self.holdout_frac}")
        if self.outer_iterations < 1:
            raise ValueError("outer_iterations must be >= 1")


@dataclasses.dataclass(frozen=True)
class RefitResult:
    """Outcome of one `run_once()` cycle."""

    swapped: bool
    version: Optional[str]
    reason: str
    train_rows: int
    holdout_rows: int
    sealed_rows: int
    tail_rows: int
    checkpoint_seq: int
    objective_history: List[float]
    candidate: Dict[str, Optional[float]]   # holdout loss/auc
    incumbent: Dict[str, Optional[float]]


@dataclasses.dataclass
class RefitFit:
    """A fitted candidate plus the bookkeeping the parity tests compare
    (`fit_candidate()` returns one for log-sourced AND in-memory rows)."""

    model: object                 # models.game.GameModel
    objective_history: List[float]
    train: dict                   # row-dict slices (_slice_rows shape)
    holdout: dict
    #: value+gradient passes of each fixed-effect solve, in order (on a
    #: CUDA registry, the fused kernel's launches)
    fe_passes: List[int] = dataclasses.field(default_factory=list)


def _host_loss(task: str, z: np.ndarray, y: np.ndarray,
               w: Optional[np.ndarray]) -> float:
    """Weighted mean loss in host f64 — the independent validation oracle
    (same formulas as game.anchored.anchored_objective_np)."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    if task == "logistic_regression":
        per = np.logaddexp(0.0, z) - y * z
    else:
        per = 0.5 * (z - y) ** 2
    w = np.ones_like(z) if w is None else np.asarray(w, np.float64)
    return float(np.sum(w * per) / max(float(np.sum(w)), 1e-300))


def _slice_rows(rows: dict, lo: int, hi: int) -> dict:
    return {
        "features": {s: a[lo:hi] for s, a in rows["features"].items()},
        "ids": {t: a[lo:hi] for t, a in rows["ids"].items()},
        "labels": rows["labels"][lo:hi],
        "weights": rows["weights"][lo:hi],
        "offsets": rows["offsets"][lo:hi],
        "wall": rows["wall"][lo:hi],
    }


def _num_rows(rows: dict) -> int:
    return int(np.asarray(rows["labels"]).shape[0])


def _host64(t) -> np.ndarray:
    """A device tensor's values on the host in float64 (one read-back)."""
    return t.detach().to("cpu", torch.float64).numpy()


class RefitDriver:
    """One compact -> fit -> validate -> swap cycle over a serving
    registry.  Construct once and `run_once()` per cycle (the
    RefitTrigger decides when); `fit_candidate()` is the fit core,
    callable on any in-memory row dict for the parity gates."""

    def __init__(self, registry, compactor, model_root: str,
                 config: RefitConfig = RefitConfig(), metrics=None):
        self.registry = registry
        self.compactor = compactor
        self.model_root = str(model_root)
        self.config = config
        self.metrics = metrics
        self._jitter = random.Random(0x5EED)

    # -- incumbent ----------------------------------------------------------

    def incumbent_model(self):
        """The CURRENT serving model, with every online delta absorbed:
        random-effect coefficients come from the live scorer tables, not
        the model the scorer was built from (the tables are what the
        fleet is actually serving — the refit anchors there)."""
        scorer = self.registry.scorer
        model = scorer.model
        coords = dict(model.coordinates)
        for lane, _shard, _re_type in scorer.updatable_coordinates():
            coords[lane] = dataclasses.replace(
                coords[lane], coefficients=scorer.re_table(lane))
        from photon_ml_tpu_torch.models.game import GameModel
        return GameModel(coordinates=coords, task_type=model.task_type)

    # -- the cycle ----------------------------------------------------------

    def run_once(self, version: Optional[str] = None) -> RefitResult:
        """One full cycle.  Raises RefitError (incumbent keeps serving)
        on a fatal validate/swap fault; returns a non-swapped result when
        there is nothing to train on or the candidate loses."""
        try:
            return self._cycle(version)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            if self.metrics is not None:
                self.metrics.observe_refit_run(swapped=False, failed=True)
            telemetry.event("refit_failed",
                            error=f"{type(e).__name__}: {e}")
            raise

    def _cycle(self, version: Optional[str]) -> RefitResult:
        with telemetry.span("refit_compact"):
            manifest = self.compactor.compact()
        sealed = int(manifest["sealed_rows"])
        checkpoint_seq = int(manifest["resume"]["next_seq"]) - 1
        rows = self.gather_rows()
        n = _num_rows(rows) if rows is not None else 0
        tail_n = n - sealed
        if n < 2:
            if self.metrics is not None:
                self.metrics.observe_refit_run(swapped=False)
            return RefitResult(
                swapped=False, version=None,
                reason=f"not enough feedback rows to refit ({n})",
                train_rows=0, holdout_rows=0, sealed_rows=sealed,
                tail_rows=max(tail_n, 0), checkpoint_seq=checkpoint_seq,
                objective_history=[], candidate={}, incumbent={})

        with telemetry.span("refit_fit", rows=n):
            fit = self.fit_candidate(rows)
        version = version or f"refit-seq{checkpoint_seq}-n{n}"
        with telemetry.span("refit_validate"):
            cand_m, inc_m = self._validate_with_retry(fit, version)
        win = (cand_m["loss"]
               <= inc_m["loss"] - self.config.min_loss_improvement)
        telemetry.event("refit_validated", version=version,
                        candidate_loss=cand_m["loss"],
                        incumbent_loss=inc_m["loss"], win=win)
        common = dict(
            train_rows=_num_rows(fit.train),
            holdout_rows=_num_rows(fit.holdout), sealed_rows=sealed,
            tail_rows=max(tail_n, 0), checkpoint_seq=checkpoint_seq,
            objective_history=fit.objective_history,
            candidate=cand_m, incumbent=inc_m)
        if not win:
            if self.metrics is not None:
                self.metrics.observe_refit_run(swapped=False)
            return RefitResult(
                swapped=False, version=None,
                reason="candidate did not beat the incumbent on the "
                       "holdout tail", **common)

        with telemetry.span("refit_swap", version=version):
            self._swap_with_retry(fit.model, version)
        if self.metrics is not None:
            self.metrics.observe_refit_run(swapped=True)
        telemetry.event("refit_swapped", version=version,
                        train_rows=common["train_rows"])
        return RefitResult(swapped=True, version=version,
                           reason="candidate won validation", **common)

    # -- rows ---------------------------------------------------------------

    def gather_rows(self) -> Optional[dict]:
        """Every compacted + (optionally) tail row as one host row-dict in
        log order, or None when the lane is empty."""
        from photon_ml_tpu_torch.refit.compactor import CompactedDataset
        manifest = self.compactor.manifest()
        tail = (self.compactor.tail_rows() if self.config.include_tail
                else None)
        if int(manifest["sealed_rows"]) == 0:
            if tail is None:
                return None
            return {
                "features": tail["features"],
                "ids": {t: np.asarray(v, dtype=object)
                        for t, v in tail["ids"].items()},
                "labels": tail["labels"], "weights": tail["weights"],
                "offsets": tail["offsets"], "wall": tail["wall"],
            }
        ds = CompactedDataset(self.compactor.out_dir)
        _game_ds, merged = ds.to_game_dataset(tail=tail)
        return merged

    # -- fit ----------------------------------------------------------------

    def _split(self, rows: dict) -> Tuple[dict, dict]:
        """Time-ordered split: the NEWEST rows are the holdout — the
        validation question is 'does the candidate serve the freshest
        traffic better', so the holdout must be the freshest traffic."""
        cfg = self.config
        n = _num_rows(rows)
        hold = int(round(cfg.holdout_frac * n))
        hold = min(max(hold, cfg.min_holdout_rows, 1), n - 1)
        return _slice_rows(rows, 0, n - hold), _slice_rows(rows, n - hold, n)

    def fit_candidate(self, rows: dict) -> RefitFit:
        """The fit core: split, then `outer_iterations` alternating
        passes warm-started at the incumbent.  Pure function of (rows,
        incumbent model, config) — the refit-from-log parity gates call
        it directly on in-memory rows."""
        from photon_ml_tpu_torch.data.game_data import build_game_dataset
        from photon_ml_tpu_torch.models.game import (FixedEffectModel, GameModel,
                                               RandomEffectModel)
        cfg = self.config
        incumbent = self.incumbent_model()
        task = incumbent.task_type
        if task not in _SUPPORTED_TASKS:
            raise RefitError(f"task {task!r} is not refittable (supported: "
                             f"{list(_SUPPORTED_TASKS)})")
        coords = dict(incumbent.coordinates)
        fe_names = [k for k, m in coords.items()
                    if isinstance(m, FixedEffectModel)]
        re_names = [k for k, m in coords.items()
                    if isinstance(m, RandomEffectModel)]
        if set(coords) - set(fe_names) - set(re_names):
            other = sorted(set(coords) - set(fe_names) - set(re_names))
            raise RefitError(f"coordinates {other} are neither fixed nor "
                             "plain random effects — the warm refit "
                             "supports only those shapes")
        for k in re_names:
            if (coords[k].projection is not None
                    or coords[k].projection_matrix is not None):
                raise RefitError(f"random effect {k!r} is projected — the "
                                 "anchored refit needs identity-space rows")

        train, holdout = self._split(rows)
        entity_vocabs = {coords[k].random_effect_type:
                         np.asarray(coords[k].entity_ids)
                         for k in re_names}
        base = np.asarray(train["offsets"], np.float64)
        train_ds = build_game_dataset(
            train["labels"], train["features"], offsets=train["offsets"],
            weights=train["weights"], entity_ids=train["ids"],
            entity_vocabs=entity_vocabs)

        history: List[float] = []
        fe_passes: List[int] = []
        for _outer in range(cfg.outer_iterations):
            for name in fe_names:
                coords[name], fe_hist, passes = self._fe_pass(
                    train_ds, base, coords, name, task)
                history.extend(fe_hist)
                fe_passes.append(passes)
            for name in re_names:
                coords[name] = self._re_pass(train_ds, base, coords, name,
                                             task)
            model = GameModel(coordinates=dict(coords), task_type=task)
            z = _host64(model.score_dataset(train_ds)) + base
            history.append(_host_loss(task, z, train["labels"],
                                      train["weights"]))
        return RefitFit(model=GameModel(coordinates=dict(coords),
                                        task_type=task),
                        objective_history=history, train=train,
                        holdout=holdout, fe_passes=fe_passes)

    def _fe_pass(self, train_ds, base, coords, name, task):
        """Fixed-effect re-fit through the full GameEstimator: offsets
        carry every OTHER coordinate's margin, the incumbent FE
        warm-starts, and cfg.solver_schedule can route the pass through
        the stochastic single-pass solver lane.  The estimator runs on the
        incumbent coefficients' device and in their dtype.  Returns (the
        new coordinate model, its objective history, its value+gradient
        passes)."""
        from photon_ml_tpu_torch.game.config import (FixedEffectCoordinateConfig,
                                               GameTrainingConfig,
                                               GLMOptimizationConfig)
        from photon_ml_tpu_torch.game.estimator import GameEstimator
        from photon_ml_tpu_torch.models.game import GameModel
        from photon_ml_tpu_torch.optim import (OptimizerConfig,
                                         RegularizationContext,
                                         RegularizationType)
        cfg = self.config
        other = np.zeros_like(base)
        for k, m in coords.items():
            if k != name:
                other = other + _host64(m.score_dataset(train_ds))
        ds_fe = dataclasses.replace(train_ds, offsets=base + other)
        fe_cfg = GameTrainingConfig(
            task_type=task,
            coordinates={name: FixedEffectCoordinateConfig(
                feature_shard=coords[name].feature_shard,
                optimization=GLMOptimizationConfig(
                    optimizer=OptimizerConfig(
                        max_iterations=cfg.fe_iterations,
                        tolerance=cfg.tolerance),
                    regularization=RegularizationContext(
                        RegularizationType.L2),
                    regularization_weight=cfg.fe_l2_weight),
                solver_schedule=cfg.solver_schedule)},
            updating_sequence=[name], num_outer_iterations=1)
        c0 = coords[name].glm.coefficients.means
        res = GameEstimator(fe_cfg, device=c0.device, dtype=c0.dtype).fit(
            ds_fe, initial_model=GameModel(
                coordinates={name: coords[name]}, task_type=task))
        passes = res.descent.solver_diagnostics()[name]["value_gradient_passes"]
        return (res.model.coordinates[name],
                [float(v) for v in res.objective_history], int(passes))

    def _re_pass(self, train_ds, base, coords, name, task):
        """Random-effect re-solve through the offline anchored path:
        dataset offsets = base + full-model margin (the residual fold the
        online tier uses), prior = the incumbent's live rows, so every
        entity's subproblem is the exact objective the delta swaps
        optimize — at full-epoch scale."""
        from photon_ml_tpu_torch.game.anchored import offline_anchored_refit
        from photon_ml_tpu_torch.ops.losses import TASK_LOSSES
        from photon_ml_tpu_torch.optim import OptimizerConfig
        cfg = self.config
        model = coords[name]
        re_type = model.random_effect_type
        idx = np.asarray(train_ds.entity_indices[re_type])
        present = np.flatnonzero(idx >= 0)
        if present.size == 0:
            return model     # no training rows touch this coordinate
        margin = np.zeros_like(base)
        for m in coords.values():
            margin = margin + _host64(m.score_dataset(train_ds))
        sub = dataclasses.replace(train_ds,
                                  offsets=base + margin).subset(present)
        # a copy: on the CPU in float64 the read-back shares the live
        # table's memory
        table = _host64(model.coefficients).copy()
        vocab = np.asarray(model.entity_ids)
        pos = {v: i for i, v in enumerate(vocab.tolist())}
        touched = sorted({vocab[j] for j in np.unique(idx[present])})
        prior = {v: table[pos[v]] for v in touched}
        new_rows = offline_anchored_refit(
            sub, re_type, model.feature_shard, prior,
            TASK_LOSSES[task],
            OptimizerConfig(max_iterations=cfg.re_iterations,
                            tolerance=cfg.tolerance),
            anchor_weight=cfg.anchor_weight,
            device=model.coefficients.device)
        for v, row in new_rows.items():
            table[pos[v]] = row
        return dataclasses.replace(model, coefficients=torch.as_tensor(
            table, dtype=model.coefficients.dtype,
            device=model.coefficients.device))

    # -- validate / swap ----------------------------------------------------

    def _holdout_metrics(self, model, hold_ds, holdout,
                         task) -> Dict[str, Optional[float]]:
        z = (_host64(model.score_dataset(hold_ds))
             + np.asarray(holdout["offsets"], np.float64))
        out: Dict[str, Optional[float]] = {
            "loss": _host_loss(task, z, holdout["labels"],
                               holdout["weights"]),
            "auc": None}
        if task == "logistic_regression":
            labels = np.asarray(holdout["labels"], np.float64)
            if 0.0 < float(labels.mean()) < 1.0:   # AUC needs both classes
                from photon_ml_tpu_torch.evaluation.evaluators import \
                    area_under_roc_curve
                out["auc"] = float(area_under_roc_curve(
                    z, labels, np.asarray(holdout["weights"], np.float64)))
        return out

    def _validate_with_retry(self, fit: RefitFit, version: str):
        """Candidate vs incumbent on the holdout tail, behind the
        `refit.validate` fault site with the staging retry discipline.
        Fatal -> RefitError: the cycle aborts with the incumbent serving
        and no swap record written."""
        from photon_ml_tpu_torch.data.game_data import build_game_dataset
        cfg = self.config
        incumbent = self.incumbent_model()
        task = incumbent.task_type
        vocabs = {m.random_effect_type: np.asarray(m.entity_ids)
                  for m in fit.model.coordinates.values()
                  if hasattr(m, "random_effect_type")}
        hold_ds = build_game_dataset(
            fit.holdout["labels"], fit.holdout["features"],
            offsets=fit.holdout["offsets"], weights=fit.holdout["weights"],
            entity_ids=fit.holdout["ids"], entity_vocabs=vocabs)
        attempt = 0
        while True:
            attempt += 1
            try:
                faults.fire("refit.validate", candidate=version)
                cand = self._holdout_metrics(fit.model, hold_ds,
                                             fit.holdout, task)
                inc = self._holdout_metrics(incumbent, hold_ds,
                                            fit.holdout, task)
                return cand, inc
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise RefitError(
                        f"validation of {version} failed: "
                        f"{type(e).__name__}: {e}") from e
                telemetry.event("refit_validate_retry", attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))

    def _swap_with_retry(self, model, version: str) -> str:
        """Save the candidate and install it through the registry — the
        LAST step of the cycle, behind the `refit.swap` fault site.  The
        registry's publish hook ships the swap down the replication log;
        its swap hooks reset the health gates and resume the updater."""
        from photon_ml_tpu_torch.models.io import save_game_model
        cfg = self.config
        version_dir = os.path.join(self.model_root, version)
        save_game_model(model, version_dir)
        attempt = 0
        while True:
            attempt += 1
            try:
                faults.fire("refit.swap", version=version)
                return self.registry.load(version_dir, version=version)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e) or attempt >= cfg.max_attempts:
                    raise RefitError(
                        f"swap to {version} failed: "
                        f"{type(e).__name__}: {e}") from e
                telemetry.event("refit_swap_retry", attempt=attempt,
                                version=version,
                                error=f"{type(e).__name__}: {e}")
                time.sleep(cfg.backoff_s * (2 ** (attempt - 1))
                           * (1.0 + 0.25 * self._jitter.random()))
