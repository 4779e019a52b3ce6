"""GameEstimator: dataset + config -> trained GAME model(s) (port of
photon_ml_tpu/game/estimator.py, one device).

reference: GameEstimator (photon-api/.../estimators/GameEstimator.scala:52):
fit() builds the per-coordinate datasets and problems, prepares the
validation evaluators and runs coordinate descent once per optimization
configuration; `fit_grid` is the multi-configuration sweep
(GameEstimator.scala:474).

Both timing modes of the JAX package run, "pipelined" by default, with
checkpoints and resume (`checkpoint_dir`, verified against the same
configuration fingerprint the JAX package computes), the non-finite solve
quarantine, solver schedules (a coordinate's own schedule over the
training config's) and HBM budgets (`hbm_budget_bytes`: streamed fixed
effects and residency rotation, game/residency.py; the result's
`residency` holds the byte accounts).  An `emitter` (utils/events.py)
receives TrainingStart, OptimizationLog and TrainingFinish events, and an
armed tracer sees each fit as a `fit` span, as in the JAX package.  With
a `mesh` (parallel/mesh.py) every rank of it runs the same fit on its
blocks; the result's `mesh_transfer` holds the bytes this rank staged.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.evaluation.evaluators import (
    default_validation_evaluator_for_task, parse_evaluator,
)
from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectCoordinateConfig, FixedEffectCoordinateConfig,
    GameTrainingConfig, GLMOptimizationConfig,
)
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult, PhaseTimings, ValidationSpec, read_checkpoint,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import (
    Coordinate, FactoredRandomEffectCoordinate, FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.residency import ResidencyManager
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.utils.events import (
    EventEmitter, OptimizationLogEvent, TrainingFinishEvent,
    TrainingStartEvent,
)


@dataclasses.dataclass
class GameResult:
    """One trained configuration (reference: GameEstimator.GameResult)."""

    model: GameModel
    config: GameTrainingConfig
    objective_history: List[float]
    validation: Dict[str, float]          # final value per evaluator
    descent: CoordinateDescentResult
    validation_specs: List[ValidationSpec] = dataclasses.field(default_factory=list)
    # how the fit's checkpoint was recovered at resume time (CheckpointState
    # .recovery: fallback flag, pruned partial writes, resumed iteration);
    # None when the fit started fresh or checkpointing was off
    checkpoint_recovery: Optional[dict] = None
    # HBM residency accounting (ResidencyManager.accounting()): budget,
    # per-coordinate block and chunk bytes, evictions, the tracked peak,
    # under_budget and the streamed coordinates' StreamStats
    residency: Optional[dict] = None
    # bytes this rank staged on a mesh during the fit (a TransferStats
    # delta: cold/warm bytes and stages, invalidations, retries); None
    # without a mesh
    mesh_transfer: Optional[dict] = None


class GameEstimator:
    """Trains a GameTrainingConfig on one device (None means cuda, which
    raises without CUDA) in `dtype` (float32 by default, as the JAX
    package computes without x64).  `emitter` receives the fit's
    training events.  With a `mesh` the fit runs on the mesh's device, one
    rank of the mesh in each process."""

    def __init__(self, config: GameTrainingConfig, device=None,
                 dtype: torch.dtype = torch.float32,
                 emitter: Optional[EventEmitter] = None, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.dtype = dtype
        self.emitter = emitter

    def _build_coordinates(self, dataset: GameDataset) -> Dict[str, Coordinate]:
        coords: Dict[str, Coordinate] = {}
        for name in self.config.updating_sequence:
            cfg = self.config.coordinates[name]
            latent = getattr(cfg, "latent_optimization", None)
            if latent is not None and latent.optimizer.constraints is not None:
                raise ValueError(
                    f"coordinate {name!r}: named feature constraints are "
                    "not supported on the latent-projection problem")
            if cfg.optimization.optimizer.constraints is not None:
                # named constraints resolve through the shard's index map
                # into positional bounds (a fixed-effect feature: random
                # effects live in projected local spaces)
                if not isinstance(cfg, FixedEffectCoordinateConfig):
                    raise ValueError(
                        f"coordinate {name!r}: named feature constraints "
                        "are supported on fixed-effect coordinates only "
                        "(the reference's constraint maps are a single-GLM "
                        "feature, GLMSuite.scala:206-280)")
                opt = cfg.optimization.optimizer.resolved_constraints(
                    (dataset.index_maps or {}).get(cfg.feature_shard))
                cfg = dataclasses.replace(cfg, optimization=dataclasses.replace(
                    cfg.optimization, optimizer=opt))
            kw = dict(device=self.device, dtype=self.dtype, seed=self.config.seed,
                      hbm_budget_bytes=self.config.hbm_budget_bytes,
                      mesh=self.mesh)
            if isinstance(cfg, FixedEffectCoordinateConfig):
                kind = FixedEffectCoordinate
            elif isinstance(cfg, FactoredRandomEffectCoordinateConfig):
                kind = FactoredRandomEffectCoordinate
            else:
                kind = RandomEffectCoordinate
            coords[name] = kind(name, dataset, cfg, self.config.task_type, **kw)
        return coords

    def _residency_manager(self, coords, dataset: GameDataset) -> ResidencyManager:
        """HBM residency bookkeeping (game/residency.py): always built, so
        every fit reports byte accounts; it only EVICTS when
        hbm_budget_bytes is set and the coordinates' resident blocks bust
        it.  The flat [n] vectors are counted as the JAX package counts
        them: per-coordinate scores + total + base offsets + labels (+
        weights), and a 4-byte lane map per entity-keyed coordinate."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        n = dataset.num_rows
        flat = (len(self.config.updating_sequence) + 3) * n * itemsize
        flat += sum(4 * n for c in self.config.coordinates.values()
                    if hasattr(c, "random_effect_type"))
        return ResidencyManager(coords, self.config.hbm_budget_bytes,
                                flat_vector_bytes=flat, mesh=self.mesh)

    def _config_fingerprint(
            self, evaluator_specs: Optional[Sequence[str]]) -> str:
        """Identity of everything that makes a checkpoint resumable: the
        full training config EXCEPT the outer iteration count (raising it
        and resuming is the intended use), PLUS the validation evaluator
        specs.  The same 16 hex digits as the JAX package's for the same
        config, since both write the same config JSON: either package
        resumes the other's checkpoints."""
        def strip_nones(v):
            # drop None-valued keys, so adding an optional config field
            # does not shift every existing fingerprint
            if isinstance(v, dict):
                return {k: strip_nones(x) for k, x in v.items() if x is not None}
            if isinstance(v, list):
                return [strip_nones(x) for x in v]
            return v

        d = strip_nones(self.config.to_dict())
        d.pop("num_outer_iterations", None)
        d["__evaluator_specs__"] = list(evaluator_specs or [])
        return hashlib.sha256(
            json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]

    def _validation_specs(self, evaluator_specs: Optional[Sequence[str]]
                          ) -> List[ValidationSpec]:
        if not evaluator_specs:
            return [ValidationSpec(
                default_validation_evaluator_for_task(self.config.task_type))]
        out = []
        for spec in evaluator_specs:
            ev, group = parse_evaluator(spec)
            out.append(ValidationSpec(ev, group))
        return out

    def fit(
        self,
        dataset: GameDataset,
        validation_dataset: Optional[GameDataset] = None,
        evaluator_specs: Optional[Sequence[str]] = None,
        initial_model: Optional[GameModel] = None,
        timing_mode: str = "pipelined",
        checkpoint_dir: Optional[str] = None,
    ) -> GameResult:
        """reference: GameEstimator.fit (GameEstimator.scala:175).

        `initial_model` warm-starts every coordinate it covers.
        `timing_mode` is "pipelined" (the default) or "strict" (see
        run_coordinate_descent).  `checkpoint_dir` persists the model after
        every outer iteration and RESUMES from the newest verified record
        already there (written by this package or the JAX package under the
        same configuration fingerprint); how it was recovered is the
        result's `checkpoint_recovery`."""
        if self.emitter is not None:
            self.emitter.send_event(TrainingStartEvent(time.time()))
        # root span of the whole fit (push/pop: an exception path is healed
        # by Tracer.finish() at export time)
        fit_span = telemetry.push("fit", task=self.config.task_type,
                                  coordinates=len(self.config.coordinates))
        spans = PhaseTimings()
        mesh_snap0 = None
        if self.mesh is not None:
            from photon_ml_tpu_torch.parallel.mesh_residency import (
                transfer_snapshot)
            mesh_snap0 = transfer_snapshot()
        # coordinate construction includes the random-effect bucketing
        with spans.span("build/coordinates", name="build"):
            coords = self._build_coordinates(dataset)
        residency = self._residency_manager(coords, dataset)
        specs = (self._validation_specs(evaluator_specs)
                 if validation_dataset is not None else [])
        resume = fingerprint = None
        if checkpoint_dir is not None:
            fingerprint = self._config_fingerprint(evaluator_specs)
            resume = read_checkpoint(checkpoint_dir, fingerprint,
                                     device=self.device, dtype=self.dtype)
        # inexact-solve schedules: a coordinate-level schedule overrides the
        # training-level one; all None is the strict no-schedule path
        schedules = {name: (c.solver_schedule or self.config.solver_schedule)
                     for name, c in self.config.coordinates.items()}
        descent = run_coordinate_descent(
            coords, self.config.updating_sequence,
            self.config.num_outer_iterations, dataset, self.config.task_type,
            validation_dataset=validation_dataset, validation_specs=specs,
            initial_models=(dict(initial_model.coordinates)
                            if initial_model is not None else None),
            timings=spans, timing_mode=timing_mode, device=self.device,
            dtype=self.dtype, checkpoint_dir=checkpoint_dir, resume=resume,
            checkpoint_fingerprint=fingerprint,
            solver_schedules=schedules if any(schedules.values()) else None,
            residency=residency)
        validation = {name: hist[-1] for name, hist in
                      descent.validation_history.items() if hist}
        if self.emitter is not None:
            self.emitter.send_event(OptimizationLogEvent(
                regularization_weights={
                    n: c.optimization.regularization_weight
                    for n, c in self.config.coordinates.items()},
                objective_history=list(descent.objective_history),
                final_metrics=dict(validation)))
            self.emitter.send_event(TrainingFinishEvent(time.time()))
        telemetry.pop(fit_span)
        mesh_transfer = None
        if mesh_snap0 is not None:
            from photon_ml_tpu_torch.parallel.mesh_residency import (
                TransferStats, transfer_snapshot)
            mesh_transfer = TransferStats.delta(mesh_snap0, transfer_snapshot())
        return GameResult(model=descent.best_model, config=self.config,
                          objective_history=descent.objective_history,
                          validation=validation, descent=descent,
                          validation_specs=specs,
                          checkpoint_recovery=(resume.recovery if resume is not None
                                               else None),
                          residency=residency.accounting(),
                          mesh_transfer=mesh_transfer)

    def fit_grid(
        self,
        dataset: GameDataset,
        grid: Dict[str, Sequence[GLMOptimizationConfig]],
        validation_dataset: Optional[GameDataset] = None,
        evaluator_specs: Optional[Sequence[str]] = None,
        warm_start: bool = False,
        initial_model: Optional[GameModel] = None,
        timing_mode: str = "pipelined",
        checkpoint_dir: Optional[str] = None,
    ) -> List[GameResult]:
        """Sweep per-coordinate optimization configs (cartesian product).
        With `warm_start`, each combo starts from the previous combo's
        model (reference: useWarmStart).  With `checkpoint_dir`, each combo
        checkpoints under its own `combo-NNN` subdirectory: re-running an
        interrupted sweep resumes the partial combo mid-descent and replays
        completed combos from their records."""
        names = list(grid)
        results: List[GameResult] = []
        previous: Optional[GameModel] = initial_model
        for i, combo in enumerate(itertools.product(*(grid[n] for n in names))):
            coords = dict(self.config.coordinates)
            for n, opt in zip(names, combo):
                coords[n] = dataclasses.replace(coords[n], optimization=opt)
            cfg = dataclasses.replace(self.config, coordinates=coords)
            sub = GameEstimator(cfg, self.device, self.dtype,
                                emitter=self.emitter, mesh=self.mesh)
            combo_ckpt = (None if checkpoint_dir is None else
                          os.path.join(checkpoint_dir, f"combo-{i:03d}"))
            results.append(sub.fit(
                dataset, validation_dataset, evaluator_specs,
                initial_model=previous if warm_start else initial_model,
                timing_mode=timing_mode, checkpoint_dir=combo_ckpt))
            previous = results[-1].model
        return results


def select_best_result(results: Sequence[GameResult]) -> GameResult:
    """Best by the first validation evaluator, in that evaluator's own
    direction (reference: cli/game/training/Driver.selectBestModel:375)."""
    if not results:
        raise ValueError("no results")
    with_val = [r for r in results if r.validation and r.validation_specs]
    if not with_val:
        return results[0]
    spec = with_val[0].validation_specs[0]
    best = with_val[0]
    for r in with_val[1:]:
        if spec.evaluator.better_than(r.validation[spec.name],
                                      best.validation[spec.name]):
            best = r
    return best
