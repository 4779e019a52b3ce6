"""Vectorized hyperparameter sweeps: K candidates over one prepared dataset
(port of photon_ml_tpu/hyperparameter/vectorized.py).

`SweepEvaluator` owns the shared state: coordinates, entity bucketing,
normalization statistics and the device copies of the data are built ONCE
and reused by every candidate.  Two lanes, as in the JAX package:

  * the candidate lane (`evaluate_vmapped`): K candidates' whole block
    coordinate descents run in lockstep over one copy of the data.  The
    JAX package vmaps each visit's solve over the candidates; here the
    candidate axis is the lane axis of optim/batched.py's host-stepped
    LBFGS/OWLQN (per-lane L1 weights) or optim/tron.py's tron_lanes.  The
    fixed effect's K lanes take ops/lanes.py's oracle (on the card, one
    launch of the lanes kernel per value+gradient pass for up to 16
    candidates; a dense fixed effect wider than that kernel takes, one
    launch of the single kernel per candidate); a random-effect bucket's
    K x E lanes take
    parallel/random_effect.py's lanes oracle, the blocks shared by the
    candidates.  A lane that has stopped is frozen while the others run,
    as under vmap, so the candidate that needs the most rounds sets each
    visit's pace.  Objectives accumulate as device [K] vectors and are read
    back once at the end;
  * the path lane (`evaluate_path`): candidates one after another along
    the regularization path, strong to weak, each warm-started from its
    neighbour's solution over the SAME prepared coordinates.

The JAX package counts its compiled-program dispatches; PyTorch runs
eagerly, so the candidate lane records instead what the port can count:
per visit, the batched solves' value+gradient rounds, the host's
read-backs of lane flags and the kernels' launches (`visits`).  The
`sweep.candidates` and `sweep.dispatches` counters and the `sweep/prepare`
and `sweep/vmapped` spans are the JAX package's.  `sweep.dispatches`
counts the candidate lane's device dispatch groups, each the eager
launches that stand for one of the JAX package's compiled programs: a
fixed effect's batched solve, a random-effect bucket's batched solve, a
random effect's rescore, and one validation rescore per coordinate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.game.config import GameTrainingConfig
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult, PhaseTimings, TrackerSummary, run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate, RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.estimator import GameResult
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.ops import hopper_kernels
from photon_ml_tpu_torch.ops.lanes import FixedEffectLanes, lanes_matvec
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES
from photon_ml_tpu_torch.optim import batched
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.optim.schedule import RegWeights
from photon_ml_tpu_torch.optim.types import ConvergenceReason
from photon_ml_tpu_torch.parallel.random_effect import (
    lanes_hessian_vector_at, lanes_value_and_gradient, score_entities_matmul,
    score_entities_plain, score_entities_scatter,
)


def _host_split(reg, weight: float) -> Tuple[float, float]:
    """reg.split as host arithmetic (the K candidates' splits become one
    [K] tensor each)."""
    w = float(weight)
    if reg.reg_type == RegularizationType.NONE:
        return 0.0, 0.0
    if reg.reg_type == RegularizationType.L1:
        return w, 0.0
    if reg.reg_type == RegularizationType.L2:
        return 0.0, w
    a = float(reg.elastic_net_alpha)
    return a * w, (1.0 - a) * w


def _reason_counts(reason) -> Dict[str, int]:
    """{ConvergenceReason name: lane count} of a scalar or [E] array."""
    out: Dict[str, int] = {}
    for code, count in zip(*np.unique(np.atleast_1d(np.asarray(reason)),
                                      return_counts=True)):
        try:
            name = ConvergenceReason(int(code)).name
        except ValueError:
            name = str(int(code))
        out[name] = out.get(name, 0) + int(count)
    return out


def _neutralized(config: GameTrainingConfig) -> GameTrainingConfig:
    """The config with every regularization weight zeroed — two configs are
    sweep-compatible iff their neutralized forms are equal (only the
    weights may vary across candidates)."""
    coords = {}
    for name, c in config.coordinates.items():
        opt = dataclasses.replace(c.optimization, regularization_weight=0.0)
        lat = getattr(c, "latent_optimization", None)
        if lat is not None:
            coords[name] = dataclasses.replace(
                c, optimization=opt, latent_optimization=dataclasses.replace(
                    lat, regularization_weight=0.0))
        else:
            coords[name] = dataclasses.replace(c, optimization=opt)
    return dataclasses.replace(config, coordinates=coords)


@dataclasses.dataclass
class SweepVisit:
    """One coordinate visit of the candidate lane: the batched solves'
    value+gradient rounds (summed over a random effect's buckets), their
    Hessian-vector rounds (TRON, else None), the host's read-backs of lane
    flags, the lanes kernel's launches, the visit's host wall seconds
    (ended by its solves' last read-back), for a random effect per bucket
    ([K * E, S, d], rounds, read-backs), and for a fixed effect the route
    of its passes (ops/lanes.py::FixedEffectLanes.route) and the single
    fused kernel's launches (the "single" route's)."""

    iteration: int
    coordinate: str
    rounds: int
    hv_rounds: Optional[int]
    readbacks: int
    lanes_launches: int
    seconds: float
    buckets: Optional[List[Tuple[Tuple[int, int, int], int, int]]] = None
    route: Optional[str] = None
    single_launches: int = 0


class SweepEvaluator:
    """Shared-state sweep evaluator: ONE prepared dataset (coordinates,
    entity bucketing, normalization stats, device residuals), many
    regularization candidates.

    Lanes:
      * `evaluate_vmapped(configs)` — K candidates' whole block coordinate
        descents in lockstep, one batched solve per (coordinate, visit)
        against ONE copy of the data.  Eligibility: every coordinate a
        resident FixedEffectCoordinate (no downsampling) or a plain
        RandomEffectCoordinate; zero-initialized models.
      * `evaluate_path(configs)` — sequential lane for every other shape
        (streamed FE, factored coordinates, warm starts): candidates sorted
        strong-to-weak by total regularization, each warm-started from its
        neighbor's solution over the SAME prepared coordinates.
      * `evaluate(configs)` picks automatically; `evaluate_config(config)`
        is the single-candidate entry the GP search loop drives.
    """

    def __init__(self, estimator, data: GameDataset,
                 validation_data: Optional[GameDataset] = None,
                 evaluator_specs: Optional[Sequence[str]] = None):
        self.estimator = estimator
        self.config = estimator.config
        self.device = estimator.device
        self.dtype = estimator.dtype
        self.mesh = getattr(estimator, "mesh", None)
        self.data = data
        self.validation_data = validation_data
        self.evaluator_specs = evaluator_specs
        self._loss = TASK_LOSSES[self.config.task_type]
        with telemetry.span("sweep/prepare"):
            self.coords = estimator._build_coordinates(data)
            self.specs = (estimator._validation_specs(evaluator_specs)
                          if validation_data is not None else [])
        self._neutral = _neutralized(self.config)
        # flat device vectors shared by every candidate of the candidate
        # lane (the path lane's run_coordinate_descent makes its own)
        self._labels = None
        self._weights = None
        self._base_offsets = None
        self._val_lanes_cache: Dict[str, torch.Tensor] = {}
        # the last evaluate_vmapped's visits, in order
        self.visits: List[SweepVisit] = []

    # -- shared staging -------------------------------------------------------
    def _on_device(self, a):
        return None if a is None else torch.as_tensor(a).to(
            device=self.device, dtype=self.dtype)

    def _flat_vectors(self):
        if self._labels is None:
            self._labels = self._on_device(self.data.response)
            self._weights = self._on_device(self.data.weights)
            self._base_offsets = (
                torch.zeros(self.data.num_rows, dtype=self.dtype, device=self.device)
                if self.data.offsets is None else self._on_device(self.data.offsets))
        return self._labels, self._weights, self._base_offsets

    def compatible(self, config: GameTrainingConfig) -> bool:
        """True iff `config` differs from the prepared one ONLY in
        regularization weights."""
        try:
            return _neutralized(config) == self._neutral
        except (TypeError, ValueError):
            return False

    def vmap_eligible(self) -> Tuple[bool, str]:
        """(eligible, reason) for the candidate lane, with the JAX
        package's reasons."""
        if self.mesh is not None and self.mesh.size > 1:
            return False, "multi-device mesh (per-coordinate staging path)"
        for name in self.config.updating_sequence:
            c = self.coords[name]
            if isinstance(c, FixedEffectCoordinate):
                if c.streamed:
                    return False, f"{name}: streamed fixed effect"
                if c.config.optimization.downsampling_rate is not None:
                    return False, (f"{name}: downsampling draws a fresh "
                                   "per-update mask")
            elif isinstance(c, RandomEffectCoordinate):
                continue
            else:
                return False, f"{name}: factored coordinate"
        return True, "ok"

    # -- lane dispatch --------------------------------------------------------
    def evaluate(self, configs: Sequence[GameTrainingConfig],
                 initial_model=None) -> List[GameResult]:
        ok, _why = self.vmap_eligible()
        if ok and initial_model is None and len(configs) > 1:
            return self.evaluate_vmapped(configs)
        return self.evaluate_path(configs, initial_model=initial_model)

    # -- path lane ------------------------------------------------------------
    @staticmethod
    def _total_reg(config: GameTrainingConfig) -> float:
        total = 0.0
        for c in config.coordinates.values():
            total += float(c.optimization.regularization_weight)
            lat = getattr(c, "latent_optimization", None)
            if lat is not None:
                total += float(lat.regularization_weight)
        return total

    def _apply_weights(self, config: GameTrainingConfig) -> None:
        """Swap ONLY the regularization weights into the prepared
        coordinates (everything else is identical by `compatible`; the
        coordinate keeps its resolved-constraint optimizer config)."""
        for name in self.config.updating_sequence:
            coord = self.coords[name]
            cand = config.coordinates[name]
            opt = dataclasses.replace(
                coord.config.optimization,
                regularization_weight=cand.optimization.regularization_weight)
            lat_old = getattr(coord.config, "latent_optimization", None)
            if lat_old is not None:
                coord.config = dataclasses.replace(
                    coord.config, optimization=opt,
                    latent_optimization=dataclasses.replace(
                        lat_old, regularization_weight=cand
                        .latent_optimization.regularization_weight))
            else:
                coord.config = dataclasses.replace(coord.config,
                                                   optimization=opt)

    def evaluate_config(self, config: GameTrainingConfig, initial_model=None,
                        timing_mode: str = "pipelined",
                        _counted: bool = False) -> GameResult:
        """One candidate over the SHARED prepared coordinates — the
        hoisted replacement for GameEstimator(config).fit(data, ...): no
        dataset rebuild, no re-bucketing, no new device copies."""
        if not self.compatible(config):
            raise ValueError(
                "candidate config differs from the prepared sweep state in "
                "more than regularization weights; use a fresh "
                "SweepEvaluator (or a full GameEstimator.fit)")
        if not _counted:
            telemetry.counter("sweep.candidates").inc()
        self._apply_weights(config)
        residency = self.estimator._residency_manager(self.coords, self.data)
        schedules = {name: (c.solver_schedule or config.solver_schedule)
                     for name, c in config.coordinates.items()}
        descent = run_coordinate_descent(
            self.coords, list(config.updating_sequence),
            config.num_outer_iterations, self.data, config.task_type,
            validation_dataset=self.validation_data,
            validation_specs=self.specs,
            initial_models=(dict(initial_model.coordinates)
                            if initial_model is not None else None),
            timing_mode=timing_mode, device=self.device, dtype=self.dtype,
            residency=residency,
            solver_schedules=(schedules if any(schedules.values())
                              else None))
        validation = {name: hist[-1] for name, hist in
                      descent.validation_history.items() if hist}
        return GameResult(model=descent.best_model, config=config,
                          objective_history=descent.objective_history,
                          validation=validation, descent=descent,
                          validation_specs=self.specs,
                          residency=residency.accounting())

    def evaluate_path(self, configs: Sequence[GameTrainingConfig],
                      initial_model=None, warm_start: bool = True,
                      timing_mode: str = "pipelined") -> List[GameResult]:
        """Sequential lane: candidates sorted strong-to-weak by total
        regularization, each warm-started from its path neighbor
        (reference: ModelTraining.scala:160-196's lambda-sweep warm start;
        glmnet's regularization-path discipline).  Results return in the
        CALLER's candidate order."""
        telemetry.counter("sweep.candidates").inc(len(configs))
        order = sorted(range(len(configs)),
                       key=lambda k: -self._total_reg(configs[k]))
        results: List[Optional[GameResult]] = [None] * len(configs)
        prev = initial_model
        for k in order:
            results[k] = self.evaluate_config(
                configs[k], initial_model=prev, timing_mode=timing_mode,
                _counted=True)
            if warm_start:
                prev = results[k].model
        return results

    # -- candidate lane -------------------------------------------------------
    def _candidate_regweights(self, configs, name) -> RegWeights:
        l1s, l2s = [], []
        for cfg in configs:
            opt = cfg.coordinates[name].optimization
            l1, l2 = _host_split(opt.regularization, opt.regularization_weight)
            l1s.append(l1)
            l2s.append(l2)
        as_t = lambda v: torch.tensor(v, dtype=self.dtype, device=self.device)
        return RegWeights(as_t(l1s), as_t(l2s))

    def _re_scores(self, coord, c: torch.Tensor, x, lanes) -> torch.Tensor:
        """[K, n] per-candidate entity scores of c [K, E, d] over the rows
        of `x` mapped to lanes by `lanes`."""
        red = coord.red
        if red.projection_matrix is not None:
            p = torch.as_tensor(red.projection_matrix).to(device=c.device, dtype=c.dtype)
            return torch.stack([score_entities_matmul(ck, p, x, lanes) for ck in c])
        if red.projection is not None:
            return torch.stack([score_entities_scatter(ck, coord.proj_dev, x, lanes,
                                                       global_dim=red.global_dim)
                                for ck in c])
        return torch.stack([score_entities_plain(ck, x, lanes) for ck in c])

    def _fe_visit(self, visit: SweepVisit, coord: FixedEffectCoordinate,
                  c0: torch.Tensor, offsets: torch.Tensor, rw: RegWeights):
        """The fixed effect's K solves as one batched solve: -> (original-
        space coefficients [K, d], scores [K, n], penalties [K] in the
        solver's space, iterations, reasons and passes [K]); the solve's
        counts land in `visit`."""
        opt = coord.config.optimization
        norm = coord.norm
        x0 = (c0 if norm is None else
              torch.stack([norm.model_to_transformed_space(ck) for ck in c0]))
        oracle = FixedEffectLanes(coord.loss, coord.x, coord.labels, offsets,
                                  rw.l2_weight, weights=coord.weights, norm=norm)
        before = hopper_kernels.LANES_LAUNCHES, hopper_kernels.LAUNCHES
        res = batched.solve(oracle.value_and_gradient, x0, opt.optimizer,
                            opt.regularization, rw, loss=coord.loss,
                            hessian_vector_at=oracle.hessian_vector_at)
        visit.lanes_launches = hopper_kernels.LANES_LAUNCHES - before[0]
        visit.single_launches = hopper_kernels.LAUNCHES - before[1]
        visit.route = oracle.route
        visit.rounds, visit.hv_rounds, visit.readbacks = (res.rounds, res.hv_rounds,
                                                          res.readbacks)
        pen = (0.5 * rw.l2_weight * (res.x * res.x).sum(-1)
               + rw.l1_weight * res.x.abs().sum(-1))
        c = (res.x if norm is None else
             torch.stack([norm.model_to_original_space(xk) for xk in res.x]))
        passes = res.fg_count if res.fg_count is not None else res.hv_count
        return c, lanes_matvec(coord.x, c), pen, res.iterations, res.reason, passes

    def _re_visit(self, visit: SweepVisit, coord: RandomEffectCoordinate,
                  c0: torch.Tensor, offsets: torch.Tensor, rw: RegWeights):
        """Every bucket's K x E entity solves as one batched solve each,
        the candidates' flat residual offsets gathered into block layout
        on the device: -> (coefficients [K, E, d], scores [K, n], [K]
        penalties, iterations, reasons and passes [K, E]); the solves'
        counts, summed and per bucket, land in `visit`."""
        opt = coord.config.optimization
        K = c0.shape[0]
        parts, its, reasons, passes = [], [], [], []
        visit.buckets = []
        for bucket in coord.red.buckets:
            blocks = bucket.blocks
            lo, eb = bucket.lane_start, bucket.num_entities
            off = (offsets[:, bucket.safe_ids_dev()] * blocks.mask).to(blocks.x.dtype)
            x0 = c0[:, lo:lo + eb].reshape(K * eb, -1)
            res = batched.solve(
                lambda c: lanes_value_and_gradient(coord.loss, blocks, off, c,
                                                   rw.l2_weight),
                x0, opt.optimizer, opt.regularization,
                RegWeights(rw.l1_weight.repeat_interleave(eb), rw.l2_weight),
                loss=coord.loss,
                hessian_vector_at=lambda c: lanes_hessian_vector_at(
                    coord.loss, blocks, off, c, rw.l2_weight))
            parts.append(res.x.reshape(K, eb, -1))
            its.append(res.iterations.reshape(K, eb))
            reasons.append(res.reason.reshape(K, eb))
            count = res.fg_count if res.fg_count is not None else res.hv_count
            passes.append(count.reshape(K, eb))
            visit.rounds += res.rounds
            visit.readbacks += res.readbacks
            if res.hv_rounds is not None:
                visit.hv_rounds = (visit.hv_rounds or 0) + res.hv_rounds
            visit.buckets.append(((K * eb,) + tuple(blocks.x.shape[1:]), res.rounds,
                                  res.readbacks))
        c = torch.cat(parts, dim=1)
        pen = (0.5 * rw.l2_weight * (c * c).sum((1, 2))
               + rw.l1_weight * c.abs().sum((1, 2)))
        s = self._re_scores(coord, c, coord.flat_x, coord.lanes)
        return (c, s, pen, torch.cat(its, dim=1), torch.cat(reasons, dim=1),
                torch.cat(passes, dim=1))

    def _data_term(self, total, base_offsets, labels, weights) -> torch.Tensor:
        """Per-candidate weighted data-loss sum: [K, n] total scores -> [K]."""
        l = self._loss.loss(total + base_offsets, labels)
        return (l if weights is None else weights * l).sum(-1)

    def evaluate_vmapped(self, configs: Sequence[GameTrainingConfig],
                         num_outer_iterations: Optional[int] = None
                         ) -> List[GameResult]:
        """The candidate lane: K candidates' block coordinate descents in
        lockstep, one batched solve per (coordinate, visit) against ONE
        copy of the data.  Residual algebra is identical to
        run_coordinate_descent (partial = total - own; update at base +
        partial; total = partial + new), carried with a [K, n] candidate
        axis; objectives accumulate as device [K] vectors and are read back
        once at the end.  Validation is evaluated once per candidate on
        the FINAL model (per-visit best-model tracking is a path-lane
        feature; use `evaluate_path` when you need it).  Each visit's
        rounds, read-backs and lanes-kernel launches land in
        `self.visits`."""
        ok, why = self.vmap_eligible()
        if not ok:
            raise ValueError(f"vmap lane ineligible: {why}")
        for cfg in configs:
            if not self.compatible(cfg):
                raise ValueError(
                    "candidate config differs from the prepared sweep state "
                    "in more than regularization weights")
        K = len(configs)
        num_iters = (num_outer_iterations if num_outer_iterations is not None
                     else self.config.num_outer_iterations)
        telemetry.counter("sweep.candidates").inc(K)
        dispatches = 0
        seq = list(self.config.updating_sequence)
        labels, weights, base_offsets = self._flat_vectors()
        n = self.data.num_rows
        zeros = lambda *shape: torch.zeros(shape, dtype=self.dtype, device=self.device)

        rw: Dict[str, RegWeights] = {}
        models0: Dict[str, object] = {}
        coeffs: Dict[str, torch.Tensor] = {}
        scores: Dict[str, torch.Tensor] = {}
        reg_pens: Dict[str, torch.Tensor] = {}
        for name in seq:
            coord = self.coords[name]
            models0[name] = coord.initial_model()
            if isinstance(coord, FixedEffectCoordinate):
                coeffs[name] = zeros(K, coord.dim)
            else:
                coeffs[name] = zeros(K, coord.red.num_entities, coord.red.local_dim)
            rw[name] = self._candidate_regweights(configs, name)
            # zero-initialized models: scores and penalties exactly zero
            scores[name] = zeros(K, n)
            reg_pens[name] = zeros(K)
        total = zeros(K, n)

        history: List[torch.Tensor] = []              # [K] per visit
        iters_acc: Dict[str, torch.Tensor] = {}       # "it/name" -> [K] or [K, E]
        reasons_acc: Dict[str, torch.Tensor] = {}
        passes_acc: Dict[str, torch.Tensor] = {}
        self.visits = []
        with telemetry.span("sweep/vmapped", candidates=K):
            for it in range(num_iters):
                for name in seq:
                    coord = self.coords[name]
                    partial = total - scores[name]
                    off_k = base_offsets + partial                # [K, n]
                    t0 = time.perf_counter()
                    visit = SweepVisit(it, name, 0, None, 0, 0, 0.0)
                    update = (self._fe_visit if isinstance(coord, FixedEffectCoordinate)
                              else self._re_visit)
                    c, s, pen, it_k, reason, passes = update(visit, coord, coeffs[name],
                                                             off_k, rw[name])
                    visit.seconds = time.perf_counter() - t0
                    self.visits.append(visit)
                    coeffs[name] = c
                    scores[name] = s
                    reg_pens[name] = pen
                    total = partial + s
                    history.append(self._data_term(total, base_offsets, labels, weights)
                                   + sum(reg_pens.values()))
                    key = f"{it}/{name}"
                    iters_acc[key] = it_k
                    reasons_acc[key] = reason
                    passes_acc[key] = passes
                    # one batched solve (a fixed effect), or one per bucket
                    # and the rescore (a random effect)
                    dispatches += (1 if visit.buckets is None
                                   else len(visit.buckets) + 1)

            # -- validation: final models, one [K, n_val] pass ----------------
            val_matrix = None
            if self.validation_data is not None and self.specs:
                val_total = zeros(K, self.validation_data.num_rows)
                for name in seq:
                    coord = self.coords[name]
                    shard = self.validation_data.device_shard(
                        coord.config.feature_shard, self.device, self.dtype)
                    if isinstance(coord, FixedEffectCoordinate):
                        val_total = val_total + lanes_matvec(shard, coeffs[name])
                    else:
                        lanes = self._validation_lanes(name, models0[name])
                        val_total = val_total + self._re_scores(coord, coeffs[name],
                                                                shard, lanes)
                    dispatches += 1
                val_matrix = val_total.cpu().numpy()  # photonlint: disable=PH001 -- the one batched validation readback

            # ONE batched read-back for the objectives and diagnostics
            host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
            hist_host = (torch.stack(history).cpu().numpy() if history
                         else np.zeros((0, K)))
            iters_host, reasons_host, passes_host = (
                host(iters_acc), host(reasons_acc), host(passes_acc))

        telemetry.counter("sweep.dispatches").inc(dispatches)

        val_metrics: List[Dict[str, float]] = [{} for _ in range(K)]
        if val_matrix is not None:
            for k in range(K):
                for spec in self.specs:
                    val_metrics[k][spec.name] = float(
                        spec.evaluate(self.validation_data, val_matrix[k]))

        tron = {name: self.coords[name].config.optimization.optimizer.optimizer
                == OptimizerType.TRON for name in seq}
        results = []
        for k in range(K):
            models_k: Dict[str, object] = {}
            for name in seq:
                coord = self.coords[name]
                if isinstance(coord, FixedEffectCoordinate):
                    models_k[name] = FixedEffectModel(
                        model_for_task(self.config.task_type,
                                       Coefficients(coeffs[name][k])),
                        coord.config.feature_shard)
                else:
                    models_k[name] = dataclasses.replace(
                        models0[name], coefficients=coeffs[name][k])
            gm = GameModel(models_k, self.config.task_type)
            trackers = {}
            for key in iters_acc:
                count = int(np.sum(passes_host[key][k]))
                is_tron = tron[key.split("/", 1)[1]]
                trackers[key] = TrackerSummary(
                    iterations=int(np.sum(iters_host[key][k])),
                    fg_count=None if is_tron else count, wall_s=0.0,
                    reasons=_reason_counts(reasons_host[key][k]),
                    hv_count=count if is_tron else None)
            descent = CoordinateDescentResult(
                model=gm, best_model=gm,
                objective_history=[float(v) for v in hist_host[:, k]],
                validation_history={s.name: [val_metrics[k][s.name]]
                                    for s in self.specs
                                    if s.name in val_metrics[k]},
                timings=PhaseTimings(), trackers=trackers)
            results.append(GameResult(
                model=gm, config=configs[k],
                objective_history=descent.objective_history,
                validation=val_metrics[k], descent=descent,
                validation_specs=self.specs))
        return results

    def _validation_lanes(self, name: str, model0) -> torch.Tensor:
        """Validation-row -> entity-lane map for a random-effect
        coordinate, staged once per sweep (entities the training data
        never saw map to -1 and score 0 — the missing-score default)."""
        lanes = self._val_lanes_cache.get(name)
        if lanes is None:
            lanes = torch.as_tensor(model0.lanes_for(self.validation_data),
                                    device=self.device)
            self._val_lanes_cache[name] = lanes
        return lanes
