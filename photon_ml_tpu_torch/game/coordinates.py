"""Training coordinates: the per-block-update unit of GAME (port of
photon_ml_tpu/game/coordinates.py, single-device).

A coordinate owns its training data and refits its model given the current
residual offsets; scores come back in the dataset's canonical row order,
so coordinate descent combines them with plain tensor arithmetic.

Memory modes of a fixed effect: "resident" keeps the device shard for the
fit; "streamed" keeps the shard on the HOST and runs every solve as a
double-buffered chunk stream (ops/chunked.py ChunkedGLMObjective and the
host-stepped solvers of optim/streaming.py), bounded by two chunks of
device memory; "auto" streams when an HBM budget is set that the resident
shard would bust (> budget / 2).  Under a budget, every coordinate's
device blocks are evictable (`evict_device_blocks`, driven by
game/residency.py) and are copied again from the host on the next visit.

Random draws (fixed-effect down-sampling, the factored coordinate's
Gaussian projection and latent down-sampling) come from utils/prng.py's
copy of JAX's threefry, with the JAX package's keys, so they are its draws.

Every `update` takes a solver schedule (optim/schedule.py) and the outer
iteration: the schedule's budget for that iteration caps the solve (both
solves of a factored coordinate, each against its own configured budget).

On a mesh (parallel/mesh.py, one rank per process) every coordinate
stages this rank's blocks once through the mesh residency layer: a fixed
effect its row block (data-parallel solves, parallel/fixed_effect.py; with
`shard_features` and a feature axis wider than 1, a dense unnormalized
unconstrained shard trains on the consensus-ADMM lane), an entity-keyed
coordinate its entity lanes (parallel/random_effect.py, factored.py).
A streamed fixed effect stages instead, pass by pass, the rank's row block
of every chunk (ops/chunked.py, the plan built with row_multiple = D); the
feature-axis ADMM lane stays blocked by streaming, as in the JAX package,
and the monolithic fallback streams over the data axis.  Scores come back
as the full [n] vector on every rank (each rank scores its rows, one
data-axis all_reduce assembles them), so the descent loop is the same on
every rank.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.batching import (
    RandomEffectDataset, build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.samplers import downsampler_for_task
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.data.streaming import stream_row_bytes
from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectCoordinateConfig, FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import (
    FactoredRandomEffectModel, FixedEffectModel, RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType, build_normalization_context,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.admm import ADMMConfig
from photon_ml_tpu_torch.optim.types import SolveResult
from photon_ml_tpu_torch.parallel.factored import (
    FactoredSolveResult, fit_factored_random_effects, gaussian_projection_matrix,
    principal_subspace_projection,
)
from photon_ml_tpu_torch.parallel.fixed_effect import (
    fit_fixed_effect, fit_fixed_effect_admm, score_fixed_effect,
    score_fixed_effect_admm,
)
from photon_ml_tpu_torch.parallel.mesh import concat_rows_safe
from photon_ml_tpu_torch.parallel.mesh_residency import (
    default_residency, invalidate,
)
from photon_ml_tpu_torch.parallel.random_effect import (
    EntityBlocks, fit_random_effects, score_entities_matmul,
    score_entities_plain, score_entities_scatter,
)
from photon_ml_tpu_torch.telemetry.timings import clock
from photon_ml_tpu_torch.utils import prng

logger = logging.getLogger("photon_ml_tpu_torch")

# serials of the coordinates' mesh residency keys: never reused in a
# process, where an id() can be once its coordinate is freed; a later
# coordinate that took a freed id on some ranks and not on others would
# find the earlier one's staged (and derived) blocks there and skip the
# collectives the other ranks make
_RESIDENCY_SERIALS = itertools.count()


def _penalty(c: torch.Tensor, l1: float, l2: float) -> torch.Tensor:
    """0.5*l2*||c||^2 + l1*||c||_1 (a device scalar)."""
    return 0.5 * l2 * torch.sum(c * c) + l1 * torch.sum(torch.abs(c))


def _in_dtype(w: float, dtype: torch.dtype) -> float:
    """A weight rounded to the solve's dtype, as the JAX package passes
    `jnp.asarray(weight, dtype)`."""
    return float(torch.tensor(float(w), dtype=dtype))


def _budget(schedule, outer_iteration: int, num_outer_iterations: int,
            optimizer_config):
    """The schedule's SolveBudget for this visit, or None (a full solve)."""
    return (None if schedule is None else schedule.budget_for(
        outer_iteration, num_outer_iterations, optimizer_config))


class FixedEffectCoordinate:
    """Global GLM over one feature shard, dense or sparse (reference:
    FixedEffectCoordinate.scala).  Normalization is trained in and mapped
    out per update; a sparse shard takes none (ValueError, as the JAX
    package).  With a down-sampling rate, each update draws its keep mask
    from the next split of PRNGKey(seed)."""

    def __init__(self, name: str, dataset: GameDataset,
                 config: FixedEffectCoordinateConfig, task_type: str,
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 7,
                 hbm_budget_bytes: Optional[int] = None, mesh=None):
        self.name = name
        self._serial = next(_RESIDENCY_SERIALS)
        self.config = config
        self.task_type = task_type
        self.loss = TASK_LOSSES[task_type]
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.dtype = dtype
        self._dataset = dataset
        self._key = prng.PRNGKey(seed)
        host_x = dataset.feature_shards[config.feature_shard]
        self.dim = host_x.shape[1]
        sparse = not isinstance(host_x, np.ndarray)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self._row_bytes = stream_row_bytes(self.dim, itemsize, itemsize)
        # each rank holds 1/D of the rows: budgets are per device
        data_div = 1 if mesh is None else mesh.num_data
        feature_div = 1 if mesh is None else mesh.num_feature
        if config.memory_mode == "streamed":
            self.streamed = True
        elif config.memory_mode == "resident":
            self.streamed = False
        else:  # auto: stream iff the resident shard busts half the budget
            # (the other half stays for RE blocks, flat vectors, accumulators)
            self.streamed = (hbm_budget_bytes is not None and not sparse
                             and self._resident_shard_bytes(host_x) // data_div
                             > hbm_budget_bytes // 2)
        # the feature axis: an explicit config wins, else on whenever the
        # mesh has a feature axis wider than 1
        self.shard_features = (config.shard_features
                               if config.shard_features is not None
                               else feature_div > 1)
        if config.shard_features is True and mesh is None:
            raise ValueError(
                f"coordinate {name!r}: shard_features=True but no mesh — "
                "nothing consumes the feature axis; build the estimator "
                "with make_mesh(num_feature=...) or drop shard_features")
        blockers = []
        if self.shard_features and feature_div > 1:
            if self.streamed:
                blockers.append("memory_mode='streamed'")
            if sparse:
                blockers.append("sparse feature shard")
            if config.normalization != NormalizationType.NONE:
                blockers.append(f"normalization={config.normalization.value!r}")
            opt_cfg = config.optimization.optimizer
            if (opt_cfg.box_lower is not None or opt_cfg.box_upper is not None
                    or opt_cfg.constraints is not None):
                blockers.append("box/named coefficient constraints")
        self._admm_eligible = (self.shard_features and feature_div > 1
                               and not blockers)
        if self.shard_features and feature_div > 1 and blockers:
            logger.warning(
                "coordinate %r: shard_features is on but the feature-axis "
                "ADMM lane is blocked by %s — training falls back to the "
                "monolithic solver", name, ", ".join(blockers))
        elif config.shard_features is True and feature_div <= 1:
            logger.warning(
                "coordinate %r: shard_features=True but the mesh feature "
                "axis has width 1 — no solver consumes it; build the mesh "
                "with make_mesh(num_feature=...) to light up the ADMM lane",
                name)
        if self.streamed:
            if sparse:
                raise ValueError(
                    f"coordinate {name!r}: memory_mode='streamed' requires a "
                    "dense host shard (chunking a sparse matrix would re-pack "
                    "ELL per chunk per pass); use the resident sparse path")
            if config.optimization.downsampling_rate is not None:
                raise ValueError(
                    f"coordinate {name!r}: downsampling is not supported in "
                    "streamed mode yet (the draw is a device-resident [n] "
                    "program); use memory_mode='resident'")
        on_dev = lambda a: (None if a is None else torch.as_tensor(a).to(
            device=self.device, dtype=dtype))
        self.labels = on_dev(dataset.response)
        self.weights = on_dev(dataset.weights)
        self.norm = None
        if config.normalization != NormalizationType.NONE:
            if sparse:
                raise ValueError(
                    "normalization requires a dense feature shard (stats over "
                    "a sparse shard would densify it); use normalization=NONE "
                    "for sparse/wide coordinates")
            # stats in the compute dtype, as a device copy of the shard holds it
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            summ = BasicStatisticalSummary.from_features(
                np.asarray(host_x, dtype=np_dtype),
                None if self.weights is None else self.weights.cpu().numpy())
            self.norm = build_normalization_context(
                config.normalization, mean=on_dev(summ.mean),
                variance=on_dev(summ.variance),
                max_magnitude=on_dev(summ.max_magnitude),
                intercept_index=self.dim - 1)  # intercept-last convention
        self._x = None
        self._stream = None
        if self.streamed:
            from photon_ml_tpu_torch.data.streaming import ChunkPlan
            from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
            n = host_x.shape[0]
            if config.chunk_rows is not None:
                plan = ChunkPlan.build(n, chunk_rows=config.chunk_rows,
                                       row_multiple=data_div)
            elif hbm_budget_bytes is not None:
                # two chunks fit in the coordinate's half of the budget; on
                # a mesh the budget is per device and each rank stages 1/D
                # of every chunk, so the whole chunk's budget scales by D
                plan = ChunkPlan.build(
                    n, hbm_budget_bytes=(hbm_budget_bytes // 2) * data_div,
                    bytes_per_row=self._row_bytes, row_multiple=data_div)
            else:
                plan = ChunkPlan.build(n, chunk_rows=max(n // 8, 1),
                                       row_multiple=data_div)
            # ONE persistent chunked objective: per-update residual offsets
            # (the whole [n] on every rank; each rank's fetch slices its
            # rows) swap in via replace(), and its stream statistics
            # accumulate across the fit
            self._stream = ChunkedGLMObjective(
                self.loss, host_x, dataset.response, plan,
                weights=dataset.weights, norm=self.norm, device=self.device,
                dtype=dtype, mesh=mesh if data_div > 1 else None)
            # a full device copy made earlier would defeat the budget
            dataset.release_device_shard(config.feature_shard)
        elif hbm_budget_bytes is None:
            if mesh is None:
                self.x  # noqa: B018 — the property makes the device copy now
            elif self._admm_eligible:
                # the ADMM lane trains and scores through the grid blocks
                from photon_ml_tpu_torch.parallel.fixed_effect import stage_admm_grid
                stage_admm_grid(self._mesh_key(), mesh, host_x, dtype)
            else:
                from photon_ml_tpu_torch.parallel.mesh import pad_and_shard_rows
                pad_and_shard_rows(mesh, host_x, residency_key=self._mesh_key(),
                                   dtype=dtype)

    def _mesh_key(self):
        """Residency key of this coordinate's staged mesh blocks (its
        invalidation unit, parallel/mesh_residency.py)."""
        return (self.name, self._serial)

    def _host_x(self):
        return self._dataset.feature_shards[self.config.feature_shard]

    # --- device residency -----------------------------------------------------
    def _resident_shard_bytes(self, host_x) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        if isinstance(host_x, np.ndarray):
            return int(host_x.shape[0]) * int(host_x.shape[1]) * itemsize
        # scipy CSR -> PaddedSparse ELL estimate: [n, k] indices + values
        k = int(np.diff(host_x.indptr).max()) if host_x.nnz else 1
        return int(host_x.shape[0]) * k * (4 + itemsize)

    @property
    def x(self):
        """The device feature matrix of the shard, made lazily (so an
        evicted coordinate copies it again on its next visit) and shared
        with the dataset's other consumers.  A sparse shard becomes a
        PaddedSparse with the column view its gradient needs (on a CUDA
        device always; on the CPU from CSC_MIN_COLS columns up, as the JAX
        package's single-device solve)."""
        if self.streamed:
            raise RuntimeError(f"coordinate {self.name!r} is streamed: its "
                               "feature shard is never fully device-resident")
        if self._x is None:
            self._x = self._dataset.device_shard(
                self.config.feature_shard, self.device, self.dtype, with_csc=True)
        return self._x

    def device_block_bytes(self) -> int:
        """Evictable device bytes (the shard; the flat [n] labels/weights
        stay resident and are counted among the flat vectors)."""
        if self.streamed:
            return 0
        if self._x is not None:
            from photon_ml_tpu_torch.ops.features import PaddedSparse
            if isinstance(self._x, PaddedSparse):
                # the leaves the JAX package's PaddedSparse carries
                return sum(int(t.nbytes) for t in (
                    self._x.indices, self._x.values, self._x.csc_row,
                    self._x.csc_val, self._x.csc_end) if t is not None)
            return int(self._x.nbytes)
        return self._resident_shard_bytes(
            self._dataset.feature_shards[self.config.feature_shard])

    def streaming_buffer_bytes(self) -> int:
        """Peak device bytes of the chunk double buffer (2 chunks)."""
        if not self.streamed:
            return 0
        return 2 * self._stream.plan.chunk_bytes(self._row_bytes)

    def stream_snapshot(self) -> Optional[dict]:
        """StreamStats snapshot of the coordinate's chunk stream (None when
        resident): its per-visit deltas land in TrackerSummary.stream and
        solver_diagnostics()."""
        if not self.streamed:
            return None
        return self._stream.stats.snapshot()

    def evict_device_blocks(self) -> None:
        """Residency-manager hook: drop the device shard between visits
        (nothing is pinned when streamed); on a mesh, only this
        coordinate's staged blocks."""
        if self.streamed:
            return
        self._x = None
        self._dataset.release_device_shard(self.config.feature_shard)
        if self.mesh is not None:
            invalidate(self._mesh_key())

    def initial_model(self) -> FixedEffectModel:
        """Zero coefficients (reference: Coordinate.initializeModel)."""
        return FixedEffectModel(
            model_for_task(self.task_type, Coefficients(
                torch.zeros(self.dim, dtype=self.dtype, device=self.device))),
            self.config.feature_shard)

    def update(self, model: FixedEffectModel, offsets: torch.Tensor,
               schedule=None, outer_iteration: int = 0,
               num_outer_iterations: int = 1
               ) -> Tuple[FixedEffectModel, SolveResult]:
        """Refit with residual offsets (partial scores + base offsets),
        capped by `schedule`'s budget for this outer iteration.
        reference: FixedEffectCoordinate.updateModel."""
        opt = self.config.optimization
        budget = _budget(schedule, outer_iteration, num_outer_iterations,
                         opt.optimizer)
        if self.streamed:
            return self._update_streamed(model, offsets, schedule, budget,
                                         outer_iteration, num_outer_iterations)
        weights = self.weights
        if opt.downsampling_rate is not None:
            self._key, sub = prng.split(self._key)
            keep, weights = downsampler_for_task(self.task_type)(
                sub, self.labels, self.weights, opt.downsampling_rate)
            weights = weights * keep
        x0 = model.glm.coefficients.means
        if self.norm is not None:
            x0 = self.norm.model_to_transformed_space(x0)
        lam = _in_dtype(opt.regularization_weight, self.dtype)
        if self.mesh is None:
            obj = GLMObjective(self.loss, self.x, self.labels, weights=weights,
                               offsets=offsets, norm=self.norm)
            res = fit_fixed_effect(obj, x0, None, opt.optimizer,
                                   opt.regularization, lam, budget=budget)
        elif self._admm_eligible:
            # the feature-axis consensus-ADMM lane: a schedule maps its
            # budgets onto the ADMM iterations and keeps the monolithic
            # polish for the trailing outer iterations
            obj = GLMObjective(self.loss, self._host_x(), self.labels,
                               weights=weights, offsets=offsets)
            admm_cfg = opt.admm if opt.admm is not None else ADMMConfig()
            admm_budget = _budget(schedule, outer_iteration,
                                  num_outer_iterations, admm_cfg)
            polish = None
            polish_gate = getattr(schedule, "admm_polish", None)
            if admm_cfg.polish and callable(polish_gate):
                polish = polish_gate(outer_iteration, num_outer_iterations)
            res = fit_fixed_effect_admm(
                obj, x0, self.mesh, admm_cfg, opt.optimizer,
                opt.regularization, lam, budget=admm_budget,
                polish_budget=budget, polish=polish,
                residency_key=self._mesh_key())
        else:
            obj = GLMObjective(self.loss, self._host_x(), self.labels,
                               weights=weights, offsets=offsets, norm=self.norm)
            res = fit_fixed_effect(obj, x0, self.mesh, opt.optimizer,
                                   opt.regularization, lam, budget=budget,
                                   residency_key=self._mesh_key())
        c = res.x
        if self.norm is not None:
            c = self.norm.model_to_original_space(c)
        return FixedEffectModel(model_for_task(self.task_type, Coefficients(c)),
                                self.config.feature_shard), res

    def _update_streamed(self, model, offsets, schedule, budget,
                         outer_iteration, num_outer_iterations):
        """The streamed solve: ONE [n] read-back of the device residual
        vector per update (against n*d of streamed feature traffic per
        oracle pass), then a host-stepped solve over chunk streams; a
        schedule with a stochastic lane runs early outer iterations as
        per-chunk local epochs and the final ones strictly."""
        from photon_ml_tpu_torch.optim.streaming import solve_streamed
        opt = self.config.optimization
        obj = self._stream.replace(offsets=offsets.detach().cpu().numpy())  # photonlint: disable=PH001 -- the documented ONE [n] readback per streamed update
        x0 = model.glm.coefficients.means
        if self.norm is not None:
            x0 = self.norm.model_to_transformed_space(x0)
        stoch = None
        stoch_plan = getattr(schedule, "stochastic_plan", None)
        if callable(stoch_plan):
            stoch = stoch_plan(outer_iteration, num_outer_iterations)
        res = solve_streamed(obj, x0, opt.optimizer, opt.regularization,
                             _in_dtype(opt.regularization_weight, self.dtype),
                             budget=budget, stochastic=stoch)
        c = res.x
        if self.norm is not None:
            c = self.norm.model_to_original_space(c)
        return FixedEffectModel(model_for_task(self.task_type, Coefficients(c)),
                                self.config.feature_shard), res

    def score(self, model: FixedEffectModel) -> torch.Tensor:
        """Margin contribution on the training data, canonical order (a
        streamed pass into one device [n] vector when streamed)."""
        if self.streamed:
            return self._stream.scores(model.glm.coefficients.means)
        if self.mesh is None:
            return fops.matvec(self.x, model.glm.coefficients.means)
        score = (score_fixed_effect_admm if self._admm_eligible
                 else score_fixed_effect)
        return score(model.glm, self._host_x(), self.mesh,
                     residency_key=self._mesh_key())

    def regularization_term(self, model: FixedEffectModel) -> torch.Tensor:
        """In the space the solver penalized (normalized for a normalized
        coordinate); a device scalar."""
        opt = self.config.optimization
        l1, l2 = opt.regularization.split(opt.regularization_weight)
        c = model.glm.coefficients.means
        if self.norm is not None:
            c = self.norm.model_to_transformed_space(c)
        return _penalty(c, l1, l2)


class _EntityCoordinateBase:
    """Shared setup for entity-keyed coordinates: the per-entity dataset,
    the flat feature view and the canonical-row -> entity-lane map used for
    scoring.

    Under an HBM budget the per-entity blocks keep their host copies
    (keep_host_blocks) and every device view here (flat shard, projection)
    is lazy, so the residency manager can evict this coordinate's device
    blocks after its update and score, and the next visit copies them
    again.  The [n] lane map stays resident (a flat vector)."""

    streamed = False  # chunk streaming is a fixed-effect mode

    def __init__(self, name: str, dataset: GameDataset,
                 config: RandomEffectCoordinateConfig, task_type: str,
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 7,
                 hbm_budget_bytes: Optional[int] = None, mesh=None):
        self.name = name
        self._serial = next(_RESIDENCY_SERIALS)
        self.config = config
        self.task_type = task_type
        self.loss = TASK_LOSSES[task_type]
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.dtype = dtype
        self._dataset = dataset
        # a mesh stages each rank's lanes from the host blocks
        self.red: RandomEffectDataset = build_random_effect_dataset(
            dataset, config.data_config(
                seed, keep_host_blocks=hbm_budget_bytes is not None
                or mesh is not None),
            device=self.device, block_dtype=dtype)
        self._flat_x = None
        self._proj_dev = None
        self._row_ids_dev = {}
        self._host_single_s = None
        if hbm_budget_bytes is None and mesh is None:
            self.flat_x  # noqa: B018 — the property makes the device copy now
        self.host_lanes = self.red.flat_entity_lanes(
            dataset.entity_indices[config.random_effect_type])
        self.lanes = torch.as_tensor(self.host_lanes, device=self.device)
        self.entity_id_values = np.asarray(
            dataset.entity_vocabs[config.random_effect_type])[self.red.entity_ids]
        self.last_buckets: List[BucketSolve] = []

    @property
    def flat_x(self) -> torch.Tensor:
        """Device copy of the flat shard (scoring gathers through it), made
        again after an eviction."""
        if self._flat_x is None:
            self._flat_x = self._dataset.device_shard(
                self.config.feature_shard, self.device, self.dtype)
        return self._flat_x

    @property
    def proj_dev(self) -> Optional[torch.Tensor]:
        """Device copy of the per-entity projection, one per residency."""
        if self._proj_dev is None and self.red.projection is not None:
            self._proj_dev = torch.as_tensor(self.red.projection, device=self.device)
        return self._proj_dev

    # --- device residency ----------------------------------------------------
    def device_block_bytes(self) -> int:
        """Evictable device bytes: per-entity blocks + the flat shard view
        + the projection (a shard shared by two coordinates counts in both:
        an upper bound)."""
        total = self.red.device_bytes()
        if self._flat_x is not None:
            total += int(self._flat_x.nbytes)
        else:
            host_x = self._dataset.feature_shards[self.config.feature_shard]
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            total += int(host_x.shape[0]) * int(host_x.shape[1]) * itemsize
        if self.red.projection is not None:
            total += int(np.asarray(self.red.projection).nbytes)
        return total

    def streaming_buffer_bytes(self) -> int:
        return 0

    def evict_device_blocks(self) -> None:
        """Residency-manager hook: drop this coordinate's device blocks
        (per-entity buckets, flat shard view, projection; on a mesh its
        staged blocks); queued kernels keep their tensors alive, and the
        next visit copies them again from the host copies."""
        self.red.evict_device_blocks()
        self._flat_x = None
        self._proj_dev = None
        self._row_ids_dev = {}
        self._dataset.release_device_shard(self.config.feature_shard)
        if self.mesh is not None:
            invalidate(self._mesh_key())

    def _mesh_key(self):
        return (self.name, self._serial)

    def _mesh_offsets(self, row_ids: np.ndarray, flat_offsets: torch.Tensor,
                      key) -> torch.Tensor:
        """addScoresToOffsets for a block of lanes on a mesh: the [E, S]
        gather of the replicated flat offsets (padding cells 0); its row
        ids go to the device once per residency."""
        ids = self._row_ids_dev.get(key)
        if ids is None:
            ids = self._row_ids_dev[key] = torch.as_tensor(row_ids,
                                                           device=self.device)
        got = flat_offsets[torch.clamp(ids, min=0)]
        return torch.where(ids >= 0, got, torch.zeros_like(got)).to(self.dtype)

    def _mesh_blocks(self, host: EntityBlocks, row_ids, flat_offsets, key):
        """The whole block's host leaves with device offsets: the mesh
        layer stages this rank's lanes of it."""
        return EntityBlocks(x=host.x, labels=host.labels, mask=host.mask,
                            weights=host.weights,
                            offsets=self._mesh_offsets(row_ids, flat_offsets, key))

    def _score_model(self, model) -> torch.Tensor:
        """All rows (active and passive) scored against their entity's
        model by a static gather.  On a mesh each rank scores its row
        block and the [n] scores are assembled on every rank."""
        if self.mesh is None:
            return self._score_rows(model, self.flat_x, self.lanes)
        res = default_residency()
        host_x = self._dataset.feature_shards[self.config.feature_shard]
        x = res.stage_static(self._mesh_key(), "flat_x", self.mesh, host_x,
                             0.0, dtype=self.dtype)
        lanes = res.stage_static(self._mesh_key(), "lanes", self.mesh,
                                 self.host_lanes, -1)
        return self.mesh.assemble(self._score_rows(model, x, lanes),
                                  host_x.shape[0])

    def _score_rows(self, model, x, lanes) -> torch.Tensor:
        if isinstance(model, FactoredRandomEffectModel):
            return score_entities_matmul(model.latent_coefficients, model.projection,
                                         x, lanes)
        if model.projection_matrix is not None:
            return score_entities_matmul(model.coefficients, model.projection_matrix,
                                         x, lanes)
        if model.projection is not None:
            proj = (self.proj_dev if model.projection is self.red.projection
                    else torch.as_tensor(model.projection, device=self.device))
            return score_entities_scatter(model.coefficients, proj, x,
                                          lanes, global_dim=model.global_dim)
        return score_entities_plain(model.coefficients, x, lanes)


@dataclasses.dataclass
class BucketSolve:
    """One bucket's batched solve in an update: its [E, S, d], the largest
    and summed lane iteration counts, the batch's value+gradient rounds
    (and Hessian-vector rounds under TRON, else None), and its host wall
    time (ended by the solver's last readback)."""

    shape: Tuple[int, int, int]
    max_iterations: int
    total_iterations: int
    rounds: int
    seconds: float
    hv_rounds: Optional[int] = None


class RandomEffectCoordinate(_EntityCoordinateBase):
    """Per-entity GLMs over one feature shard (reference:
    RandomEffectCoordinate.scala + the projected-space wrapper)."""

    def initial_model(self) -> RandomEffectModel:
        E, dl = self.red.num_entities, self.red.local_dim
        return RandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task_type=self.task_type,
            coefficients=torch.zeros((E, dl), dtype=self.dtype, device=self.device),
            entity_ids=self.entity_id_values,
            projection=self.red.projection,
            global_dim=self.red.global_dim,
            projection_matrix=self.red.projection_matrix)

    def update(self, model: RandomEffectModel, offsets: torch.Tensor,
               schedule=None, outer_iteration: int = 0,
               num_outer_iterations: int = 1
               ) -> Tuple[RandomEffectModel, SolveResult]:
        """One gather + one batched solve per S-bucket; lanes are contiguous,
        so the results concatenate straight back into [E, d].  One
        `schedule`-derived budget is shared by every bucket.  The bucket
        solves of this update are in `self.last_buckets`."""
        opt = self.config.optimization
        budget = _budget(schedule, outer_iteration, num_outer_iterations,
                         opt.optimizer)
        lam = _in_dtype(opt.regularization_weight, self.dtype)
        results: List[SolveResult] = []
        self.last_buckets = []
        for bucket in self.red.buckets:
            t0 = clock()
            lo = bucket.lane_start
            if self.mesh is None:
                blocks = bucket.with_offsets_from_flat(offsets)
            else:
                blocks = self._mesh_blocks(bucket.host_blocks, bucket.row_ids,
                                           offsets, lo)
            res_b = fit_random_effects(
                blocks, self.loss, self.mesh,
                x0=model.coefficients[lo: lo + bucket.num_entities],
                config=opt.optimizer, reg=opt.regularization, reg_weight=lam,
                budget=budget, cache_key=(*self._mesh_key(), lo))
            its = res_b.iterations
            self.last_buckets.append(BucketSolve(
                tuple(blocks.x.shape), int(its.max()), int(its.sum()),
                res_b.rounds, clock() - t0, res_b.hv_rounds))
            results.append(res_b)
        res = SolveResult(**{
            f.name: (None if not isinstance(getattr(results[0], f.name), torch.Tensor)
                     else concat_rows_safe(self.mesh, [getattr(r, f.name)
                                                       for r in results]))
            for f in dataclasses.fields(SolveResult)})
        res.rounds = sum(r.rounds for r in results)
        if results[0].hv_rounds is not None:
            res.hv_rounds = sum(r.hv_rounds for r in results)
        return dataclasses.replace(model, coefficients=res.x), res

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        return self._score_model(model)

    def regularization_term(self, model: RandomEffectModel) -> torch.Tensor:
        """Sum over entities; a device scalar."""
        opt = self.config.optimization
        l1, l2 = opt.regularization.split(opt.regularization_weight)
        return _penalty(model.coefficients, l1, l2)


class FactoredRandomEffectCoordinate(_EntityCoordinateBase):
    """Matrix-factorized per-entity GLMs: latent factors per entity and a
    shared projection matrix, refit alternately over the random-effect
    dataset's single-S `blocks` view (reference:
    FactoredRandomEffectCoordinate.scala:40-281).

    `last_buckets` holds one BucketSolve per inner iteration of the last
    update (the latent-space batched solve over [E, S, k]);
    `warm_start_source` names the sibling coordinate whose solution
    seeded the projection, if one did."""

    def __init__(self, name: str, dataset: GameDataset,
                 config: FactoredRandomEffectCoordinateConfig, task_type: str,
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 7,
                 hbm_budget_bytes: Optional[int] = None, mesh=None):
        super().__init__(name, dataset, config, task_type, device, dtype, seed,
                         hbm_budget_bytes, mesh)
        self.seed = seed
        self._key = prng.PRNGKey(seed + 1)
        self.warm_start_source: Optional[str] = None

    def initial_model(self) -> FactoredRandomEffectModel:
        """Zero latent factors and a Gaussian random projection drawn in
        the compute dtype (reference: FactoredRandomEffectCoordinate
        .initializeModel, isKeepingInterceptTerm = false)."""
        E, k, d = self.red.num_entities, self.config.latent_dim, self.red.global_dim
        return FactoredRandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task_type=self.task_type,
            latent_coefficients=torch.zeros((E, k), dtype=self.dtype, device=self.device),
            projection=gaussian_projection_matrix(k, d, keep_intercept=False,
                                                  seed=self.seed, dtype=self.dtype,
                                                  device=self.device),
            entity_ids=self.entity_id_values,
            global_dim=d)

    def warm_start_latent(self, model: FactoredRandomEffectModel,
                          models) -> Optional[FactoredRandomEffectModel]:
        """The projection replaced by the top-k principal subspace of a
        sibling plain random effect's solution (same entity type, shard and
        global space), its rows aligned to this coordinate's lanes
        (entities the sibling never saw count as zero rows); the latent
        factors stay zero, so the coordinate's score is unchanged.  None
        when `models` holds no such sibling."""
        sibling = None
        for name, other in models.items():
            if (isinstance(other, RandomEffectModel)
                    and other.random_effect_type == self.config.random_effect_type
                    and other.feature_shard == self.config.feature_shard
                    and other.global_dim == self.red.global_dim):
                sibling = other
                self.warm_start_source = name
                break
        if sibling is None:
            return None
        w_global = sibling.global_coefficients()
        lookup = {v: i for i, v in enumerate(np.asarray(sibling.entity_ids).tolist())}
        rows = np.fromiter((lookup.get(v, -1) for v in self.entity_id_values.tolist()),
                           dtype=np.int64, count=len(self.entity_id_values))
        rows_dev = torch.as_tensor(rows, device=w_global.device)
        gathered = w_global[torch.clamp(rows_dev, min=0)]
        gathered = torch.where((rows_dev >= 0)[:, None], gathered,
                               torch.zeros_like(gathered))
        p = principal_subspace_projection(gathered.to(model.projection.dtype),
                                          model.projection)
        return dataclasses.replace(model, projection=p)

    def update(self, model: FactoredRandomEffectModel, offsets: torch.Tensor,
               schedule=None, outer_iteration: int = 0,
               num_outer_iterations: int = 1
               ) -> Tuple[FactoredRandomEffectModel, FactoredSolveResult]:
        opt, lat = self.config.optimization, self.config.latent_optimization
        # one schedule, two base configs: the latent-space and projection
        # solves each cap and loosen against their own configured budget
        re_budget = _budget(schedule, outer_iteration, num_outer_iterations,
                            opt.optimizer)
        latent_budget = _budget(schedule, outer_iteration, num_outer_iterations,
                                lat.optimizer)
        if self.mesh is None:
            blocks = self.red.with_offsets_from_flat(offsets)
        else:
            blocks = self._mesh_blocks(self._host_blocks(),
                                       self.red.active_row_ids, offsets, "all")

        latent_row_weights_fn = None
        if lat.downsampling_rate is not None:
            E, S = blocks.labels.shape
            flat_labels = torch.as_tensor(blocks.labels).to(
                device=self.device, dtype=self.dtype).reshape(E * S)
            sampler = downsampler_for_task(self.task_type)

            def latent_row_weights_fn(it: int):
                # a fresh draw per inner iteration (reference:
                # runWithSampling inside updateLatentProjectionMatrix)
                self._key, sub = prng.split(self._key)
                keep, w = sampler(sub, flat_labels, None, lat.downsampling_rate)
                return keep * w

        res = fit_factored_random_effects(
            blocks, self.loss, self.mesh,
            latent_coefficients=model.latent_coefficients,
            projection=model.projection,
            num_inner_iterations=self.config.num_inner_iterations,
            re_config=opt.optimizer, re_reg=opt.regularization,
            re_reg_weight=_in_dtype(opt.regularization_weight, self.dtype),
            latent_config=lat.optimizer, latent_reg=lat.regularization,
            latent_reg_weight=_in_dtype(lat.regularization_weight, self.dtype),
            latent_row_weights_fn=latent_row_weights_fn,
            re_budget=re_budget, latent_budget=latent_budget,
            cache_key=self._mesh_key())
        E, S, _ = blocks.x.shape
        self.last_buckets = [BucketSolve((E, S, self.config.latent_dim),
                                         r["re_max_iterations"], r["re_total_iterations"],
                                         r["re_rounds"], r["re_seconds"])
                             for r in res.inner]
        return dataclasses.replace(model, latent_coefficients=res.latent_coefficients,
                                   projection=res.projection), res

    def _host_blocks(self) -> EntityBlocks:
        """The single-S view of the host blocks (the layout of
        `red.blocks`), built once: the mesh stages each rank's lanes of
        it."""
        if self._host_single_s is None:
            S = self.red.max_samples

            def cat(get, fill):
                parts = [get(b.host_blocks) for b in self.red.buckets]
                if any(p is None for p in parts):
                    return None
                return np.concatenate([
                    np.pad(p, [(0, 0), (0, S - p.shape[1])]
                           + [(0, 0)] * (p.ndim - 2), constant_values=fill)
                    for p in parts])
            from photon_ml_tpu_torch.data.batching import _SAFE_LABEL
            self._host_single_s = EntityBlocks(
                x=cat(lambda b: b.x, 0.0),
                labels=cat(lambda b: b.labels, _SAFE_LABEL),
                mask=cat(lambda b: b.mask, 0.0),
                weights=cat(lambda b: b.weights, 0.0))
        return self._host_single_s

    def score(self, model: FactoredRandomEffectModel) -> torch.Tensor:
        """c_e . (P x) == (C @ P)[e] . x: one [E, k] x [k, d] product, then
        the same entity-gather scoring as a plain random effect."""
        return self._score_model(model)

    def regularization_term(self, model: FactoredRandomEffectModel) -> torch.Tensor:
        """The random-effect term over the latent factors plus the latent
        problem's term over P (reference: FactoredRandomEffectOptimization
        Problem.getRegularizationTermValue); a device scalar."""
        opt, lat = self.config.optimization, self.config.latent_optimization
        l1, l2 = opt.regularization.split(opt.regularization_weight)
        pl1, pl2 = lat.regularization.split(lat.regularization_weight)
        return (_penalty(model.latent_coefficients, l1, l2)
                + _penalty(model.projection, pl1, pl2))


Coordinate = FixedEffectCoordinate | RandomEffectCoordinate | FactoredRandomEffectCoordinate
