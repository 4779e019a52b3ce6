"""Training coordinates: the per-block-update unit of GAME (port of
photon_ml_tpu/game/coordinates.py, resident and single-device).

A coordinate owns its device-resident training data and refits its model
given the current residual offsets; scores come back in the dataset's
canonical row order, so coordinate descent combines them with plain tensor
arithmetic.

Not ported yet, each raising NotImplementedError where it would take
effect: fixed-effect down-sampling (ROADMAP.md queue A item 8: it draws
from JAX's PRNG, which a port must reproduce first), `memory_mode=
"streamed"` and HBM budgets (item 15), `shard_features` and meshes
(item 20), and the factored random-effect coordinate (item 13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.batching import (
    RandomEffectDataset, build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.game.config import (
    FixedEffectCoordinateConfig, RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType, build_normalization_context,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.types import SolveResult
from photon_ml_tpu_torch.parallel.fixed_effect import fit_fixed_effect
from photon_ml_tpu_torch.parallel.random_effect import (
    fit_random_effects, score_entities_plain, score_entities_scatter,
)


def _penalty(c: torch.Tensor, l1: float, l2: float) -> torch.Tensor:
    """0.5*l2*||c||^2 + l1*||c||_1 (a device scalar)."""
    return 0.5 * l2 * torch.sum(c * c) + l1 * torch.sum(torch.abs(c))


def _in_dtype(w: float, dtype: torch.dtype) -> float:
    """A weight rounded to the solve's dtype, as the JAX package passes
    `jnp.asarray(weight, dtype)`."""
    return float(torch.tensor(float(w), dtype=dtype))


def _unported_schedule(name: str, config) -> None:
    if config.solver_schedule is not None:
        raise NotImplementedError(
            f"coordinate {name!r}: solver schedules are not ported yet "
            "(ROADMAP.md queue A item 16)")


class FixedEffectCoordinate:
    """Global GLM over one feature shard, dense or sparse (reference:
    FixedEffectCoordinate.scala).  Normalization is trained in and mapped
    out per update; a sparse shard takes none (ValueError, as the JAX
    package)."""

    def __init__(self, name: str, dataset: GameDataset,
                 config: FixedEffectCoordinateConfig, task_type: str,
                 device=None, dtype: torch.dtype = torch.float32):
        self.name = name
        self.config = config
        self.task_type = task_type
        self.loss = TASK_LOSSES[task_type]
        self.device = resolve_device(device)
        self.dtype = dtype
        _unported_schedule(name, config)
        if config.memory_mode == "streamed":
            raise NotImplementedError(
                f"coordinate {name!r}: memory_mode='streamed' is not ported "
                "yet (ROADMAP.md queue A item 15: out-of-core training)")
        if config.shard_features:
            raise NotImplementedError(
                f"coordinate {name!r}: shard_features is not ported yet "
                "(ROADMAP.md queue A item 20: multi-GPU training)")
        if config.optimization.downsampling_rate is not None:
            raise NotImplementedError(
                f"coordinate {name!r}: fixed-effect down-sampling is not "
                "ported yet (ROADMAP.md queue A item 8, data/samplers.py: its "
                "draw comes from JAX's PRNG)")
        host_x = dataset.feature_shards[config.feature_shard]
        self.dim = host_x.shape[1]
        sparse = not isinstance(host_x, np.ndarray)
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
        # a sparse shard becomes a PaddedSparse with the column view its
        # gradient needs (on a CUDA device always; on the CPU from
        # CSC_MIN_COLS columns up, as the JAX package's single-device solve)
        self.x = dataset.device_shard(config.feature_shard, self.device, dtype,
                                      with_csc=True)

    def initial_model(self) -> FixedEffectModel:
        """Zero coefficients (reference: Coordinate.initializeModel)."""
        return FixedEffectModel(
            model_for_task(self.task_type, Coefficients(
                torch.zeros(self.dim, dtype=self.dtype, device=self.device))),
            self.config.feature_shard)

    def update(self, model: FixedEffectModel, offsets: torch.Tensor
               ) -> Tuple[FixedEffectModel, SolveResult]:
        """Refit with residual offsets (partial scores + base offsets).
        reference: FixedEffectCoordinate.updateModel."""
        opt = self.config.optimization
        x0 = model.glm.coefficients.means
        if self.norm is not None:
            x0 = self.norm.model_to_transformed_space(x0)
        obj = GLMObjective(self.loss, self.x, self.labels, weights=self.weights,
                           offsets=offsets, norm=self.norm)
        res = fit_fixed_effect(obj, x0, None, opt.optimizer, opt.regularization,
                               _in_dtype(opt.regularization_weight, self.dtype))
        c = res.x
        if self.norm is not None:
            c = self.norm.model_to_original_space(c)
        return FixedEffectModel(model_for_task(self.task_type, Coefficients(c)),
                                self.config.feature_shard), res

    def score(self, model: FixedEffectModel) -> torch.Tensor:
        """Margin contribution on the training data, canonical order."""
        return fops.matvec(self.x, model.glm.coefficients.means)

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
    scoring."""

    def __init__(self, name: str, dataset: GameDataset,
                 config: RandomEffectCoordinateConfig, task_type: str,
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 7):
        self.name = name
        self.config = config
        self.task_type = task_type
        self.loss = TASK_LOSSES[task_type]
        self.device = resolve_device(device)
        self.dtype = dtype
        _unported_schedule(name, config)
        self.red: RandomEffectDataset = build_random_effect_dataset(
            dataset, config.data_config(seed), device=self.device,
            block_dtype=dtype)
        self.flat_x = dataset.device_shard(config.feature_shard, self.device, dtype)
        self.lanes = torch.as_tensor(self.red.flat_entity_lanes(
            dataset.entity_indices[config.random_effect_type]), device=self.device)
        self.proj_dev = (None if self.red.projection is None
                         else torch.as_tensor(self.red.projection, device=self.device))
        self.entity_id_values = np.asarray(
            dataset.entity_vocabs[config.random_effect_type])[self.red.entity_ids]
        self.last_buckets: List[BucketSolve] = []

    def _score_model(self, model: RandomEffectModel) -> torch.Tensor:
        """All rows (active and passive) scored against their entity's
        model by a static gather."""
        if model.projection is not None:
            proj = (self.proj_dev if model.projection is self.red.projection
                    else torch.as_tensor(model.projection, device=self.device))
            return score_entities_scatter(model.coefficients, proj, self.flat_x,
                                          self.lanes, global_dim=model.global_dim)
        return score_entities_plain(model.coefficients, self.flat_x, self.lanes)


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
            global_dim=self.red.global_dim)

    def update(self, model: RandomEffectModel, offsets: torch.Tensor
               ) -> Tuple[RandomEffectModel, SolveResult]:
        """One gather + one batched solve per S-bucket; lanes are contiguous,
        so the results concatenate straight back into [E, d].  The bucket
        solves of this update are in `self.last_buckets`."""
        opt = self.config.optimization
        lam = _in_dtype(opt.regularization_weight, self.dtype)
        results: List[SolveResult] = []
        self.last_buckets = []
        for bucket in self.red.buckets:
            t0 = time.perf_counter()
            blocks = bucket.with_offsets_from_flat(offsets)
            lo = bucket.lane_start
            res_b = fit_random_effects(
                blocks, self.loss, None,
                x0=model.coefficients[lo: lo + bucket.num_entities],
                config=opt.optimizer, reg=opt.regularization, reg_weight=lam)
            its = res_b.iterations
            self.last_buckets.append(BucketSolve(
                tuple(blocks.x.shape), int(its.max()), int(its.sum()),
                res_b.rounds, time.perf_counter() - t0, res_b.hv_rounds))
            results.append(res_b)
        res = SolveResult(**{
            f.name: (None if not isinstance(getattr(results[0], f.name), torch.Tensor)
                     else torch.cat([getattr(r, f.name) for r in results]))
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


Coordinate = FixedEffectCoordinate | RandomEffectCoordinate
