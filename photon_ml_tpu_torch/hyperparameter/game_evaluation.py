"""Bridge from the hyperparameter searchers to GameEstimator (port of
photon_ml_tpu/hyperparameter/game_evaluation.py).

Rebuild of photon-client/.../estimators/GameEstimatorEvaluationFunction.scala:
a parameter vector packs one regularization weight per coordinate (sorted
coordinate-name order for a stable layout, factored coordinates contribute
two entries: per-entity then latent — matching the reference's
configurationToVector), __call__ refits the estimator with those weights and
returns (first validation metric, GameResult).

`scale="log"` interprets the vector in log10 space (searchers walk a smooth
space; lambdas span decades) — the reference achieves the same by passing
log-scale ranges from the CLI.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectCoordinateConfig, GameTrainingConfig,
)
from photon_ml_tpu_torch.game.estimator import GameEstimator, GameResult
from photon_ml_tpu_torch.hyperparameter.search import EvaluationFunction


class GameEstimatorEvaluationFunction(EvaluationFunction[GameResult]):
    def __init__(
        self,
        estimator: GameEstimator,
        data: GameDataset,
        validation_data: GameDataset,
        evaluator_specs: Optional[Sequence[str]] = None,
        scale: str = "log",
        warm_start: bool = False,
        initial_model=None,
    ):
        if scale not in ("log", "linear"):
            raise ValueError(f"scale must be 'log' or 'linear', got {scale!r}")
        self.estimator = estimator
        self.data = data
        self.validation_data = validation_data
        self.evaluator_specs = evaluator_specs
        self.scale = scale
        # warm start: each tuning refit initializes from the best model seen
        # so far (reference: GameTrainingParams.useWarmStart);
        # `initial_model` (cross-job warm start) seeds refits when no better
        # observation exists yet, or every refit when warm_start is off
        self.warm_start = warm_start
        self.initial_model = initial_model
        self._best_result: Optional[GameResult] = None
        self._sweep = None  # built lazily on first evaluation
        # sorted for a consistent vector layout (reference uses SortedMap)
        self.coordinate_names = sorted(estimator.config.coordinates)

    @property
    def num_params(self) -> int:
        return len(self._config_to_vector(self.estimator.config))

    def _to_external(self, w: float) -> float:
        return float(np.log10(max(w, 1e-12))) if self.scale == "log" else float(w)

    def _to_weight(self, v: float) -> float:
        return float(10.0 ** v) if self.scale == "log" else float(v)

    def _config_to_vector(self, config: GameTrainingConfig) -> np.ndarray:
        vals: List[float] = []
        for name in self.coordinate_names:
            c = config.coordinates[name]
            vals.append(self._to_external(c.optimization.regularization_weight))
            if isinstance(c, FactoredRandomEffectCoordinateConfig):
                vals.append(self._to_external(
                    c.latent_optimization.regularization_weight))
        return np.asarray(vals, dtype=np.float64)

    def _vector_to_config(self, vector: np.ndarray) -> GameTrainingConfig:
        vector = np.asarray(vector, dtype=np.float64).reshape(-1)
        expected = self.num_params
        if len(vector) != expected:
            raise ValueError(
                f"parameter vector has {len(vector)} entries, expected {expected}")
        coords = dict(self.estimator.config.coordinates)
        i = 0
        for name in self.coordinate_names:
            c = coords[name]
            opt = dataclasses.replace(
                c.optimization, regularization_weight=self._to_weight(vector[i]))
            i += 1
            if isinstance(c, FactoredRandomEffectCoordinateConfig):
                lat = dataclasses.replace(
                    c.latent_optimization,
                    regularization_weight=self._to_weight(vector[i]))
                i += 1
                coords[name] = dataclasses.replace(
                    c, optimization=opt, latent_optimization=lat)
            else:
                coords[name] = dataclasses.replace(c, optimization=opt)
        return dataclasses.replace(self.estimator.config, coordinates=coords)

    @property
    def sweep(self):
        """The shared vectorized-sweep evaluator (hyperparameter/
        vectorized.py), built LAZILY and reused by every candidate: the
        GAME dataset/coordinate state — entity bucketing, normalization
        stats, device staging — is prepared once per search, not once per
        evaluation.  Candidate configs from `_vector_to_config` differ
        only in regularization weights, which are swapped into the
        prepared coordinates, so each Bayesian iteration costs a descent
        over data already on the device, not a cold fit."""
        if self._sweep is None:
            from photon_ml_tpu_torch.hyperparameter.vectorized import SweepEvaluator
            self._sweep = SweepEvaluator(self.estimator, self.data,
                                         self.validation_data,
                                         self.evaluator_specs)
        return self._sweep

    def __call__(self, candidate: np.ndarray) -> Tuple[float, GameResult]:
        config = self._vector_to_config(candidate)
        initial = (self._best_result.model
                   if self.warm_start and self._best_result is not None
                   else self.initial_model)
        if self.sweep.compatible(config):
            result = self.sweep.evaluate_config(config,
                                                initial_model=initial)
        else:
            # structural guard: a candidate that differs beyond
            # regularization weights (custom search subclasses) pays the
            # full rebuild the shared sweep state cannot serve
            result = GameEstimator(config, device=self.estimator.device,
                                   dtype=self.estimator.dtype,
                                   emitter=self.estimator.emitter).fit(
                self.data, self.validation_data, self.evaluator_specs,
                initial_model=initial)
        self.observe(result)
        return self.get_evaluation_value(result), result

    def evaluate_all(self, candidates: Sequence[np.ndarray]
                     ) -> List[GameResult]:
        """Batch lane: K candidate vectors as ONE vectorized sweep (vmap
        lane when shapes allow, warm-start regularization path otherwise —
        SweepEvaluator.evaluate picks).  Every result feeds the warm-start
        pool, matching K sequential __call__s."""
        configs = [self._vector_to_config(v) for v in candidates]
        initial = (self._best_result.model
                   if self.warm_start and self._best_result is not None
                   else self.initial_model)
        results = self.sweep.evaluate(configs, initial_model=initial)
        for r in results:
            self.observe(r)
        return results

    def observe(self, result: GameResult) -> None:
        """Feed a prior (e.g. grid) result into the warm-start pool."""
        if self._best_result is None or result.validation_specs[0].evaluator.better_than(
                self.get_evaluation_value(result),
                self.get_evaluation_value(self._best_result)):
            self._best_result = result

    def vectorize_params(self, observation: GameResult) -> np.ndarray:
        return self._config_to_vector(observation.config)

    def get_evaluation_value(self, observation: GameResult) -> float:
        """First validation evaluator = the model-selection metric
        (reference: 'Assumes model selection evaluator is in head position')."""
        if not observation.validation_specs or not observation.validation:
            raise ValueError("GameResult carries no validation evaluations")
        return observation.validation[observation.validation_specs[0].name]
