"""Hyperparameter searchers: random and GP-guided Bayesian optimization (a
copy of photon_ml_tpu/hyperparameter/search.py over the port's
evaluators; the same seeds give the same candidate sequences).

Rebuild of photon-lib/.../hyperparameter/search/{RandomSearch,
GaussianProcessSearch}.scala, criteria/{ExpectedImprovement,ConfidenceBound}
.scala, and EvaluationFunction.scala.

Search protocol (identical to the reference's find/next/onObservation
template): draw candidates uniformly in the box; after enough observations
the GP searcher fits a Matern-5/2 GP (labels normalized, confidence-bound
acquisition with exploration derived from observation variance) and picks the
candidate with the best acquisition value, falling back to uniform draws
while the problem is underdetermined (GaussianProcessSearch.scala:76-110).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from photon_ml_tpu_torch.evaluation.evaluators import Evaluator
from photon_ml_tpu_torch.hyperparameter.gp import GaussianProcessEstimator, GaussianProcessModel
from photon_ml_tpu_torch.hyperparameter.kernels import Matern52

T = TypeVar("T")


class EvaluationFunction(Generic[T]):
    """What the searchers optimize (reference: EvaluationFunction.scala):
    __call__ evaluates a parameter vector to (value, payload); the vectorize/
    get-value pair lets prior observations re-enter a search."""

    def __call__(self, candidate: np.ndarray) -> Tuple[float, T]:
        raise NotImplementedError

    def vectorize_params(self, observation: T) -> np.ndarray:
        raise NotImplementedError

    def get_evaluation_value(self, observation: T) -> float:
        raise NotImplementedError


def _normal_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _normal_cdf(z: np.ndarray) -> np.ndarray:
    from math import erf
    return 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2.0)))


@dataclasses.dataclass
class ExpectedImprovement:
    """EI acquisition (reference: criteria/ExpectedImprovement.scala,
    "PBO" = Practical Bayesian Optimization, Snoek et al. Eq. 1-2)."""

    evaluator: Evaluator
    best_evaluation: float

    def __call__(self, means: np.ndarray, variances: np.ndarray) -> np.ndarray:
        std = np.sqrt(np.maximum(variances, 1e-18))
        direction = 1.0 if self.evaluator.better_than(1.0, -1.0) else -1.0
        gamma = (means - self.best_evaluation) / std * direction
        return std * (gamma * _normal_cdf(gamma) + _normal_pdf(gamma))


@dataclasses.dataclass
class ConfidenceBound:
    """UCB/LCB acquisition (reference: criteria/ConfidenceBound.scala):
    upper bound when larger is better, lower bound otherwise."""

    evaluator: Evaluator
    exploration_factor: float = 2.0

    def __call__(self, means: np.ndarray, variances: np.ndarray) -> np.ndarray:
        bound = self.exploration_factor * np.sqrt(np.maximum(variances, 0.0))
        return (means + bound if self.evaluator.better_than(1.0, -1.0)
                else means - bound)


class RandomSearch(Generic[T]):
    """Uniform search over a box (reference: RandomSearch.scala:30-125)."""

    def __init__(
        self,
        ranges: Sequence[Tuple[float, float]],
        evaluation_function: EvaluationFunction[T],
        seed: int = 0,
    ):
        if not ranges:
            raise ValueError("need at least one parameter range")
        self.ranges = [(float(lo), float(hi)) for lo, hi in ranges]
        self.num_params = len(self.ranges)
        self.evaluation_function = evaluation_function
        self.rng = np.random.default_rng(seed)

    def find(self, n: int, observations: Sequence[T] = ()) -> List[T]:
        """Evaluate n new points, optionally seeded with prior observations
        (reference: find(n, observations) at RandomSearch.scala:58-82)."""
        if n <= 0:
            raise ValueError("the number of results must be greater than zero")
        # all but the last prior observation enter the model now; the last is
        # recorded by the first next() call (reference: observations.init
        # foreach onObservation, last passed into the fold)
        converted = [(self.evaluation_function.vectorize_params(o),
                      self.evaluation_function.get_evaluation_value(o))
                     for o in observations]
        # drop priors outside the search box (e.g. a grid result with
        # regularization_weight=0 vectorizes to log10(1e-12) = -12, far
        # outside the default [-3,3] range and would skew the GP)
        kept = [(c, v) for c, v in converted if self._in_box(c)]
        if len(kept) < len(converted):
            logging.getLogger(__name__).warning(
                "dropped %d of %d prior observations outside the search box %s",
                len(converted) - len(kept), len(converted), self.ranges)
        converted = kept
        for cand, value in converted[:-1]:
            self._on_observation(cand, value)
        last: Optional[Tuple[np.ndarray, float]] = (
            converted[-1] if converted else None)

        results: List[T] = []
        for _ in range(n):
            if last is None:
                candidate = self.draw_candidates(1)[0]
            else:
                candidate = self.next(*last)
            value, payload = self.evaluation_function(candidate)
            results.append(payload)
            last = (np.asarray(candidate, dtype=np.float64), value)
        return results

    def _in_box(self, point: np.ndarray) -> bool:
        return all(lo <= v <= hi
                   for v, (lo, hi) in zip(np.ravel(point), self.ranges))

    # -- template methods (overridden by GaussianProcessSearch) ---------------
    def next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        self._on_observation(last_candidate, last_value)
        return self.draw_candidates(1)[0]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        pass

    def draw_candidates(self, n: int) -> np.ndarray:
        lo = np.asarray([r[0] for r in self.ranges])
        hi = np.asarray([r[1] for r in self.ranges])
        return lo + self.rng.random((n, self.num_params)) * (hi - lo)


class GaussianProcessSearch(RandomSearch[T]):
    """Bayesian optimization (reference: GaussianProcessSearch.scala:54-165):
    Matern-5/2 GP on observed (params -> value), confidence-bound acquisition
    with exploration 2*std(observations), best-of-candidate-pool selection;
    uniform fallback until #observations > #params."""

    def __init__(
        self,
        ranges: Sequence[Tuple[float, float]],
        evaluation_function: EvaluationFunction[T],
        evaluator: Evaluator,
        candidate_pool_size: int = 250,
        acquisition: str = "confidence_bound",
        seed: int = 0,
    ):
        if acquisition not in ("confidence_bound", "expected_improvement"):
            raise ValueError(f"unknown acquisition {acquisition!r}")
        super().__init__(ranges, evaluation_function, seed)
        self.evaluator = evaluator
        self.candidate_pool_size = candidate_pool_size
        self.acquisition = acquisition
        self._points: List[np.ndarray] = []
        self._values: List[float] = []
        self._best: Optional[float] = None
        self.last_model: Optional[GaussianProcessModel] = None

    def next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        self._on_observation(last_candidate, last_value)
        if len(self._points) <= self.num_params:
            # underdetermined: uniform fallback (scala:106-110)
            return self.draw_candidates(1)[0]
        points = np.stack(self._points)
        values = np.asarray(self._values)
        if self.acquisition == "expected_improvement":
            acquisition = ExpectedImprovement(self.evaluator, self._best)
        else:
            # exploration factor from observation variance (scala:92-95)
            obs_std = math.sqrt(max(1.0, float(np.var(values, ddof=1))
                                    if len(values) > 1 else 1.0))
            acquisition = ConfidenceBound(self.evaluator, 2.0 * obs_std)
        estimator = GaussianProcessEstimator(
            kernel=Matern52(), normalize_labels=True,
            prediction_transformation=acquisition, seed=int(self.rng.integers(2**31)))
        model = estimator.fit(points, values)
        self.last_model = model
        candidates = self.draw_candidates(self.candidate_pool_size)
        predictions = model.predict_transformed(candidates)
        if self.acquisition == "expected_improvement":
            # EI is an improvement magnitude: always maximized, whatever the
            # metric's own direction
            return candidates[int(np.argmax(predictions))]
        return self.select_best_candidate(candidates, predictions)

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        self._points.append(np.asarray(point, dtype=np.float64))
        self._values.append(float(value))
        if self._best is None or self.evaluator.better_than(value, self._best):
            self._best = value

    def select_best_candidate(self, candidates: np.ndarray,
                              predictions: np.ndarray) -> np.ndarray:
        """Best by the evaluator's own direction (scala:141-160)."""
        best = 0
        for i in range(1, len(candidates)):
            if self.evaluator.better_than(predictions[i], predictions[best]):
                best = i
        return candidates[best]
