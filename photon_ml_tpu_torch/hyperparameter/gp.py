"""Gaussian-process regression with slice-sampled kernel hyper-posterior (a
copy of photon_ml_tpu/hyperparameter/gp.py).

Rebuild of photon-lib/.../hyperparameter/estimators/
{GaussianProcessEstimator,GaussianProcessModel}.scala and Linalg.scala:
  - fit: slice-sample log length-scales from the GP marginal likelihood
    (uniform prior, so likelihood ∝ posterior), burn-in then N samples, keep
    one kernel per sample and average predictions over them — the Monte Carlo
    marginalization the reference performs (GaussianProcessEstimator.scala:89-128)
  - predict: GPML Algorithm 2.1 via Cholesky (the reference calls LAPACK
    dpptrs directly, Linalg.scala:32-49; here numpy triangular solves)

Host-side float64 numpy throughout: the observation matrices are
(tuning-iterations x num-hyperparameters), i.e. tens of rows.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.hyperparameter.kernels import RBF, StationaryKernel
from photon_ml_tpu_torch.hyperparameter.slice_sampler import SliceSampler

# numerical jitter added to the kernel diagonal before factorization; the
# reference factors the exact kernel matrix and relies on observations being
# distinct — a deliberate robustness addition, not a behavior change
_JITTER = 1e-10


def cholesky_solve(l: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve A x = b given A = L L^T (reference: Linalg.choleskySolve via
    LAPACK dpptrs, Linalg.scala:24-49)."""
    z = np.linalg.solve(l, b)
    return np.linalg.solve(l.T, z)


class GaussianProcessModel:
    """Precomputed (L, alpha) per sampled kernel; predictions average over
    kernels (reference: GaussianProcessModel.scala:34-120)."""

    def __init__(
        self,
        x_train: np.ndarray,
        y_train: np.ndarray,
        y_mean: float,
        kernels: Sequence[StationaryKernel],
        prediction_transformation: Optional[Callable] = None,
    ):
        self.x_train = np.asarray(x_train, dtype=np.float64)
        self.y_train = np.asarray(y_train, dtype=np.float64)
        self.y_mean = float(y_mean)
        self.kernels = list(kernels)
        self.prediction_transformation = prediction_transformation
        self._pre: List[Tuple[StationaryKernel, np.ndarray, np.ndarray]] = []
        n = len(self.x_train)
        for kern in self.kernels:
            k = kern(self.x_train) + _JITTER * np.eye(n)
            l = np.linalg.cholesky(k)                      # GPML 2.1 line 2
            alpha = cholesky_solve(l, self.y_train)        # line 3
            self._pre.append((kern, l, alpha))

    def _predict_with_kernel(self, x, kern, l, alpha):
        ktrans = kern(self.x_train, x)                     # [n_train, m]
        y_pred = ktrans.T @ alpha                          # line 4
        v = np.linalg.solve(l, ktrans)                     # line 5
        # line 6, diagonal only: diag(k(x,x) - v^T v) without the m x m
        # candidate-covariance matrices (m = candidate pool, every iteration)
        y_var = kern.diag(x) - np.sum(v * v, axis=0)
        return y_pred + self.y_mean, y_var

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(means, variances), averaged over the sampled kernels."""
        x = np.asarray(x, dtype=np.float64)
        means, variances = zip(*(self._predict_with_kernel(x, k, l, a)
                                 for k, l, a in self._pre))
        return np.mean(means, axis=0), np.mean(variances, axis=0)

    def predict_transformed(self, x: np.ndarray) -> np.ndarray:
        """Per-kernel transformed predictions (e.g. acquisition values),
        averaged (reference: predictTransformed)."""
        x = np.asarray(x, dtype=np.float64)
        out = []
        for k, l, a in self._pre:
            means, variances = self._predict_with_kernel(x, k, l, a)
            out.append(self.prediction_transformation(means, variances)
                       if self.prediction_transformation else means)
        return np.mean(out, axis=0)


class GaussianProcessEstimator:
    """reference: GaussianProcessEstimator.scala:38-130."""

    def __init__(
        self,
        kernel: StationaryKernel = RBF(),
        normalize_labels: bool = False,
        prediction_transformation: Optional[Callable] = None,
        num_burn_in_samples: int = 100,
        num_samples: int = 100,
        seed: int = 0,
    ):
        self.kernel = kernel
        self.normalize_labels = normalize_labels
        self.prediction_transformation = prediction_transformation
        self.num_burn_in_samples = num_burn_in_samples
        self.num_samples = num_samples
        self.seed = seed

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2 or len(x) == 0 or len(x) != len(y):
            raise ValueError(f"bad GP training shapes {x.shape} / {y.shape}")
        y_mean = float(np.mean(y)) if self.normalize_labels else 0.0
        kernels = self._estimate_kernel_params(x, y - y_mean)
        return GaussianProcessModel(x, y - y_mean, y_mean, kernels,
                                    self.prediction_transformation)

    def _estimate_kernel_params(self, x, y) -> List[StationaryKernel]:
        """Slice-sample log length-scales from the marginal likelihood
        (uniform prior => likelihood ∝ posterior) and keep one kernel per
        sample: Monte Carlo marginalization over theta
        (reference: estimateKernelParams, scala:89-128)."""
        sampler = SliceSampler(lambda theta: self._log_likelihood(x, y, theta),
                               value_range=self.kernel.get_param_bounds(),
                               seed=self.seed)
        theta = self.kernel.expand_dimensions(self.kernel.get_params(), x.shape[1])
        for _ in range(self.num_burn_in_samples):
            theta = sampler.draw(theta)
        samples = []
        for _ in range(self.num_samples):
            theta = sampler.draw(theta)
            samples.append(theta)
        return [self.kernel.with_params(t) for t in samples]

    def _log_likelihood(self, x, y, theta) -> float:
        """GPML Algorithm 2.1 marginal likelihood; -inf on a non-PD kernel
        (the slice sampler then treats the point as outside the slice)."""
        kern = self.kernel.with_params(theta)
        k = kern(x) + _JITTER * np.eye(len(x))
        try:
            l = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return -math.inf
        alpha = cholesky_solve(l, y)
        return float(-0.5 * y @ alpha - np.sum(np.log(np.diag(l)))
                     - 0.5 * len(x) * math.log(2.0 * math.pi))
