"""Stationary covariance kernels for GP-based hyperparameter search (a copy
of photon_ml_tpu/hyperparameter/kernels.py: host float64 numpy, so the
port's kernel matrices are the JAX package's bit for bit).

Rebuild of photon-lib/.../hyperparameter/estimators/kernels/
{Kernel,StationaryKernel,RBF,Matern52}.scala.  The reference computes
pairwise squared distances with a double Scala loop (StationaryKernel.scala
pairwiseDistances); here it is one broadcastized numpy expression.  These
matrices are tiny (observations = tuning iterations, tens of rows), so this
module is deliberately host-side float64 numpy — the reference likewise runs
the GP machinery driver-local (SURVEY §3.5).

Parameters are log(length_scale) per dimension with bounds
(log 1e-5, log 1e5), exactly the reference's getParams/getParamBounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_DEFAULT_BOUNDS = (1e-5, 1e5)


def _pairwise_sq_dists(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """[m, p] matrix of squared euclidean distances."""
    d = x1[:, None, :] - x2[None, :, :]
    return np.sum(d * d, axis=-1)


@dataclasses.dataclass(frozen=True)
class StationaryKernel:
    """k(x1, x2) = f(||x1/ls - x2/ls||^2) with per-dim length scales.

    reference: StationaryKernel.scala:25-140."""

    length_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1))
    length_scale_bounds: Tuple[float, float] = _DEFAULT_BOUNDS

    def _from_sq_dists(self, dists: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _expand(self, dim: int) -> np.ndarray:
        ls = np.asarray(self.length_scale, dtype=np.float64).reshape(-1)
        if len(ls) == dim:
            return ls
        if len(ls) == 1:
            return np.full(dim, ls[0])
        raise ValueError(f"length_scale has {len(ls)} dims, data has {dim}")

    def __call__(self, x1: np.ndarray, x2: Optional[np.ndarray] = None) -> np.ndarray:
        x1 = np.asarray(x1, dtype=np.float64)
        x2 = x1 if x2 is None else np.asarray(x2, dtype=np.float64)
        ls = self._expand(x1.shape[1])
        return self._from_sq_dists(_pairwise_sq_dists(x1 / ls, x2 / ls))

    def diag(self, x: np.ndarray) -> np.ndarray:
        """diag(k(x, x)) without the m x m matrix (stationary: k(0) per row)."""
        k0 = float(self._from_sq_dists(np.zeros(1))[0])
        return np.full(len(x), k0)

    # -- parameter vector surface (what the slice sampler walks) -------------
    def get_params(self) -> np.ndarray:
        """log length scales (reference: StationaryKernel.getParams)."""
        return np.log(np.asarray(self.length_scale, dtype=np.float64).reshape(-1))

    def get_param_bounds(self) -> Tuple[float, float]:
        lo, hi = self.length_scale_bounds
        return (np.log(lo), np.log(hi))

    def with_params(self, theta: np.ndarray) -> "StationaryKernel":
        """theta = log length scales -> new kernel (reference: withParams)."""
        return dataclasses.replace(self, length_scale=np.exp(np.asarray(theta)))

    def expand_dimensions(self, theta: np.ndarray, dim: int) -> np.ndarray:
        theta = np.asarray(theta, dtype=np.float64).reshape(-1)
        if len(theta) == dim:
            return theta
        return np.full(dim, theta[0])


@dataclasses.dataclass(frozen=True)
class RBF(StationaryKernel):
    """k = exp(-d^2/2) (reference: RBF.scala)."""

    def _from_sq_dists(self, dists: np.ndarray) -> np.ndarray:
        return np.exp(-0.5 * dists)


@dataclasses.dataclass(frozen=True)
class Matern52(StationaryKernel):
    """k = (1 + sqrt(5)d + 5d^2/3) exp(-sqrt(5)d) (reference: Matern52.scala
    — best performer for hyperparameter spaces per the reference's comment in
    GaussianProcessSearch.scala)."""

    def _from_sq_dists(self, dists: np.ndarray) -> np.ndarray:
        f = np.sqrt(5.0 * dists)
        return (1.0 + f + 5.0 * dists / 3.0) * np.exp(-f)
