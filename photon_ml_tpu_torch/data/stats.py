"""Per-feature summary statistics (a numpy copy of photon_ml_tpu/data/stats.py).

reference: BasicStatisticalSummary (photon-lib/.../stat/
BasicStatisticalSummary.scala:36-117), which wraps spark-mllib colStats.
Used to build NormalizationContexts and for the feature-stats output file
(reference: cli/game/training/Driver.calculateAndSaveFeatureShardStats).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class BasicStatisticalSummary:
    mean: np.ndarray
    variance: np.ndarray
    count: int
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    mean_abs: np.ndarray

    @property
    def max_magnitude(self) -> np.ndarray:
        return np.maximum(np.abs(self.max), np.abs(self.min))

    @staticmethod
    def from_features(x: np.ndarray, weights: Optional[np.ndarray] = None
                      ) -> "BasicStatisticalSummary":
        x = np.asarray(x)
        n = x.shape[0]
        if weights is None:
            mean = x.mean(axis=0)
            var = x.var(axis=0, ddof=1) if n > 1 else np.zeros(x.shape[1])
        else:
            w = np.asarray(weights)[:, None]
            wsum = w.sum()
            mean = (x * w).sum(axis=0) / wsum
            var = ((x - mean) ** 2 * w).sum(axis=0) / max(wsum - 1.0, 1.0)
        return BasicStatisticalSummary(
            mean=mean, variance=var, count=n,
            num_nonzeros=(x != 0).sum(axis=0),
            max=x.max(axis=0), min=x.min(axis=0),
            norm_l1=np.abs(x).sum(axis=0),
            norm_l2=np.sqrt((x * x).sum(axis=0)),
            mean_abs=np.abs(x).mean(axis=0))

    @staticmethod
    def from_sparse(x, weights: Optional[np.ndarray] = None
                    ) -> "BasicStatisticalSummary":
        """CSR/CSC shard summary without densifying (the wide regime);
        weighted mean/variance match from_features' semantics exactly."""
        import scipy.sparse as sp
        csr = x.tocsr()
        n, d = csr.shape
        sq = csr.multiply(csr)
        if weights is None:
            mean = np.asarray(csr.mean(axis=0)).ravel()
            ex2 = np.asarray(sq.mean(axis=0)).ravel()
            var = (ex2 * n - n * mean ** 2) / max(n - 1, 1)
        else:
            w = np.asarray(weights, np.float64)
            wsum = float(w.sum())
            mean = np.asarray(w @ csr).ravel() / wsum
            # sum_i w_i (x_i - mean)^2 = sum w x^2 - 2 mean sum w x + mean^2 sum w
            wx2 = np.asarray(w @ sq).ravel()
            var = (wx2 - wsum * mean ** 2) / max(wsum - 1.0, 1.0)
        nnz = np.asarray((csr != 0).sum(axis=0)).ravel()
        mx = np.asarray(csr.max(axis=0).todense()).ravel()
        mn = np.asarray(csr.min(axis=0).todense()).ravel()
        absx = sp.csr_matrix((np.abs(csr.data), csr.indices, csr.indptr),
                             shape=csr.shape)
        l1 = np.asarray(absx.sum(axis=0)).ravel()
        return BasicStatisticalSummary(
            mean=mean, variance=np.maximum(var, 0.0), count=n,
            num_nonzeros=nnz, max=mx, min=mn, norm_l1=l1,
            norm_l2=np.sqrt(np.asarray(sq.sum(axis=0)).ravel()),
            mean_abs=l1 / max(n, 1))

    def to_dict(self) -> Dict[str, list]:
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in dataclasses.asdict(self).items()}
