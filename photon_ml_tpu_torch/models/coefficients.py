"""Model coefficients, means and optional variances (port of
photon_ml_tpu/models/coefficients.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.utils.math import EPSILON


@dataclasses.dataclass
class Coefficients:
    means: torch.Tensor
    variances: Optional[torch.Tensor] = None

    def compute_score(self, x: torch.Tensor) -> torch.Tensor:
        """x may be one row [d] or a feature matrix [n, d] (dense, a
        PaddedSparse or a sparse COO/CSR tensor)."""
        if x.ndim == 1:
            return torch.dot(x, self.means)
        from photon_ml_tpu_torch.ops import features as fops
        return fops.matvec(x, self.means)

    @staticmethod
    def from_hessian_diagonal(means: torch.Tensor,
                              hess_diag: torch.Tensor) -> "Coefficients":
        """var_j ~= 1 / (H_jj + eps)."""
        return Coefficients(means, 1.0 / (hess_diag + EPSILON))
