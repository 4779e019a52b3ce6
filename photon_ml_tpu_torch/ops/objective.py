"""The GLM objective: data + loss + L2 (port of photon_ml_tpu/ops/objective.py).

X is any feature matrix of ops/features.py: a dense tensor, a PaddedSparse
(whose gradient needs its column view on the card) or a sparse COO/CSR
tensor (its ELL form's kernels on the card).

L1 is absent by design: as in the reference, it is handled inside the OWLQN
optimizer through pseudo-gradients, not by the objective.

On a mesh each rank holds a row block of the data and `reduce` sums a
data term over the ranks (parallel/fixed_effect.py: one data-axis
all_reduce per pass, value and gradient packed into one vector); the L2
term is added once, after the sum, so it enters once and not per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.ops import aggregators as agg
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext


@dataclasses.dataclass
class GLMObjective:
    """Weighted GLM loss over a batch, with an optional L2 term.

    value(c)           = sum_i w_i l(z_i, y_i) + l2/2 ||c||^2
    value_and_gradient = one fused pass (the CUDA kernel on the card)
    hessian_vector(c, v), hessian_vector_at(c), hessian_diagonal(c)
    """

    loss: PointwiseLoss
    x: fops.FeatureMatrix
    labels: torch.Tensor
    weights: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    norm: Optional[NormalizationContext] = None
    l2_weight: Union[torch.Tensor, float] = 0.0
    # sums a rank's data term over the mesh's data axis (None: one device)
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    @property
    def dim(self) -> int:
        return fops.num_features(self.x)

    def _data(self) -> dict:
        return dict(weights=self.weights, offsets=self.offsets,
                    norm=self.norm, mask=self.mask)

    def _summed(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.reduce is None else self.reduce(t)

    def value(self, c: torch.Tensor) -> torch.Tensor:
        v = agg.value_only(self.loss, self.x, self.labels, c, **self._data())
        if self.reduce is not None:
            v = self.reduce(v.reshape(1))[0]
        return v + 0.5 * self.l2_weight * torch.dot(c, c)

    def value_and_gradient(self, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        v, g = agg.value_and_gradient(self.loss, self.x, self.labels, c,
                                      **self._data())
        if self.reduce is not None:
            vg = self.reduce(torch.cat([v.reshape(1), g]))
            v, g = vg[0], vg[1:]
        return v + 0.5 * self.l2_weight * torch.dot(c, c), g + self.l2_weight * c

    def hessian_vector(self, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.hessian_vector_at(c)(v)

    def hessian_vector_at(self, c: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        """v -> Hv at c; the margins at c are computed once, for every v
        (TRON's CG steps at one iterate)."""
        hv = agg.hessian_vector_at(self.loss, self.x, self.labels, c,
                                   **self._data())
        return lambda v: self._summed(hv(v)) + self.l2_weight * v

    def hessian_diagonal(self, c: torch.Tensor) -> torch.Tensor:
        """Original-space only: the aggregator has no normalization."""
        if self.norm is not None and not self.norm.is_identity:
            raise ValueError(
                "hessian_diagonal is original-space only; use "
                "objective.replace(norm=None) with original-space coefficients")
        hd = agg.hessian_diagonal(self.loss, self.x, self.labels, c,
                                  weights=self.weights, offsets=self.offsets,
                                  mask=self.mask)
        return self._summed(hd) + self.l2_weight

    def replace(self, **kw) -> "GLMObjective":
        return dataclasses.replace(self, **kw)

    def with_l2(self, l2_weight) -> "GLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)
