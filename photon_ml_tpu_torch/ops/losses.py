"""Pointwise GLM losses (port of photon_ml_tpu/ops/losses.py).

Each loss is a frozen singleton of tensor functions of the margin z and the
label y: loss, dl/dz, d2l/dz2 and the inverse link `mean`.  Classification
labels are {0, 1} at the surface and remapped to ±1 inside.  `kernel_id`
selects the loss inside the CUDA kernels (csrc/fused_value_and_gradient.cu
and csrc/ell_sparse.cu, `enum Loss`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.utils.math import log1p_exp

Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class PointwiseLoss:
    """A pointwise loss l(z, y) with first/second derivatives in z.

    `twice_differentiable` gates TRON eligibility; `d2z_bound` is a global
    upper bound on d2z where one exists (None for Poisson)."""

    name: str
    kernel_id: int
    loss: Fn
    dz: Fn
    d2z: Fn
    mean: Callable[[torch.Tensor], torch.Tensor]
    twice_differentiable: bool = True
    d2z_bound: Optional[float] = 1.0

    def loss_and_dz(self, z: torch.Tensor,
                    y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.loss(z, y), self.dz(z, y)

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, PointwiseLoss) and other.name == self.name


def _pm1(y: torch.Tensor) -> torch.Tensor:
    """{0,1} (or already ±1) labels -> ±1, as the reference remaps."""
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(y > 0.5, one, -one)


# --- logistic: l = log1pExp(-yy*z), yy = ±1 ---------------------------------
def _logistic_loss(z, y):
    return log1p_exp(-_pm1(y) * z)


def _logistic_dz(z, y):
    yy = _pm1(y)
    return -yy * torch.sigmoid(-yy * z)


def _logistic_d2z(z, y):
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LOGISTIC = PointwiseLoss(
    name="logistic", kernel_id=0,
    loss=_logistic_loss, dz=_logistic_dz, d2z=_logistic_d2z,
    mean=torch.sigmoid,
    d2z_bound=0.25,  # s(1-s) <= 1/4
)


# --- squared: l = 0.5 (z - y)^2 ---------------------------------------------
SQUARED = PointwiseLoss(
    name="squared", kernel_id=1,
    loss=lambda z, y: 0.5 * (z - y) ** 2,
    dz=lambda z, y: z - y,
    d2z=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
)


# --- poisson: l = exp(z) - y z ----------------------------------------------
POISSON = PointwiseLoss(
    name="poisson", kernel_id=2,
    loss=lambda z, y: torch.exp(z) - y * z,
    dz=lambda z, y: torch.exp(z) - y,
    d2z=lambda z, y: torch.exp(z),
    mean=torch.exp,
    d2z_bound=None,  # e^z is unbounded
)


# --- smoothed hinge (Rennie): piecewise in t = yy*z -------------------------
def _where3(c1, a, c2, b, z):
    """where(c1, a, where(c2, b, 0)) with the branches broadcast to z."""
    zero = torch.zeros_like(z)
    return torch.where(c1, a, torch.where(c2, b, zero))


def _shinge_loss(z, y):
    t = _pm1(y) * z
    return _where3(t < 0.0, 0.5 - t, t < 1.0, 0.5 * (1.0 - t) ** 2, z)


def _shinge_dz(z, y):
    yy = _pm1(y)
    t = yy * z
    return yy * _where3(t < 0.0, -torch.ones_like(t), t < 1.0, t - 1.0, z)


def _shinge_d2z(z, y):
    t = _pm1(y) * z
    return ((t >= 0.0) & (t < 1.0)).to(z.dtype)


SMOOTHED_HINGE = PointwiseLoss(
    name="smoothed_hinge", kernel_id=3,
    loss=_shinge_loss, dz=_shinge_dz, d2z=_shinge_d2z,
    mean=lambda z: z,  # raw-margin classifier
    twice_differentiable=False,
)


BY_NAME = {
    l.name: l for l in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)
}

TASK_LOSSES = {
    "logistic_regression": LOGISTIC,
    "linear_regression": SQUARED,
    "poisson_regression": POISSON,
    "smoothed_hinge_loss_linear_svm": SMOOTHED_HINGE,
}
