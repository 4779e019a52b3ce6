"""Loss / gradient / Hessian aggregates over a feature matrix (port of
photon_ml_tpu/ops/aggregators.py).

Normalization is algebraic, never materialized:
  effective coef e = c*factor;  margin z_i = x_i.e - e.shift + offset_i
  grad = (X^T(w*l') - shift * sum(w*l')) * factor
  Hv   = (X^T(w*l''*dz) - shift * sum(w*l''*dz)) * factor,
         dz_i = x_i.(v*factor) - (v*factor).shift

`value_and_gradient` on a CUDA feature matrix runs a hand-written pass
with factors folded in as e = c*factor and grad*factor: the fused kernel
for a dense X (ops/hopper_kernels.py, one launch, row mask and
normalization shift included), kernels A then B for a PaddedSparse
(ops/sparse_kernels.py, two launches) without a mask or a shift.  A masked
or shifted PaddedSparse objective (kernels A and B take neither yet), and
every `KroneckerDesign` (the latent refit's implicit design: two matrix
products, as the JAX package computes it outside its Pallas kernel), take
the algebra below, whose products on a CUDA PaddedSparse are kernels A and
B too: a dispatch on the kind of input, not a fallback on failure.
A sparse COO/CSR tensor (ops/features.py, the port's BCOO) takes its
ELL form's kernels on the card and torch's sparse products on the CPU.
Weights/offsets may be None (1 / 0).

A bf16 X (dense, or a PaddedSparse's values) reaches the kernels as bf16;
the coefficients, labels, weights, offsets and normalization stay in the
labels' dtype.  The torch algebra (masked or shifted sparse passes, the
Hessian-vector product, the Hessian diagonal, value_only) promotes X in
ops/features.py's products, as the JAX package's jnp promotion does:
nothing rounds a coefficient, a margin or a gradient to bf16.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops import hopper_kernels
from photon_ml_tpu_torch.ops import sparse_kernels
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext


def _normalized(norm: Optional[NormalizationContext]) -> bool:
    return norm is not None and not norm.is_identity


def compute_margins(
    x: fops.FeatureMatrix,
    coefficients: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
    norm: Optional[NormalizationContext] = None,
) -> torch.Tensor:
    """z_i = x_i . (c*factor) - (c*factor).shift + offset_i."""
    if _normalized(norm):
        e = norm.effective_coefficients(coefficients)
        z = fops.matvec(x, e) + norm.margin_shift(e)
    else:
        z = fops.matvec(x, coefficients)
    if offsets is not None:
        z = z + offsets
    return z


def _apply_weights(v: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    return v if weights is None else v * weights


def _masked(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    # where() not multiply: a non-finite loss on a padded row must not
    # poison the aggregate (inf * 0 == nan)
    if mask is None:
        return v
    return torch.where(mask != 0, v, torch.zeros_like(v))


def value_and_gradient(
    loss: PointwiseLoss,
    x: fops.FeatureMatrix,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    norm: Optional[NormalizationContext] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_i w_i l(z_i, y_i),  d/dc of it).  `mask` (0/1 per row) drops
    padded rows."""
    if fops.is_sparse(x) and x.is_cuda:
        x = fops.ell_form(x)
    shifts = None if norm is None else norm.shifts
    sparse = isinstance(x, fops.PaddedSparse)
    if (x.is_cuda and not isinstance(x, fops.KroneckerDesign)
            and not (sparse and (mask is not None or shifts is not None))):
        factors = None if norm is None else norm.factors
        e = coefficients if factors is None else coefficients * factors
        if sparse:
            value, u = sparse_kernels.ell_margin_loss(
                loss, x.indices, x.values, e, labels, weights, offsets)
            grad = fops.rmatvec(x, u)
        else:
            value, grad = hopper_kernels.fused_value_and_gradient(
                loss, x, labels, e, weights, offsets, mask, shifts)
        return value, (grad if factors is None else grad * factors)

    z = compute_margins(x, coefficients, offsets, norm)
    l, dl = loss.loss_and_dz(z, labels)
    wdl = _masked(_apply_weights(dl, weights), mask)
    wl = _masked(_apply_weights(l, weights), mask)
    value = torch.sum(wl)
    grad = fops.rmatvec(x, wdl)
    if _normalized(norm):
        if norm.shifts is not None:
            grad = grad - norm.shifts * torch.sum(wdl)
        if norm.factors is not None:
            grad = grad * norm.factors
    return value, grad


def value_only(
    loss: PointwiseLoss,
    x: fops.FeatureMatrix,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    norm: Optional[NormalizationContext] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """sum_i w_i l(z_i, y_i)."""
    z = compute_margins(x, coefficients, offsets, norm)
    wl = _masked(_apply_weights(loss.loss(z, labels), weights), mask)
    return torch.sum(wl)


def hessian_vector_at(
    loss: PointwiseLoss,
    x: fops.FeatureMatrix,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    norm: Optional[NormalizationContext] = None,
    mask: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> Hv at `coefficients`: the margins and l'' are computed here,
    once, and each product is two passes over x (x.v and x^T(.))."""
    z = compute_margins(x, coefficients, offsets, norm)
    d2 = loss.d2z(z, labels)

    def hv(vector: torch.Tensor) -> torch.Tensor:
        if _normalized(norm):
            ev = norm.effective_coefficients(vector)
            dz = fops.matvec(x, ev) + norm.margin_shift(ev)
        else:
            dz = fops.matvec(x, vector)
        wd2dz = _masked(_apply_weights(d2 * dz, weights), mask)
        out = fops.rmatvec(x, wd2dz)
        if _normalized(norm):
            if norm.shifts is not None:
                out = out - norm.shifts * torch.sum(wd2dz)
            if norm.factors is not None:
                out = out * norm.factors
        return out

    return hv


def hessian_vector(
    loss: PointwiseLoss,
    x: fops.FeatureMatrix,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    vector: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    norm: Optional[NormalizationContext] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hv = sum_i w_i l''(z_i, y_i) (x'_i . v) x'_i in normalized space."""
    return hessian_vector_at(loss, x, labels, coefficients, weights=weights,
                             offsets=offsets, norm=norm, mask=mask)(vector)


def hessian_diagonal(
    loss: PointwiseLoss,
    x: fops.FeatureMatrix,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """diag(H) = sum_i w_i l'' x_i**2, in original space only (no
    normalization), for coefficient variances."""
    z = compute_margins(x, coefficients, offsets, None)
    wd2 = _masked(_apply_weights(loss.d2z(z, labels), weights), mask)
    return fops.sq_rmatvec(x, wd2)
