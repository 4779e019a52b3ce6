"""Feature normalization as margin-invariant algebra (port of
photon_ml_tpu/ops/normalization.py).

Normalized features x' = (x - shift) * factor are never materialized: every
aggregate works on raw X with effective coefficients e = c * factor and the
scalar margin shift -e.shift, so that x'.c == x.e - e.shift.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class NormalizationType(str, enum.Enum):
    NONE = "none"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    STANDARDIZATION = "standardization"


@dataclasses.dataclass
class NormalizationContext:
    """factors/shifts with the intercept pinned to (factor=1, shift=0).
    `factors is None` means no scaling, `shifts is None` no translation."""

    factors: Optional[torch.Tensor]
    shifts: Optional[torch.Tensor]
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, device=None, dtype=None) -> "NormalizationContext":
        move = (lambda a: None if a is None
                else a.to(device=device, dtype=dtype))
        return NormalizationContext(move(self.factors), move(self.shifts),
                                    self.intercept_index)

    def effective_coefficients(self, coefficients: torch.Tensor) -> torch.Tensor:
        """e = c * factor."""
        if self.factors is None:
            return coefficients
        return coefficients * self.factors

    def margin_shift(self, effective_coefficients: torch.Tensor) -> torch.Tensor:
        """-e.shift, the scalar added to every margin."""
        e = effective_coefficients
        if self.shifts is None:
            return torch.zeros((), dtype=e.dtype, device=e.device)
        return -torch.dot(e, self.shifts)

    def _intercept(self) -> int:
        if self.intercept_index is None:
            raise ValueError("shift normalization requires an intercept")
        return self.intercept_index

    def model_to_original_space(self, coefficients: torch.Tensor) -> torch.Tensor:
        """Map normalized-space coefficients to raw-feature space,
        preserving margins.  Returns a new tensor."""
        c = self.effective_coefficients(coefficients)
        if self.shifts is not None:
            i = self._intercept()
            c = c.clone()
            c[i] = c[i] - torch.dot(c, self.shifts)
        return c

    def model_to_transformed_space(self, coefficients: torch.Tensor) -> torch.Tensor:
        """Inverse of model_to_original_space (warm starts).  Returns a new
        tensor; the argument is never written."""
        c = coefficients
        if self.shifts is not None:
            i = self._intercept()
            c = c.clone()
            c[i] = c[i] + torch.dot(c, self.shifts)
        if self.factors is not None:
            c = c / self.factors
        return c


def no_normalization() -> NormalizationContext:
    return NormalizationContext(None, None, None)


def build_normalization_context(
    norm_type: NormalizationType | str,
    *,
    mean: Optional[torch.Tensor] = None,
    variance: Optional[torch.Tensor] = None,
    max_magnitude: Optional[torch.Tensor] = None,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """Factory from feature summary statistics.  Zero-variance and
    zero-magnitude features get factor 1; the intercept is pinned to
    factor 1, shift 0.  Statistics taken over a bf16 X in its own dtype
    are widened to float32 first (the promoted dtype of bf16 features and
    a float32 solve), so no factor or shift is rounded to bf16."""
    norm_type = NormalizationType(norm_type)
    if norm_type == NormalizationType.NONE:
        return no_normalization()
    widen = lambda a: (None if a is None
                       else a.to(torch.promote_types(a.dtype, torch.float32)))
    mean, variance, max_magnitude = widen(mean), widen(variance), widen(max_magnitude)

    def _pin_intercept(arr: torch.Tensor, value: float) -> torch.Tensor:
        if intercept_index is None:
            return arr
        arr = arr.clone()
        arr[intercept_index] = value
        return arr

    if norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        if max_magnitude is None:
            raise ValueError("max_magnitude summary required")
        one = torch.ones_like(max_magnitude)
        safe = torch.where(max_magnitude > 0, max_magnitude, one)
        return NormalizationContext(_pin_intercept(1.0 / safe, 1.0), None,
                                    intercept_index)

    if variance is None:
        raise ValueError("variance summary required")
    std = torch.sqrt(variance)
    one = torch.ones_like(std)
    factors = _pin_intercept(
        torch.where(std > 0, 1.0 / torch.where(std > 0, std, one), one), 1.0)

    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        return NormalizationContext(factors, None, intercept_index)

    if mean is None:
        raise ValueError("mean summary required")
    if intercept_index is None:
        raise ValueError(
            "STANDARDIZATION requires an intercept term to absorb the shift")
    shifts = _pin_intercept(mean, 0.0)
    return NormalizationContext(factors, shifts, intercept_index)
