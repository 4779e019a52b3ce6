"""Numerics helpers (port of photon_ml_tpu/utils/math.py).

dtype-polymorphic: every function inherits the dtype of its inputs, so the
same code runs float64 (CPU parity) and float32 (the card).
"""
from __future__ import annotations

import numpy as np
import torch

# reference: photon-lib/.../constants/MathConst.scala
EPSILON = 1e-12


def ceil_pow2(v):
    """Smallest power of two >= v (v >= 1), elementwise over arrays and
    exact for scalars."""
    if np.isscalar(v) or np.ndim(v) == 0:
        return 1 << max(int(v) - 1, 0).bit_length()
    return 1 << np.ceil(np.log2(np.maximum(v, 1))).astype(np.int64)


def log1p_exp(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(1 + exp(x)), as logaddexp(x, 0).

    Not F.softplus: its threshold=20 linearization differs from the
    reference's softplus by up to ~1e-9 just above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def safe_div(num: torch.Tensor, den: torch.Tensor,
             eps: float = EPSILON) -> torch.Tensor:
    """num/den with zero denominators mapped to zero output."""
    den_ok = torch.abs(den) > eps
    one = torch.ones((), dtype=den.dtype, device=den.device)
    return torch.where(den_ok, num / torch.where(den_ok, den, one),
                       torch.zeros_like(num))
