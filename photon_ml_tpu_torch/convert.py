"""Carry parameters across from the JAX package as numpy arrays.

The JAX package's models and normalization contexts hold jax arrays; pass
them through `np.asarray(...)` and these build the port's counterparts on
a device (None means cuda).  Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext


def _tensor(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def glm_from_numpy(task_type: str, means, variances=None,
                   device=None) -> GeneralizedLinearModel:
    """A model of `task_type` from coefficient means (and variances)."""
    dev = resolve_device(device)
    return model_for_task(task_type,
                          Coefficients(_tensor(means, dev), _tensor(variances, dev)))


def normalization_from_numpy(factors, shifts, intercept_index: Optional[int],
                             device=None) -> NormalizationContext:
    """A normalization context from factors/shifts (either may be None)."""
    dev = resolve_device(device)
    return NormalizationContext(_tensor(factors, dev), _tensor(shifts, dev),
                                intercept_index)
