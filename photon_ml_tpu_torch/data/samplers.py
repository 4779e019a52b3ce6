"""Down-samplers for fixed-effect updates (port of
photon_ml_tpu/data/samplers.py).

reference: photon-lib/.../sampler/{DownSampler,BinaryClassificationDownSampler,
DefaultDownSampler}.scala:33-69, applied per fixed-effect update.

Down-sampling moves no data: it is a 0/1 keep mask and rescaled weights.
The uniform draw is utils/prng.py's copy of JAX's threefry, made on the host
in the labels' dtype from a raw [2] uint32 key, so the same key keeps the
same rows as the JAX package does; mask and weights go to the labels'
device.  Kept negatives get weight / rate, so the gradient stays unbiased.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.utils import prng


def _draw(key: np.ndarray, labels: torch.Tensor, rate: float) -> torch.Tensor:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1), got {rate}")
    u = prng.uniform(key, tuple(labels.shape), labels.dtype)
    return torch.from_numpy(u).to(labels.device)


def binary_classification_downsample(
    key: np.ndarray,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep all positives; keep negatives with probability `rate`, at
    weight 1/rate.  Returns (mask, weights).  reference:
    BinaryClassificationDownSampler.scala:47-68."""
    u = _draw(key, labels, rate)
    w = torch.ones_like(labels) if weights is None else weights
    is_pos = labels > 0.5
    keep = is_pos | (u < rate)
    return keep.to(labels.dtype), torch.where(is_pos, w, w / rate)


def default_downsample(
    key: np.ndarray,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor],
    rate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform row sampling with a 1/rate weight rescale (regression
    tasks).  reference: DefaultDownSampler.scala."""
    u = _draw(key, labels, rate)
    w = torch.ones_like(labels) if weights is None else weights
    return (u < rate).to(labels.dtype), w / rate


def downsampler_for_task(task_type: str):
    """reference: the DownSampler factory of DistributedOptimizationProblem."""
    if task_type in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        return binary_classification_downsample
    return default_downsample
