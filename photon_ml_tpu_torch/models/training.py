"""Single-model GLM training: regularization sweep with warm start (port of
photon_ml_tpu/models/training.py).

Solves run strongest regularization first, each warm-started from the
previous solution; training runs in normalized space and models are mapped
back to the original space on the way out.  On the card every
value+gradient pass of LBFGS/OWLQN (and TRON) runs hand-written CUDA: the
fused kernel for a dense X (ops/hopper_kernels.py), kernels A and B for a
sparse one (ops/sparse_kernels.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_ml_tpu_torch.ops.features import as_feature_matrix, num_features
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, solve,
)
from photon_ml_tpu_torch.optim.types import SolveResult


@dataclasses.dataclass
class TrainedModel:
    """One sweep entry: (lambda, model in original space, solve result)."""

    reg_weight: float
    model: GeneralizedLinearModel
    result: SolveResult
    # host wall clock of the whole solve, ended by a device->host readback
    wall_s: float = 0.0


def _on(v, device, dtype):
    return None if v is None else torch.as_tensor(v).to(device=device, dtype=dtype)


def train_glm(
    x,
    labels,
    task_type: str,
    *,
    weights=None,
    offsets=None,
    optimizer_config: OptimizerConfig = OptimizerConfig(),
    regularization: RegularizationContext = RegularizationContext(),
    regularization_weights: Sequence[float] = (0.0,),
    normalization: Optional[NormalizationContext] = None,
    initial_model: Optional[GeneralizedLinearModel] = None,
    warm_start: bool = True,
    compute_variances: bool = False,
    device=None,
    index_map=None,
) -> List[TrainedModel]:
    """Train one GLM per regularization weight, strongest first with warm
    starts.  Returns models in ORIGINAL feature space.

    x may be a dense array or tensor, a scipy.sparse matrix, a sparse
    COO/CSR tensor (converted on its own device, ops/features.py) or a
    PaddedSparse; labels, weights and offsets arrays or tensors.  All are
    moved to `device` (None means cuda, which raises when CUDA is absent);
    a sparse x gets the column view its gradient needs (ops/features.py
    as_feature_matrix).  The computation runs in the labels' dtype (float32
    if they are not floating), and features are cast to it, except bf16
    features (a bf16 dense tensor, sparse tensor or PaddedSparse): they stay bf16, as the
    JAX package's train_glm leaves x as given, and every product promotes
    them exactly (the kernels read them as bf16).  Variances
    (`compute_variances`) come from the Hessian diagonal, sq_rmatvec on a
    sparse x.  The caller's `initial_model`
    is never written.  `index_map` resolves named feature constraints
    (optimizer_config.constraints) into positional bounds (reference:
    GLMSuite.createConstraintFeatureMap)."""
    if optimizer_config.constraints is not None:
        optimizer_config = optimizer_config.resolved_constraints(index_map)
    dev = resolve_device(device)
    loss = TASK_LOSSES[task_type]
    labels = torch.as_tensor(labels)
    dtype = labels.dtype if labels.is_floating_point() else torch.float32
    labels = labels.to(device=dev, dtype=dtype)
    x = as_feature_matrix(x, dev, dtype, with_csc=True)
    d = num_features(x)
    if normalization is not None:
        normalization = normalization.to(dev, dtype)

    objective = GLMObjective(loss, x, labels,
                             weights=_on(weights, dev, dtype),
                             offsets=_on(offsets, dev, dtype),
                             norm=normalization)

    if initial_model is not None:
        # .to() may hand back the caller's own tensor; the solvers never
        # write their start point, and model_to_transformed_space returns
        # a new tensor, so the caller's model stays as it was
        x0 = initial_model.coefficients.means.to(device=dev, dtype=dtype)
        if normalization is not None:
            x0 = normalization.model_to_transformed_space(x0)
    else:
        x0 = torch.zeros((d,), dtype=dtype, device=dev)

    out: List[TrainedModel] = []
    for lam in sorted(regularization_weights, reverse=True):
        lam_d = float(torch.tensor(float(lam), dtype=dtype))  # lambda in dtype
        t0 = time.perf_counter()
        res = solve(objective, x0, optimizer_config, regularization, lam_d)
        res.value.item()  # device->host readback: the solve has ended
        wall_s = time.perf_counter() - t0
        c_norm = res.x
        c_orig = (normalization.model_to_original_space(c_norm)
                  if normalization is not None else c_norm)
        if compute_variances:
            # variances in original space without normalization; the L2
            # part of this lambda adds to the Hessian diagonal
            _, l2_w = regularization.split(lam_d)
            hd = objective.replace(norm=None).with_l2(l2_w).hessian_diagonal(c_orig)
            coeffs = Coefficients.from_hessian_diagonal(c_orig, hd)
        else:
            coeffs = Coefficients(c_orig)
        out.append(TrainedModel(float(lam), model_for_task(task_type, coeffs),
                                res, wall_s=wall_s))
        if warm_start:
            x0 = c_norm
    return out


def best_model_by_validation(trained: Sequence[TrainedModel],
                             evaluate) -> TrainedModel:
    """The entry whose model scores highest under `evaluate` (model ->
    float, higher is better)."""
    scores = [evaluate(t.model) for t in trained]
    return trained[int(max(range(len(scores)), key=lambda i: scores[i]))]
