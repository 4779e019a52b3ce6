"""Fixed-effect GLM training on one device (port of the single-device part
of photon_ml_tpu/parallel/fixed_effect.py).

The solve is optim/config.py::solve on an objective without a mask or
padding, so on the card every value+gradient pass of LBFGS/OWLQN is one
launch of the hand-written fused kernel for a dense X
(ops/hopper_kernels.py), or kernels A and B for a PaddedSparse
(ops/sparse_kernels.py), with the residual scores as its offsets.  Data parallelism over several cards and the
consensus-ADMM lane are ROADMAP.md queue A item 20: `mesh` must be None.
"""
from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, solve,
)
from photon_ml_tpu_torch.optim.types import SolveResult

_NO_MESH = ("fixed effects on a mesh are not ported yet (ROADMAP.md queue A "
            "item 20: multi-GPU training); pass mesh=None")


def fit_fixed_effect(
    objective: GLMObjective,
    x0: torch.Tensor,
    mesh=None,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
    budget=None,
) -> SolveResult:
    """One fixed-effect solve on the objective's device; `budget`
    (optim/schedule.py SolveBudget) caps it.  x0 is not written."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    return solve(objective, x0, config, reg, reg_weight, budget=budget)


def score_fixed_effect(model: GeneralizedLinearModel, x: fops.FeatureMatrix,
                       mesh=None, offsets: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Margins x.w (+ offsets)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    z = fops.matvec(x, model.coefficients.means)
    return z if offsets is None else z + offsets
