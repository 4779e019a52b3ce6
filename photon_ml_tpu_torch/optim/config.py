"""Optimizer + regularization configuration and the solve dispatcher (port
of photon_ml_tpu/optim/config.py).

LBFGS/OWLQN (with positional box bounds) and TRON.  Named feature
constraints (the reference's JSON constraint maps) resolve through a
feature shard's IndexMap into the positional box (`resolved_constraints`,
optim/constraints.py).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.lbfgs import lbfgs
from photon_ml_tpu_torch.optim.tron import tron
from photon_ml_tpu_torch.optim.types import SolveResult


class OptimizerType(str, enum.Enum):
    LBFGS = "lbfgs"
    TRON = "tron"


class RegularizationType(str, enum.Enum):
    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits a total weight lambda into L1 = alpha*lambda and
    L2 = (1-alpha)*lambda."""

    reg_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: Optional[float] = None

    def __post_init__(self):
        if self.reg_type == RegularizationType.ELASTIC_NET:
            a = self.elastic_net_alpha
            if a is None or not (0.0 <= a <= 1.0):
                raise ValueError(f"elastic_net_alpha must be in [0,1], got {a}")
        elif self.elastic_net_alpha is not None:
            raise ValueError("elastic_net_alpha only valid for ELASTIC_NET")

    def split(self, reg_weight) -> Tuple[float, float]:
        """-> (l1_weight, l2_weight)."""
        w = reg_weight
        if self.reg_type == RegularizationType.NONE:
            return 0.0 * w, 0.0 * w
        if self.reg_type == RegularizationType.L1:
            return w, 0.0 * w
        if self.reg_type == RegularizationType.L2:
            return 0.0 * w, w
        a = self.elastic_net_alpha
        return a * w, (1.0 - a) * w

    @property
    def has_l1(self) -> bool:
        return self.reg_type in (RegularizationType.L1, RegularizationType.ELASTIC_NET) and \
            (self.reg_type != RegularizationType.ELASTIC_NET or self.elastic_net_alpha > 0)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """(type, max iterations, tolerance, box bounds); `None` means the
    optimizer's default."""

    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iterations: Optional[int] = None
    tolerance: Optional[float] = None
    history: int = 10                     # LBFGS memory
    max_cg_iterations: int = 20           # TRON inner CG cap
    # per-coordinate bounds, stored as tuples so the config stays hashable
    box_lower: Optional[tuple] = None
    box_upper: Optional[tuple] = None
    # NAMED-feature constraints in the reference's JSON shape
    # ([{name, term, lowerBound, upperBound}], GLMSuite.scala:206-280);
    # resolved against the shard's IndexMap into box_lower/box_upper at fit
    # time (resolved_constraints()).  Exclusive with positional bounds.
    constraints: Optional[tuple] = None
    # per-iteration coefficient snapshots in SolveResult.coefficient_history
    track_coefficients: bool = False

    def __post_init__(self):
        for name in ("box_lower", "box_upper"):
            v = getattr(self, name)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, name,
                                   tuple(float(e) for e in np.asarray(v)))
        if self.constraints is not None:
            from photon_ml_tpu_torch.optim.constraints import normalize_constraints
            if self.box_lower is not None or self.box_upper is not None:
                raise ValueError(
                    "named constraints and positional box_lower/box_upper "
                    "are exclusive — the constraints RESOLVE to the "
                    "positional bounds")
            object.__setattr__(self, "constraints",
                               normalize_constraints(self.constraints))

    def resolved_constraints(self, index_map) -> "OptimizerConfig":
        """Named constraints -> positional bounds via the feature shard's
        IndexMap (reference: GLMSuite.createConstraintFeatureMap)."""
        if self.constraints is None:
            return self
        from photon_ml_tpu_torch.optim.constraints import resolve_constraints
        if index_map is None:
            raise ValueError(
                "named feature constraints require the dataset to carry an "
                "index map for the coordinate's feature shard (train from "
                "Avro/LIBSVM-with-maps or an npz GameDataset saved with "
                "index maps)")
        lower, upper = resolve_constraints(self.constraints, index_map)
        return dataclasses.replace(self, constraints=None,
                                   box_lower=lower, box_upper=upper)

    def resolved(self) -> "OptimizerConfig":
        # explicit 0 / 0.0 are legitimate; only None takes the default
        d_iter, d_tol = ((15, 1e-5) if self.optimizer == OptimizerType.TRON
                         else (100, 1e-7))
        return dataclasses.replace(
            self,
            max_iterations=self.max_iterations if self.max_iterations is not None else d_iter,
            tolerance=self.tolerance if self.tolerance is not None else d_tol)


def box_bounds(cfg: OptimizerConfig, like: torch.Tensor):
    """(lower, upper) as tensors of `like`'s dtype and device, or None."""
    as_t = lambda b: (None if b is None
                      else torch.tensor(b, dtype=like.dtype, device=like.device))
    return as_t(cfg.box_lower), as_t(cfg.box_upper)


def check_tron(cfg: OptimizerConfig, reg: RegularizationContext, loss) -> None:
    """The JAX package's rules for TRON: L2 or no regularization, a twice
    differentiable loss, no box."""
    if reg.has_l1:
        raise ValueError("TRON supports only L2/none regularization "
                         "(reference: OptimizerFactory constraint)")
    if not loss.twice_differentiable:
        raise ValueError(f"{loss.name} is not twice differentiable; "
                         "use LBFGS (reference: SmoothedHingeLossFunction)")
    if cfg.box_lower is not None or cfg.box_upper is not None:
        raise ValueError("box constraints are an LBFGS feature "
                         "(reference: LBFGS.scala:72)")


def solve(
    objective: GLMObjective,
    x0: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight=0.0,
    budget=None,
) -> SolveResult:
    """Run one GLM solve: L2 goes into the smooth objective, L1 to OWLQN's
    pseudo-gradient machinery; TRON takes L2 or none.  x0 is not written.

    `budget` (optim/schedule.py SolveBudget) caps the iterations and sets
    the tolerance, rounded to x0's dtype; the config's max_iterations
    still sizes the histories.

    `reg_weight` may be an optim/schedule.py RegWeights: both penalty
    weights are then taken as given instead of splitting a total weight
    with `reg.split` (a sweep varies lambda and the elastic-net mix this
    way).  `reg.has_l1` stays the structural flag: it decides whether
    OWLQN runs at all."""
    from photon_ml_tpu_torch.optim.schedule import RegWeights
    cfg = config.resolved()
    if cfg.constraints is not None:
        raise ValueError(
            "named feature constraints are unresolved — call "
            "config.resolved_constraints(index_map) before solve()")
    if isinstance(reg_weight, RegWeights):
        l1_w, l2_w = reg_weight.l1_weight, reg_weight.l2_weight
    else:
        l1_w, l2_w = reg.split(reg_weight)
    obj = objective.with_l2(l2_w)
    tolerance, cap = cfg.tolerance, None
    if budget is not None:
        tolerance, cap = budget.tolerance_in(x0.dtype), budget.iteration_cap

    if cfg.optimizer == OptimizerType.TRON:
        check_tron(cfg, reg, objective.loss)
        return tron(obj.value_and_gradient, obj.hessian_vector_at, x0,
                    max_iterations=cfg.max_iterations, tolerance=tolerance,
                    max_cg_iterations=cfg.max_cg_iterations,
                    track_coefficients=cfg.track_coefficients,
                    iteration_cap=cap)

    lower, upper = box_bounds(cfg, x0)
    return lbfgs(obj.value_and_gradient, x0,
                 max_iterations=cfg.max_iterations, tolerance=tolerance,
                 history=cfg.history,
                 l1_weight=l1_w if reg.has_l1 else None,
                 lower=lower, upper=upper,
                 track_coefficients=cfg.track_coefficients,
                 iteration_cap=cap)
