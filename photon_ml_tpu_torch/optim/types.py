"""Optimizer result types and convergence reasons (port of
photon_ml_tpu/optim/types.py).

The solvers here are host-stepped, so counts and reasons are Python ints;
histories are tensors of the solve's dtype, NaN beyond the iteration count.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class ConvergenceReason(enum.IntEnum):
    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    LINE_SEARCH_FAILED = 4          # reference: ObjectiveNotImproving
    TRUST_REGION_EXHAUSTED = 5      # TRON: max step-failures


@dataclasses.dataclass
class SolveResult:
    """Solution + the states-tracker table.

    `loss_history[i]` / `gnorm_history[i]` are the objective value and
    gradient norm entering iteration i (index 0 is the initial state)."""

    x: torch.Tensor
    value: torch.Tensor
    gradient_norm: torch.Tensor
    iterations: int
    reason: int                     # ConvergenceReason code
    loss_history: torch.Tensor      # [max_iter + 1]
    gnorm_history: torch.Tensor     # [max_iter + 1]
    coefficient_history: Optional[torch.Tensor] = None  # [max_iter + 1, d]
    # LBFGS/OWLQN: fused value+gradient evaluations, the initial one and
    # every line-search trial included — each is a full pass over the data
    fg_count: Optional[int] = None
    # TRON: Hessian-vector products, one per inner CG step (the step that
    # reaches the trust-region boundary included); fg_count stays None and
    # the value+gradient passes are iterations + 1
    hv_count: Optional[int] = None
    # batched solves (optim/batched.py): value+gradient rounds of the whole
    # batch, each evaluating every lane (>= the largest lane's fg_count)
    rounds: Optional[int] = None
    # batched TRON: Hessian-vector rounds of the whole batch, each
    # evaluating every lane (>= the largest lane's hv_count)
    hv_rounds: Optional[int] = None
    # batched solves: the host's read-backs of lane flags (the syncs that
    # pace a host-stepped batch)
    readbacks: Optional[int] = None

    @property
    def converged(self) -> bool:
        return self.reason in (ConvergenceReason.FUNCTION_VALUES_CONVERGED,
                               ConvergenceReason.GRADIENT_CONVERGED)

    def summary(self) -> str:
        """Formatted convergence table."""
        it = int(self.iterations)
        lines = [f"{'iter':>5} {'loss':>18} {'|grad|':>14}"]
        loss = self.loss_history.detach().cpu().numpy().astype(np.float64)
        gn = self.gnorm_history.detach().cpu().numpy().astype(np.float64)
        for i in range(it + 1):
            lines.append(f"{i:>5} {loss[i]:>18.10e} {gn[i]:>14.6e}")
        reason = ConvergenceReason(int(self.reason)).name
        lines.append(f"converged after {it} iterations: {reason}")
        return "\n".join(lines)
