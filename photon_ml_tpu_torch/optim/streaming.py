"""Host-stepped LBFGS / OWLQN / TRON for out-of-core (chunked) objectives
(port of photon_ml_tpu/optim/streaming.py).

In the JAX package the resident solvers are single lax.while_loop
programs, so a streamed objective, whose oracle is a host-driven pass over
chunks, needs host-stepped mirrors of them.  The port's solvers
(optim/lbfgs.py, optim/tron.py) are host-stepped already, with the
constants, update rules and convergence conditions of the JAX package's
(and of its host-stepped mirrors here), so the streamed entry points run
them on the streamed oracle:

  * every oracle call (value+gradient, Hessian-vector) is one double-
    buffered pass over the chunk stream;
  * optimizer state (iterate, gradient, [m, d] curvature buffers, CG
    vectors) stays on the device; the host reads back only the scalars it
    branches on.

As in the JAX mirrors, an `iteration_cap` below 1 runs one iteration.

On a mesh (ops/chunked.py with `mesh=`) every oracle value is already
summed over the data axis when the solver sees it, and the solvers read
nothing else of the data: the line-search branches, the convergence tests
and the caps are taken on equal values on every rank, so every rank steps
to the same iterate.
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN: this module IS
# the documented exception to the batched-flush rule; the host reads back
# exactly the scalars it branches on (see module docstring)

from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, box_bounds,
    check_tron,
)
from photon_ml_tpu_torch.optim.lbfgs import lbfgs
from photon_ml_tpu_torch.optim.tron import tron
from photon_ml_tpu_torch.optim.types import SolveResult

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
HessVec = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _cap(iteration_cap: Optional[int]) -> Optional[int]:
    return None if iteration_cap is None else max(1, int(iteration_cap))


def host_lbfgs(
    value_and_grad: ValueAndGrad,
    x0: torch.Tensor,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history: int = 10,
    l1_weight=None,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    iteration_cap: Optional[int] = None,
) -> SolveResult:
    """The JAX package's host_lbfgs: optim.lbfgs.lbfgs over a streamed
    oracle (no coefficient tracking: a streamed solve exists because
    device memory is scarce).  Histories stay sized by `max_iterations`."""
    return lbfgs(value_and_grad, x0, max_iterations=max_iterations,
                 tolerance=tolerance, history=history, l1_weight=l1_weight,
                 lower=lower, upper=upper, iteration_cap=_cap(iteration_cap))


def host_owlqn(value_and_grad: ValueAndGrad, x0: torch.Tensor, *, l1_weight,
               max_iterations: int = 100, tolerance: float = 1e-7,
               history: int = 10,
               iteration_cap: Optional[int] = None) -> SolveResult:
    return host_lbfgs(value_and_grad, x0, max_iterations=max_iterations,
                      tolerance=tolerance, history=history,
                      l1_weight=l1_weight, iteration_cap=iteration_cap)


def host_tron(
    value_and_grad: ValueAndGrad,
    hess_vec: HessVec,
    x0: torch.Tensor,
    *,
    max_iterations: int = 15,
    tolerance: float = 1e-5,
    max_cg_iterations: int = 20,
    iteration_cap: Optional[int] = None,
) -> SolveResult:
    """The JAX package's host_tron: optim.tron.tron over a streamed oracle;
    each CG step's `hess_vec(x, d)` is one streamed pass."""
    return tron(value_and_grad, lambda x: (lambda v: hess_vec(x, v)), x0,
                max_iterations=max_iterations, tolerance=tolerance,
                max_cg_iterations=max_cg_iterations,
                iteration_cap=_cap(iteration_cap))


def solve_streamed(
    objective,
    x0: torch.Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
    budget=None,
    stochastic=None,
) -> SolveResult:
    """solve() for a ChunkedGLMObjective: the dispatch rules of
    optim.config.solve (L2 into the smooth objective, L1 to OWLQN, TRON
    constraints), driving the host-stepped solvers above.

    `budget` (optim.schedule.SolveBudget) overrides the iteration cap and
    tolerance of this solve.  `stochastic` (optim.schedule.StochasticPlan)
    routes the solve to the coarse lane instead (optim/stochastic.py):
    `passes` stochastic passes, each staged chunk pinned for
    `local_epochs` of seeded coordinate descent.  The lane takes smooth
    L2-regularized objectives; L1 (OWLQN) and box-constrained solves fall
    through to the strict lane."""
    cfg = config.resolved()
    if cfg.constraints is not None:
        raise ValueError(
            "named feature constraints are unresolved — call "
            "config.resolved_constraints(index_map) before solve_streamed()")
    l1_w, l2_w = reg.split(reg_weight)
    obj = objective.with_l2(l2_w)

    if stochastic is not None and stochastic.passes > 0 \
            and not reg.has_l1 \
            and cfg.box_lower is None and cfg.box_upper is None:
        from photon_ml_tpu_torch.optim.stochastic import solve_stochastic
        return solve_stochastic(obj, x0, stochastic,
                                max_iterations=cfg.max_iterations)
    iteration_cap = None if budget is None else int(budget.iteration_cap)
    tolerance = cfg.tolerance if budget is None else float(budget.tolerance)

    if cfg.optimizer == OptimizerType.TRON:
        check_tron(cfg, reg, objective.loss)
        return host_tron(obj.value_and_gradient, obj.hessian_vector, x0,
                         max_iterations=cfg.max_iterations,
                         tolerance=tolerance,
                         max_cg_iterations=cfg.max_cg_iterations,
                         iteration_cap=iteration_cap)

    lower, upper = box_bounds(cfg, x0)
    return host_lbfgs(obj.value_and_gradient, x0,
                      max_iterations=cfg.max_iterations,
                      tolerance=tolerance, history=cfg.history,
                      l1_weight=l1_w if reg.has_l1 else None,
                      lower=lower, upper=upper,
                      iteration_cap=iteration_cap)
