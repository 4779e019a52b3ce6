"""Batched LBFGS/OWLQN/TRON over a leading lane axis: E independent solves
at once.

The JAX package solves every entity of a random-effect bucket with
`jax.jit(jax.vmap(solve))` (parallel/random_effect.py::_cached_batched_solver
over optim/lbfgs.py): a vmapped `lax.while_loop` runs its body for every
lane and keeps each lane's old state where that lane's loop condition is
false, so each lane follows the trajectory of its own unbatched solve.
PyTorch cannot vmap a loop whose trip count depends on the data, so here
the loop runs on the host and every per-lane decision is a mask:

- state per lane on the device: x, f, g [E, .]; the s/y history [E, m, d]
  kept newest first (slot i holds the lane's i-th newest pair, valid while
  i < min(num_pairs, m), as the reference's modular slots are); rho [E, m];
  num_pairs, f_small, fg_count, reason and iterations [E];
- a lane whose loop condition is false is frozen: its x, f, g and history
  never move again;
- the line search is per lane: a lane that has passed Armijo keeps its
  accepted trial while the others halve, and each lane's fg_count counts
  only its own trials;
- the host reads back one pair of flags per step (any lane active, any
  lane still searching) and one flag per extra backtracking round.

Constants, the two-loop recursion, the line search, box projection and the
convergence rules are those of optim/lbfgs.py; box bounds are one [d]
vector shared by every lane, as under vmap with unmapped bounds.  Every
value+gradient evaluation runs for all lanes (the frozen ones' results are
discarded), as under vmap.  TRON's lanes are optim/tron.py::tron_lanes.
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN (ROADMAP C,
# "The solvers are host-stepped"): torch has no lax.while_loop, so the
# lane loop runs on the host: each round reads back the lanes' masks

from typing import Callable, Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.optim.config import OptimizerType, box_bounds, check_tron
from photon_ml_tpu_torch.optim.lbfgs import (
    _C1, _CURV_EPS, _F_CONV_PERSISTENCE, _MAX_LS, _box_blocked, _project_box,
    _pseudo_gradient,
)
from photon_ml_tpu_torch.optim.tron import HessianVectorAt, tron_lanes
from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult

# [E, d] -> ([E] values, [E, d] gradients)
BatchedValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _two_loop(q, s_buf, y_buf, rho, num_pairs, pairs_bound: int):
    """Two-loop recursion per lane over newest-first histories.  Slots at
    or beyond a lane's pair count contribute exactly nothing (alpha = 0),
    as in the reference's masked loop; `pairs_bound` (a host bound on
    every lane's pair count) skips slots no lane has filled."""
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    alphas = []
    for i in range(pairs_bound):
        valid = i < num_pairs
        a = torch.where(valid, rho[:, i] * _dot(s_buf[:, i], q), zero)
        q = q - a[:, None] * y_buf[:, i]
        alphas.append(a)
    # H0 scaling from the newest pair
    sy = _dot(s_buf[:, 0], y_buf[:, 0])
    yy = _dot(y_buf[:, 0], y_buf[:, 0])
    one = torch.ones((), dtype=q.dtype, device=q.device)
    gamma = torch.where((num_pairs > 0) & (yy > 0),
                        sy / torch.where(yy > 0, yy, one), one)
    r = gamma[:, None] * q
    for i in reversed(range(pairs_bound)):  # oldest stored first
        valid = i < num_pairs
        b = torch.where(valid, rho[:, i] * _dot(y_buf[:, i], r), zero)
        r = r + torch.where(valid, alphas[i] - b, zero)[:, None] * s_buf[:, i]
    return r


def _push(buf: torch.Tensor, new: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """Lanes in `store` push `new` in at slot 0 (the oldest slot drops
    out); the other lanes keep their history."""
    shifted = torch.cat([new[:, None], buf[:, :-1]], dim=1)
    return torch.where(store.view(-1, *([1] * (buf.ndim - 1))), shifted, buf)


def lbfgs(
    value_and_grad: BatchedValueAndGrad,
    x0: torch.Tensor,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history: int = 10,
    l1_weight: Optional[Union[torch.Tensor, float]] = None,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    iteration_cap: Optional[int] = None,
    track_coefficients: bool = False,
) -> SolveResult:
    """Minimize f_e (+ l1_e*|x_e|_1 when `l1_weight` is set: OWLQN) for
    every lane e of x0 [E, d] at once.  `l1_weight` is one weight for every
    lane or an [E] tensor of per-lane weights (the candidate lanes of a
    hyperparameter sweep); `lower`/`upper` [d] turn on box
    projection for every lane.  `iteration_cap` is one cap for every lane
    (the JAX package passes its budget unmapped): the loop stops after
    min(cap, max_iterations) steps, and `max_iterations` sizes the
    histories.

    Returns a SolveResult whose fields have a leading [E] axis: x [E, d],
    value, gradient_norm, iterations, reason and fg_count [E], histories
    [E, max_iterations + 1], and with `track_coefficients` the iterates
    [E, max_iterations + 1, d] (row 0 the projected x0, NaN after a lane
    stops, as under vmap).  x0 is not written."""
    use_l1 = l1_weight is not None
    use_box = lower is not None or upper is not None
    if use_l1 and use_box:
        raise ValueError("L1 (OWLQN) and box constraints cannot be combined "
                         "(the reference has no such solver either)")
    m = history
    E, d = x0.shape
    dtype, device = x0.dtype, x0.device
    l1 = (torch.as_tensor(l1_weight, dtype=dtype, device=device)
          if use_l1 else None)
    if l1 is not None and l1.ndim == 1:
        # per-lane weights: the pseudo-gradient and the orthant value term
        # take each lane's own
        l1 = l1[:, None]
    tolerance = float(tolerance)
    cap = (max_iterations if iteration_cap is None
           else min(int(iteration_cap), max_iterations))
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    project_box = lambda x: _project_box(x, lower, upper)
    box_blocked = lambda x, g: _box_blocked(x, g, lower, upper)

    def steer_grad(x, g):
        """OWLQN pseudo-gradient under L1; the projected gradient under a
        box; the gradient otherwise."""
        if use_l1:
            return _pseudo_gradient(x, g, l1)
        if use_box:
            return torch.where(box_blocked(x, g), zero, g)
        return g

    rounds = readbacks = 0

    def full_value(x):
        nonlocal rounds
        rounds += 1
        v, g = value_and_grad(x)
        if use_l1:
            v = v + (l1 * torch.abs(x)).sum(-1)
        return v, g

    x = project_box(x0.clone())
    f, g = full_value(x)
    gnorm = torch.linalg.vector_norm(steer_grad(x, g), dim=-1)
    # relative gradient convergence, like breeze's default check
    gtol = tolerance * torch.maximum(gnorm, one)

    s_buf = torch.zeros((E, m, d), dtype=dtype, device=device)
    y_buf = torch.zeros((E, m, d), dtype=dtype, device=device)
    rho = torch.zeros((E, m), dtype=dtype, device=device)
    lanes_long = lambda v: torch.full((E,), v, dtype=torch.int64, device=device)
    num_pairs = lanes_long(0)
    f_small = lanes_long(0)
    fg_count = lanes_long(1)  # the f0/g0 evaluation
    reason = lanes_long(int(ConvergenceReason.NOT_CONVERGED))
    iterations = lanes_long(0)
    loss_hist = torch.full((E, max_iterations + 1), float("nan"),
                           dtype=dtype, device=device)
    gnorm_hist = torch.full_like(loss_hist, float("nan"))
    loss_hist[:, 0] = f
    gnorm_hist[:, 0] = gnorm
    coef_hist = None
    if track_coefficients:
        coef_hist = torch.full((E, max_iterations + 1, d), float("nan"),
                               dtype=dtype, device=device)
        coef_hist[:, 0] = x
    active = torch.full((E,), cap > 0 and E > 0,
                        dtype=torch.bool, device=device)

    # every active lane has taken exactly `step` iterations
    for step in range(cap):
        steer = steer_grad(x, g)
        p = -_two_loop(steer, s_buf, y_buf, rho, num_pairs, min(step, m))
        if use_l1:
            # direction must agree with -pseudo-gradient sign-wise
            p = torch.where(p * (-steer) > 0, p, zero)
            orthant = torch.where(x != 0, torch.sign(x), torch.sign(-steer))
        if use_box:
            # keep the step in the free subspace
            p = torch.where(box_blocked(x, g), zero, p)
        # fall back to steepest descent where not a descent direction
        p = torch.where((_dot(steer, p) >= 0)[:, None], -steer, p)
        # first iteration: scale so the first trial step is modest
        t = torch.where(num_pairs == 0,
                        1.0 / torch.maximum(torch.linalg.vector_norm(p, dim=-1), one),
                        one)

        def trial(t):
            xt = x + t[:, None] * p
            if use_l1:
                xt = torch.where(xt * orthant > 0, xt, zero)
            return project_box(xt)

        def armijo_ok(xt, ft):
            # Armijo on the actual displacement
            return (ft <= f + _C1 * _dot(steer, xt - x)) & torch.isfinite(ft)

        xt = trial(t)
        ft, gt = full_value(xt)
        ok = armijo_ok(xt, ft)
        ls_n = lanes_long(0)
        searching = active & ~ok
        any_active, any_searching = torch.stack(
            [active.any(), searching.any()]).tolist()
        readbacks += 1
        if not any_active:
            break
        while any_searching:
            t = torch.where(searching, t * 0.5, t)
            xs = trial(t)
            fs, gs = full_value(xs)
            ok = torch.where(searching, armijo_ok(xs, fs), ok)
            xt = torch.where(searching[:, None], xs, xt)
            ft = torch.where(searching, fs, ft)
            gt = torch.where(searching[:, None], gs, gt)
            ls_n = ls_n + searching
            searching = searching & ~ok & (ls_n < _MAX_LS)
            any_searching = bool(searching.any())
            readbacks += 1

        # curvature pair from raw gradients (standard OWLQN choice)
        s = xt - x
        yv = gt - g
        if use_box:
            # restrict the pair to the free subspace at the accepted point
            bl = box_blocked(xt, gt)
            s = torch.where(bl, zero, s)
            yv = torch.where(bl, zero, yv)
        sy = _dot(s, yv)
        store = active & ok & (sy > _CURV_EPS)
        s_buf = _push(s_buf, s, store)
        y_buf = _push(y_buf, yv, store)
        rho = _push(rho, 1.0 / torch.where(store, sy, one), store)
        num_pairs = num_pairs + store

        gnorm_new = torch.linalg.vector_norm(steer_grad(xt, gt), dim=-1)
        f_small_now = torch.abs(f - ft) <= tolerance * torch.maximum(
            torch.maximum(torch.abs(f), torch.abs(ft)), one)
        f_small_new = torch.where(f_small_now, f_small + 1, 0)
        reason_new = torch.where(
            ~ok, int(ConvergenceReason.LINE_SEARCH_FAILED),
            torch.where(gnorm_new <= gtol, int(ConvergenceReason.GRADIENT_CONVERGED),
                        torch.where(f_small_new >= _F_CONV_PERSISTENCE,
                                    int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                                    int(ConvergenceReason.NOT_CONVERGED))))
        # on line-search failure the lane keeps its previous iterate
        take = active & ok
        x = torch.where(take[:, None], xt, x)
        f = torch.where(take, ft, f)
        g = torch.where(take[:, None], gt, g)
        gnorm = torch.where(take, gnorm_new, gnorm)
        f_small = torch.where(active, f_small_new, f_small)
        reason = torch.where(active, reason_new, reason)
        fg_count = fg_count + active * (1 + ls_n)
        iterations = iterations + active
        loss_hist[:, step + 1] = torch.where(active, f, nan)
        gnorm_hist[:, step + 1] = torch.where(active, gnorm, nan)
        if coef_hist is not None:
            coef_hist[:, step + 1] = torch.where(active[:, None], x, nan)
        active = active & (reason == int(ConvergenceReason.NOT_CONVERGED))

    reason = torch.where(reason == int(ConvergenceReason.NOT_CONVERGED),
                         int(ConvergenceReason.MAX_ITERATIONS), reason)
    return SolveResult(x=x, value=f, gradient_norm=gnorm, iterations=iterations,
                       reason=reason, loss_history=loss_hist,
                       gnorm_history=gnorm_hist, coefficient_history=coef_hist,
                       fg_count=fg_count,
                       rounds=rounds, readbacks=readbacks)


def solve(value_and_grad: BatchedValueAndGrad, x0: torch.Tensor, config,
          reg, reg_weight=0.0, loss=None,
          hessian_vector_at: Optional[HessianVectorAt] = None,
          budget=None) -> SolveResult:
    """The batched counterpart of optim/config.py::solve for
    `value_and_grad` over lanes that already carry the L2 term: L1 goes to
    OWLQN, box bounds to every LBFGS lane, TRON (with `loss` and
    `hessian_vector_at`, which carries the L2 term too) to tron_lanes.
    `config` is an OptimizerConfig, `reg` a RegularizationContext;
    `reg_weight` a total weight or an optim/schedule.py RegWeights whose
    l1 weight may be an [E] tensor, one per lane (the l2 weights are the
    oracle's); `budget` (optim/schedule.py SolveBudget) is one iteration
    cap and tolerance for every lane.  With `config.track_coefficients`
    the result carries every lane's iterates, [E, max_iterations + 1, d],
    written on the device in the steps that write the loss history."""
    from photon_ml_tpu_torch.optim.schedule import RegWeights
    cfg = config.resolved()
    if cfg.constraints is not None:
        raise ValueError(
            "named feature constraints are unresolved — call "
            "config.resolved_constraints(index_map) before solve()")
    tolerance, cap = cfg.tolerance, None
    if budget is not None:
        tolerance, cap = budget.tolerance_in(x0.dtype), budget.iteration_cap
    if cfg.optimizer == OptimizerType.TRON:
        check_tron(cfg, reg, loss)
        return tron_lanes(value_and_grad, hessian_vector_at, x0,
                          max_iterations=cfg.max_iterations,
                          tolerance=tolerance,
                          max_cg_iterations=cfg.max_cg_iterations,
                          track_coefficients=cfg.track_coefficients,
                          iteration_cap=cap)
    l1_w = (reg_weight.l1_weight if isinstance(reg_weight, RegWeights)
            else reg.split(reg_weight)[0])
    lower, upper = box_bounds(cfg, x0)
    return lbfgs(value_and_grad, x0, max_iterations=cfg.max_iterations,
                 tolerance=tolerance, history=cfg.history,
                 l1_weight=l1_w if reg.has_l1 else None,
                 lower=lower, upper=upper, iteration_cap=cap,
                 track_coefficients=cfg.track_coefficients)
