"""LBFGS and OWLQN, host-stepped (port of photon_ml_tpu/optim/lbfgs.py).

PyTorch has no lax.while_loop, so the iteration loop runs on the host, as
the JAX package's host-stepped mirror does (optim/streaming.py::host_lbfgs):
the iterate, gradient and [m, d] curvature buffers stay on the device and
the host reads back only the scalars it branches on (the descent test, the
Armijo test, the curvature test and the convergence checks).  Constants,
two-loop recursion, line search and convergence rules are those of the
resident solver, so both produce the same trajectory.

- Backtracking Armijo on the actual displacement, so box projection is
  correct: accept when f(P(x+t p)) <= f + c1 g.(P(x+t p) - x).
- OWLQN (l1_weight set): Andrew & Gao pseudo-gradient steering, direction
  sign projection, orthant-constrained trial points, Armijo on f + l1|x|_1.
  The L1 weight may be a scalar or a per-coordinate tensor.
- Every line-search trial evaluates the fused value+gradient; `fg_count`
  counts them all, the initial evaluation included.
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN (ROADMAP C,
# "The solvers are host-stepped"): torch has no lax.while_loop, so the
# iteration loop runs on the host and reads back the scalars it branches on
# (descent, Armijo, curvature and convergence tests)

from typing import Callable, List, Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

_C1 = 1e-4          # Armijo sufficient-decrease constant
_MAX_LS = 30        # max backtracking halvings
_CURV_EPS = 1e-12   # curvature-pair acceptance threshold
# In float32 one step's progress can round to an exact zero f-change while
# the solve is far from done, so function-value convergence needs this many
# CONSECUTIVE sub-tolerance changes.
_F_CONV_PERSISTENCE = 3


def _pseudo_gradient(x, g, l1):
    """OWLQN pseudo-gradient of f + l1*|x|_1 (Andrew & Gao 2007)."""
    gp = g + l1 * torch.sign(x)
    # at x_i == 0 the subgradient interval is [g-l1, g+l1]; steepest descent:
    lo, hi = g - l1, g + l1
    at_zero = torch.where(hi < 0, hi, torch.where(lo > 0, lo, torch.zeros_like(g)))
    return torch.where(x != 0, gp, at_zero)


def _project_box(x, lower, upper):
    """x clipped to [lower, upper] (either may be None)."""
    if lower is not None:
        x = torch.maximum(x, lower)
    if upper is not None:
        x = torch.minimum(x, upper)
    return x


def _box_blocked(x, g, lower, upper):
    """Coordinates pinned at an active bound (descent would exit)."""
    blocked = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if lower is not None:
        blocked = blocked | ((x <= lower) & (g > 0))
    if upper is not None:
        blocked = blocked | ((x >= upper) & (g < 0))
    return blocked


def _two_loop(q, s_buf, y_buf, rho, num_pairs: int, m: int):
    """Two-loop recursion over rolling buffers; pair (num_pairs-1-i) is the
    i-th newest, stored at slot (num_pairs-1-i) % m."""
    k = min(num_pairs, m)
    slot = lambda i: (num_pairs - 1 - i) % m
    alphas = []
    for i in range(k):
        j = slot(i)
        a = rho[j] * torch.dot(s_buf[j], q)
        q = q - a * y_buf[j]
        alphas.append(a)
    gamma = 1.0
    if num_pairs > 0:
        # H0 scaling from the newest pair
        jn = slot(0)
        sy = torch.dot(s_buf[jn], y_buf[jn])
        yy = torch.dot(y_buf[jn], y_buf[jn])
        one = torch.ones_like(yy)
        gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, one), one)
    r = gamma * q
    for ii in reversed(range(k)):  # oldest stored first
        j = slot(ii)
        b = rho[j] * torch.dot(y_buf[j], r)
        r = r + (alphas[ii] - b) * s_buf[j]
    return r


def _history(values: List[float], length: int, like: torch.Tensor) -> torch.Tensor:
    out = torch.full((length,), float("nan"), dtype=torch.float64)
    out[:len(values)] = torch.tensor(values, dtype=torch.float64)
    return out.to(dtype=like.dtype, device=like.device)


def lbfgs(
    value_and_grad: ValueAndGrad,
    x0: torch.Tensor,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history: int = 10,
    l1_weight: Optional[Union[torch.Tensor, float]] = None,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    track_coefficients: bool = False,
    iteration_cap: Optional[int] = None,
) -> SolveResult:
    """Minimize f (+ l1*|x|_1 when `l1_weight` is set: OWLQN) from x0.

    `value_and_grad` is the smooth part only.  `lower`/`upper` turn on
    per-coordinate box projection; box and L1 are exclusive, as in the
    reference.  `iteration_cap` (an inexactness budget,
    optim/schedule.py) stops the loop after min(cap, max_iterations)
    iterations; `max_iterations` still sizes the histories.  x0 is not
    written."""
    use_l1 = l1_weight is not None
    use_box = lower is not None or upper is not None
    if use_l1 and use_box:
        raise ValueError("L1 (OWLQN) and box constraints cannot be combined "
                         "(the reference has no such solver either)")
    m = history
    dtype, device = x0.dtype, x0.device
    d = x0.shape[-1]
    l1 = (torch.as_tensor(l1_weight, dtype=dtype, device=device)
          if use_l1 else None)

    project_box = lambda x: _project_box(x, lower, upper)
    box_blocked = lambda x, g: _box_blocked(x, g, lower, upper)

    def zero_where(mask, v):
        return torch.where(mask, torch.zeros_like(v), v)

    def steer_grad(x, g):
        """OWLQN pseudo-gradient under L1; the projected gradient under a
        box; the gradient otherwise."""
        if use_l1:
            return _pseudo_gradient(x, g, l1)
        if use_box:
            return zero_where(box_blocked(x, g), g)
        return g

    def full_value(x):
        v, g = value_and_grad(x)
        if use_l1:
            v = v + torch.sum(l1 * torch.abs(x))
        return v, g

    tolerance = float(tolerance)
    cap = (max_iterations if iteration_cap is None
           else min(int(iteration_cap), max_iterations))
    x = project_box(x0)
    f, g = full_value(x)
    gnorm = float(torch.linalg.norm(steer_grad(x, g)))
    # relative gradient convergence, like breeze's default check
    gtol = tolerance * max(gnorm, 1.0)

    s_buf = torch.zeros((m, d), dtype=dtype, device=device)
    y_buf = torch.zeros((m, d), dtype=dtype, device=device)
    rho = torch.zeros((m,), dtype=dtype, device=device)
    num_pairs = 0
    f_small = 0
    fg_count = 1  # the f0/g0 evaluation
    loss_hist = [float(f)]
    gnorm_hist = [gnorm]
    coef_hist = [x] if track_coefficients else None
    reason = ConvergenceReason.NOT_CONVERGED
    k = 0

    while k < cap and reason == ConvergenceReason.NOT_CONVERGED:
        steer = steer_grad(x, g)
        p = -_two_loop(steer, s_buf, y_buf, rho, num_pairs, m)
        if use_l1:
            # direction must agree with -pseudo-gradient sign-wise
            p = torch.where(p * (-steer) > 0, p, torch.zeros_like(p))
            orthant = torch.where(x != 0, torch.sign(x), torch.sign(-steer))
        if use_box:
            # keep the step in the free subspace
            p = zero_where(box_blocked(x, g), p)
        if float(torch.dot(steer, p)) >= 0:  # not a descent direction
            p = -steer
        # first iteration: scale so the first trial step is modest
        t = (1.0 / max(float(torch.linalg.norm(p)), 1.0)
             if num_pairs == 0 else 1.0)

        def trial(t):
            xt = x + t * p
            if use_l1:
                xt = torch.where(xt * orthant > 0, xt, torch.zeros_like(xt))
            return project_box(xt)

        def armijo_ok(xt, ft):
            # Armijo on the actual displacement (correct under projection)
            return bool((ft <= f + _C1 * torch.dot(steer, xt - x))
                        & torch.isfinite(ft))

        xt = trial(t)
        ft, gt = full_value(xt)
        fg_count += 1
        ls_ok = armijo_ok(xt, ft)
        ls_n = 0
        while not ls_ok and ls_n < _MAX_LS:
            t *= 0.5
            ls_n += 1
            xt = trial(t)
            ft, gt = full_value(xt)
            fg_count += 1
            ls_ok = armijo_ok(xt, ft)

        # curvature pair from raw gradients (standard OWLQN choice)
        s = xt - x
        yv = gt - g
        if use_box:
            # restrict the pair to the free subspace at the accepted point
            bl = box_blocked(xt, gt)
            s = zero_where(bl, s)
            yv = zero_where(bl, yv)
        if ls_ok:
            sy = torch.dot(s, yv)
            if float(sy) > _CURV_EPS:
                slot = num_pairs % m
                s_buf[slot] = s
                y_buf[slot] = yv
                rho[slot] = 1.0 / sy
                num_pairs += 1

            gnorm_new = float(torch.linalg.norm(steer_grad(xt, gt)))
            f_new, f_prev = float(ft), float(f)
            f_small_now = abs(f_prev - f_new) <= tolerance * max(
                abs(f_prev), abs(f_new), 1.0)
            f_small = f_small + 1 if f_small_now else 0
            if gnorm_new <= gtol:
                reason = ConvergenceReason.GRADIENT_CONVERGED
            elif f_small >= _F_CONV_PERSISTENCE:
                reason = ConvergenceReason.FUNCTION_VALUES_CONVERGED
            x, f, g, gnorm = xt, ft, gt, gnorm_new
        else:
            # on line-search failure keep the previous iterate
            reason = ConvergenceReason.LINE_SEARCH_FAILED

        k += 1
        loss_hist.append(float(f))
        gnorm_hist.append(gnorm)
        if coef_hist is not None:
            coef_hist.append(x)

    if reason == ConvergenceReason.NOT_CONVERGED:
        reason = ConvergenceReason.MAX_ITERATIONS
    coefficient_history = None
    if coef_hist is not None:
        coefficient_history = torch.full((max_iterations + 1, d), float("nan"),
                                         dtype=dtype, device=device)
        coefficient_history[:len(coef_hist)] = torch.stack(coef_hist)
    return SolveResult(
        x=x, value=f,
        gradient_norm=torch.tensor(gnorm, dtype=dtype, device=device),
        iterations=k, reason=int(reason),
        loss_history=_history(loss_hist, max_iterations + 1, x),
        gnorm_history=_history(gnorm_hist, max_iterations + 1, x),
        coefficient_history=coefficient_history,
        fg_count=fg_count)


def owlqn(value_and_grad: ValueAndGrad, x0: torch.Tensor, *, l1_weight,
          max_iterations: int = 100, tolerance: float = 1e-7,
          history: int = 10,
          iteration_cap: Optional[int] = None) -> SolveResult:
    """L1/elastic-net solver: the L2 part lives in the smooth objective;
    only L1 comes through here."""
    return lbfgs(value_and_grad, x0, max_iterations=max_iterations,
                 tolerance=tolerance, history=history, l1_weight=l1_weight,
                 iteration_cap=iteration_cap)
