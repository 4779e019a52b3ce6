"""TRON: trust-region Newton with truncated conjugate gradient, host-stepped
(port of photon_ml_tpu/optim/tron.py).

The JAX package runs the whole solve as one lax.while_loop (outer trust
region, inner CG), and the random-effect solver vmaps it over entities.
PyTorch has neither, so the loops run on the host over a leading lane axis
[E, d], as optim/batched.py does for LBFGS: every per-lane decision is a
mask, a lane whose loop condition is false is frozen, and the host reads
back one flag per CG round and one per outer step.  The single solve `tron`
is the one-lane case of `tron_lanes`, which the batched random-effect
solver calls with every lane of a bucket.

Constants, radius update, failure cap and counts are those of the JAX
package's tron, as is the arithmetic: the CG step that reaches the boundary
is counted (`hv_count`), a non-finite trial value gives rho = -inf, and the
initial radius is |g0|.  Each outer step evaluates `hessian_vector_at(x)`
once; the closure it returns is the Hessian-vector product at x, so the
margins and l'' of x are computed once per outer step and reused by every
CG step (the product itself is the same arithmetic as one
`hessian_vector(x, v)` call).
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN (ROADMAP C,
# "The solvers are host-stepped"): torch has no lax.while_loop, so the
# outer and CG loops run on the host: one flag read back per CG round and
# one per outer step

from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult

# x -> (v -> H(x) v), over [E, d] lanes or over one [d] vector
HessianVectorAt = Callable[[torch.Tensor], Callable[[torch.Tensor], torch.Tensor]]
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# trust-region control constants (the standard Lin-More values)
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIG1, _SIG3 = 0.25, 4.0
_CG_RTOL = 0.1        # inner CG stops at |r| <= 0.1 |g|
_MAX_FAILURES = 5

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _truncated_cg(hess_vec, g, delta, active, max_cg: int):
    """Per lane, approximately solve H s = -g within |s| <= delta.

    Stops a lane on residual tolerance, on boundary intersection (step
    extended to the sphere) or on negative curvature (step extended to the
    sphere along the current direction).  Lanes not `active` never step.
    Returns (s, sHs, hit_boundary, cg_iterations, rounds, readbacks):
    `rounds` is the number of Hessian-vector evaluations of the whole
    batch, `readbacks` the host's reads of the lanes' flags."""
    one = torch.ones((), dtype=g.dtype, device=g.device)
    s = torch.zeros_like(g)
    hs = torch.zeros_like(g)           # running H s (no final Hv pass)
    r = -g
    d = r
    rr = _dot(r, r)
    tol = _CG_RTOL * torch.sqrt(_dot(g, g))
    done = rr <= tol * tol
    boundary = torch.zeros_like(done)
    i = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    going = active & ~done
    rounds = readbacks = 0
    # every going lane has taken exactly `rounds` CG steps, so its
    # i < max_cg test is this loop's bound
    while rounds < max_cg:
        readbacks += 1
        if not bool(going.any()):
            break
        hd = hess_vec(d)
        rounds += 1
        dhd = _dot(d, hd)
        neg_curv = dhd <= 0
        alpha = rr / torch.where(neg_curv, one, dhd)
        s_try = s + alpha[:, None] * d
        hit = neg_curv | (_dot(s_try, s_try) > delta * delta)
        # tau >= 0 with |s + tau d| = delta
        dd, sd, ss = _dot(d, d), _dot(s, d), _dot(s, s)
        rad = torch.sqrt(torch.clamp(sd * sd + dd * (delta * delta - ss), min=0.0))
        tau = (rad - sd) / torch.where(dd > 0, dd, one)
        step = torch.where(hit, tau, alpha)
        r_new = torch.where(hit[:, None], r, r - alpha[:, None] * hd)
        rr_new = _dot(r_new, r_new)
        small = torch.sqrt(rr_new) <= tol
        beta = rr_new / torch.where(rr > 0, rr, one)
        lane = going[:, None]
        s = torch.where(lane, s + step[:, None] * d, s)
        hs = torch.where(lane, hs + step[:, None] * hd, hs)
        d = torch.where(lane, r_new + beta[:, None] * d, d)
        r = torch.where(lane, r_new, r)
        rr = torch.where(going, rr_new, rr)
        i = i + going
        boundary = boundary | (going & hit)
        done = done | (going & (hit | small))
        going = going & ~done
    return s, _dot(s, hs), boundary, i, rounds, readbacks


def tron_lanes(
    value_and_grad: ValueAndGrad,
    hessian_vector_at: HessianVectorAt,
    x0: torch.Tensor,
    *,
    max_iterations: int = 15,
    tolerance: float = 1e-5,
    max_cg_iterations: int = 20,
    track_coefficients: bool = False,
    iteration_cap: Optional[int] = None,
) -> SolveResult:
    """E independent TRON solves from x0 [E, d] at once.

    `value_and_grad` maps [E, d] to ([E] values, [E, d] gradients);
    `hessian_vector_at(x)` returns v [E, d] -> H(x) v [E, d].  Every
    evaluation runs for all lanes (the frozen ones' results are discarded),
    as under vmap.  Returns a SolveResult whose fields have a leading [E]
    axis; `rounds` and `hv_rounds` count the batch's value+gradient and
    Hessian-vector evaluations.  `iteration_cap` (one for every lane, as
    the JAX package passes its budget unmapped) stops the loop after
    min(cap, max_iterations) steps; `max_iterations` still sizes the
    histories.  x0 is not written."""
    E, d = x0.shape
    dtype, device = x0.dtype, x0.device
    tolerance = float(tolerance)
    one = torch.ones((), dtype=dtype, device=device)
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    lanes_long = lambda v: torch.full((E,), v, dtype=torch.int64, device=device)

    x = x0.clone()
    f, g = value_and_grad(x)
    rounds, hv_rounds, readbacks = 1, 0, 0
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    # relative, like the reference's eps |g0|
    gtol = tolerance * torch.maximum(gnorm, one)
    delta = gnorm  # initial radius = |g0|, the reference's choice
    failures = lanes_long(0)
    hv_count = lanes_long(0)
    iterations = lanes_long(0)
    reason = torch.where(gnorm <= gtol, int(ConvergenceReason.GRADIENT_CONVERGED),
                         _NOT_CONVERGED)
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
    active = reason == _NOT_CONVERGED

    # every active lane has taken exactly `step` iterations
    cap = (max_iterations if iteration_cap is None
           else min(int(iteration_cap), max_iterations))
    for step in range(cap):
        readbacks += 1
        if not bool(active.any()):
            break
        s, shs, hit, cg_n, cg_rounds, cg_readbacks = _truncated_cg(
            hessian_vector_at(x), g, delta, active, max_cg_iterations)
        hv_rounds += cg_rounds
        readbacks += cg_readbacks
        pred = -(_dot(g, s) + 0.5 * shs)               # predicted reduction
        x_try = x + s
        f_try, g_try = value_and_grad(x_try)
        rounds += 1
        finite = torch.isfinite(f_try)
        rho = (f - f_try) / torch.where(pred > 0, pred, one)
        # a non-finite trial value must behave like terrible model agreement
        # so the radius shrinks instead of re-trying the identical step
        rho = torch.where(finite, rho, -float("inf"))
        snorm = torch.linalg.vector_norm(s, dim=-1)
        accept = (rho > _ETA0) & (pred > 0) & finite
        # shrink on poor model agreement; grow only on strong agreement AND
        # a boundary-limited step (otherwise the Newton step fit inside)
        delta_new = torch.where(
            rho < _ETA1, _SIG1 * torch.minimum(snorm, delta),
            torch.where((rho > _ETA2) & hit, _SIG3 * delta, delta))
        take = active & accept
        x = torch.where(take[:, None], x_try, x)
        f = torch.where(take, f_try, f)
        g = torch.where(take[:, None], g_try, g)
        gnorm = torch.where(take, torch.linalg.vector_norm(g_try, dim=-1), gnorm)
        delta = torch.where(active, delta_new, delta)
        failures = torch.where(active, torch.where(accept, 0, failures + 1), failures)
        reason_new = torch.where(
            gnorm <= gtol, int(ConvergenceReason.GRADIENT_CONVERGED),
            torch.where(failures >= _MAX_FAILURES,
                        int(ConvergenceReason.TRUST_REGION_EXHAUSTED), _NOT_CONVERGED))
        reason = torch.where(active, reason_new, reason)
        iterations = iterations + active
        hv_count = hv_count + torch.where(active, cg_n, 0)
        loss_hist[:, step + 1] = torch.where(active, f, nan)
        gnorm_hist[:, step + 1] = torch.where(active, gnorm, nan)
        if coef_hist is not None:
            coef_hist[:, step + 1] = torch.where(active[:, None], x, nan)
        active = active & (reason == _NOT_CONVERGED)

    reason = torch.where(reason == _NOT_CONVERGED,
                         int(ConvergenceReason.MAX_ITERATIONS), reason)
    return SolveResult(x=x, value=f, gradient_norm=gnorm, iterations=iterations,
                       reason=reason, loss_history=loss_hist,
                       gnorm_history=gnorm_hist, coefficient_history=coef_hist,
                       hv_count=hv_count, rounds=rounds, hv_rounds=hv_rounds,
                       readbacks=readbacks)


def tron(
    value_and_grad: ValueAndGrad,
    hessian_vector_at: HessianVectorAt,
    x0: torch.Tensor,
    *,
    max_iterations: int = 15,
    tolerance: float = 1e-5,
    max_cg_iterations: int = 20,
    track_coefficients: bool = False,
    iteration_cap: Optional[int] = None,
) -> SolveResult:
    """Minimize a twice-differentiable objective from x0 [d].

    `value_and_grad` maps [d] to (scalar, [d]); `hessian_vector_at(x)`
    returns v [d] -> H(x) v.  Counts and the reason come back as ints;
    `fg_count` stays None (the value+gradient passes are iterations + 1).
    x0 is not written."""
    def lane_value_and_grad(x):
        v, g = value_and_grad(x[0])
        return v[None], g[None]

    def lane_hessian_vector_at(x):
        hv = hessian_vector_at(x[0])
        return lambda v: hv(v[0])[None]

    r = tron_lanes(lane_value_and_grad, lane_hessian_vector_at, x0[None],
                   max_iterations=max_iterations, tolerance=tolerance,
                   max_cg_iterations=max_cg_iterations,
                   track_coefficients=track_coefficients,
                   iteration_cap=iteration_cap)
    return SolveResult(
        x=r.x[0], value=r.value[0], gradient_norm=r.gradient_norm[0],
        iterations=int(r.iterations[0]), reason=int(r.reason[0]),
        loss_history=r.loss_history[0], gnorm_history=r.gnorm_history[0],
        coefficient_history=(None if r.coefficient_history is None
                             else r.coefficient_history[0]),
        hv_count=int(r.hv_count[0]))
