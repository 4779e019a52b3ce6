"""Consensus ADMM over the mesh's feature axis: the wide-model solver lane
(port of photon_ml_tpu/optim/admm.py).

The design matrix splits into F column blocks X = [X_1 .. X_F] and D row
blocks: rank (i, j) of the mesh holds X_ij, [n/D, d_F].  The iteration
alternates

  w_j  <- argmin  l2/2 ||w_j||^2 [+ rho/2 ||w_j - v_j + t_j||^2]
              + rho/2 || X_j w_j - X_j w_j^k - r ||^2      (per shard)
  zbar <- prox of the pointwise loss on the AVERAGE margin  (per row)
  ubar <- ubar + mbar - zbar                                (scaled dual)

with r = zbar - mbar - ubar and mbar = (1/F) sum_j X_j w_j.  The w-update
is closed form through the cached eigendecomposition of the shard's Gram
G_j = sum_i X_ij^T X_ij = Q_j diag(lam_j) Q_j^T (one data-axis all_reduce
of [d_F, d_F] at staging, then `torch.linalg.eigh`), for any shift
c = l2/rho (+1 with the L1 split).

Communication per iteration, through the mesh's counting wrapper
(parallel/mesh.py), is exactly:
  * ONE [n_local] all_reduce over the FEATURE axis: the margin sum;
  * ONE [d_F] all_reduce over the DATA axis: the residual product X_j^T r;
  * ONE packed all_reduce of ten scalars over the whole mesh: the residual
    norms, the stopping scales and the objective's three terms (row sums
    from the ranks of feature block 0, coefficient sums from the ranks of
    row block 0, so each enters once).

The JAX package's loop is a device `while_loop`; the port's is host
stepped and reads back once per iteration (the packed scalars), so every
rank takes the same branches on the same reduced values: rho adaptation
and the stopping test run on the host in float64.

L1 / elastic net uses the extra split v_j = w_j with the soft threshold
as the v-update; the solution reported is v (exact zeros).  The z-prox
runs a fixed number of guarded 1-D Newton steps per row.
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN (ROADMAP C,
# "The solvers are host-stepped"): torch has no lax.while_loop, so the
# ADMM loop runs on the host and reads back its packed scalars once an
# iteration

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optim.schedule import SolveBudget
from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult

#: adaptive-rho clamp: residual balancing never leaves this window
RHO_MIN = 1e-6
RHO_MAX = 1e6


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """The ADMM lane's knobs; `None` means the default (resolved()).

    `max_iterations` sizes the histories, a SolveBudget caps a visit;
    `rho` is the initial penalty; `adapt_rho` turns on residual balancing
    (multiply by `rho_tau` when the primal residual exceeds `rho_mu` times
    the dual, divide on the reverse; the scaled duals are rescaled in the
    same step); `newton_steps` bounds the z-prox refinement; `polish` runs
    the monolithic solver once afterwards, warm-started from the consensus
    solution."""

    max_iterations: Optional[int] = None     # None -> 200
    tolerance: Optional[float] = None        # None -> 1e-8 (relative)
    rho: float = 1.0
    adapt_rho: bool = True
    rho_tau: float = 2.0
    rho_mu: float = 10.0
    newton_steps: int = 8
    polish: bool = True

    def __post_init__(self):
        for name in ("rho", "rho_tau", "rho_mu"):
            object.__setattr__(self, name, float(getattr(self, name)))
        if self.tolerance is not None:
            object.__setattr__(self, "tolerance", float(self.tolerance))
        if self.rho <= 0:
            raise ValueError("rho must be > 0")
        if self.rho_tau <= 1.0:
            raise ValueError("rho_tau must be > 1 (the balancing step)")
        if self.rho_mu < 1.0:
            raise ValueError("rho_mu must be >= 1")
        if self.newton_steps < 1:
            raise ValueError("newton_steps must be >= 1")

    def resolved(self) -> "ADMMConfig":
        """Defaults filled in; duck-types OptimizerConfig.resolved() so a
        SolverSchedule maps its budgets onto the ADMM iterations."""
        return dataclasses.replace(
            self,
            max_iterations=(self.max_iterations
                            if self.max_iterations is not None else 200),
            tolerance=self.tolerance if self.tolerance is not None else 1e-8)


class ADMMOperands(NamedTuple):
    """One rank's operands: its block of the design grid [n_local, d_F],
    its column block's Gram eigendecomposition, its rows' labels, kappa
    (weights * mask: 0 on padded rows) and offsets, the two penalty
    weights, and the largest eigenvalue over every column block."""

    x: torch.Tensor
    q_eig: torch.Tensor      # [d_F, d_F]
    lam_eig: torch.Tensor    # [d_F]
    lam_max: float
    labels: torch.Tensor     # [n_local]
    kappa: torch.Tensor      # [n_local]
    offsets: Optional[torch.Tensor]
    l1_weight: float
    l2_weight: float


def _soft_threshold(x, thresh):
    return torch.sign(x) * torch.clamp(torch.abs(x) - thresh, min=0.0)


def gram_eig(mesh, x_block: torch.Tensor):
    """(Q, lam, lam_max) of this rank's column block Gram
    G_j = sum_i X_ij^T X_ij: one data-axis all_reduce of [d_F, d_F], then
    `eigh` (every rank of the column computes it from the same sum); the
    largest eigenvalue over all column blocks comes from one feature-axis
    all_reduce of the [F, d_F] eigenvalue table."""
    from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, FEATURE_AXIS
    gram = mesh.all_reduce(x_block.T @ x_block, DATA_AXIS)
    lam, q = torch.linalg.eigh(gram)
    table = lam.new_zeros((mesh.num_feature, lam.shape[0]))
    table[mesh.feature_index] = lam
    lam_max = float(mesh.all_reduce(table, FEATURE_AXIS).max())
    return q, lam, lam_max


class _Sums:
    """Indices of the packed scalar all_reduce."""
    PRIM_ROWS, DUAL_ROWS, MBAR2, ZBAR2, UBAR2, LOSS = range(6)
    PRIM_COEF, DUAL_COEF, W2, V1 = range(6, 10)
    SIZE = 10


def admm_solve(loss: PointwiseLoss, has_l1: bool, ops: ADMMOperands,
               w0: torch.Tensor, config: ADMMConfig, mesh,
               budget: Optional[SolveBudget] = None,
               rho0=None) -> SolveResult:
    """Run one consensus-ADMM solve on this rank's staged operands (every
    rank of `mesh` calls it together).  `w0` is this rank's [d_F] block of
    the warm start; `budget` caps the iterations and sets the tolerance
    (None: the config's); `rho0` overrides the initial penalty.  The
    returned `x` is the full [F * d_F] solution on every rank (one
    feature-axis all_reduce after the loop); `gradient_norm` and
    `gnorm_history` report the primal residual norm."""
    from photon_ml_tpu_torch.parallel.mesh import (
        DATA_AXIS, FEATURE_AXIS, WORLD_AXIS,
    )
    cfg = config.resolved()
    ceil = cfg.max_iterations
    if budget is None:
        budget = SolveBudget.make(ceil, cfg.tolerance)
    rho = float(cfg.rho if rho0 is None else rho0)
    cap = min(int(budget.iteration_cap), ceil)
    tol = budget.tolerance_in(ops.x.dtype)
    F = float(mesh.num_feature)
    l1, l2 = float(ops.l1_weight), float(ops.l2_weight)
    rows_here = mesh.feature_index == 0    # row sums enter once
    coefs_here = mesh.data_index == 0      # coefficient sums enter once
    x, q_eig, lam = ops.x, ops.q_eig, ops.lam_eig
    off = ops.offsets if ops.offsets is not None else 0.0
    floor = 1e-12 * (ops.lam_max + 1.0)

    def margin_mean(w):
        return mesh.all_reduce(x @ w, FEATURE_AXIS) / F

    def z_prox(zbar, target, rho_):
        z = zbar
        for _ in range(cfg.newton_steps):
            m = F * z + off
            g = ops.kappa * F * loss.dz(m, ops.labels) + F * rho_ * (z - target)
            h = ops.kappa * (F * F) * loss.d2z(m, ops.labels) + F * rho_
            z = z - g / h
        return z

    def scalar_sums(mbar, zbar, zbar_old, ubar, w, v, v_old):
        s = x.new_zeros(_Sums.SIZE)
        if rows_here:
            s[_Sums.PRIM_ROWS] = torch.sum((mbar - zbar) ** 2)
            s[_Sums.DUAL_ROWS] = torch.sum((zbar - zbar_old) ** 2)
            s[_Sums.MBAR2] = torch.sum(mbar ** 2)
            s[_Sums.ZBAR2] = torch.sum(zbar ** 2)
            s[_Sums.UBAR2] = torch.sum(ubar ** 2)
            s[_Sums.LOSS] = torch.sum(ops.kappa * loss.loss(F * mbar + off,
                                                            ops.labels))
        if coefs_here:
            s[_Sums.PRIM_COEF] = torch.sum((w - v) ** 2)
            s[_Sums.DUAL_COEF] = torch.sum((v - v_old) ** 2)
            s[_Sums.W2] = torch.sum(w * w)
            s[_Sums.V1] = torch.sum(torch.abs(v))
        # the iteration's one read-back: every branch below is taken on it
        return mesh.all_reduce(s, WORLD_AXIS).tolist()

    def objective(s):
        val = s[_Sums.LOSS] + 0.5 * l2 * s[_Sums.W2]
        return val + l1 * s[_Sums.V1] if has_l1 else val

    w = w0.clone()
    v, t = w, torch.zeros_like(w)
    mbar = margin_mean(w)
    zbar, ubar = mbar, torch.zeros_like(mbar)
    loss_history = [math.nan] * (ceil + 1)
    gnorm_history = [math.nan] * (ceil + 1)
    s = scalar_sums(mbar, zbar, zbar, ubar, w, v, v)
    loss_history[0], gnorm_history[0] = objective(s), 0.0
    value = loss_history[0]
    prim = dual = math.inf
    prim_scale = dual_scale = 1.0
    k = 0
    while k < cap and (prim > tol * prim_scale or dual > tol * dual_scale):
        # w-update: (G + shift I)^{-1}(G w + X^T r [+ v - t]) in the cached
        # eigenbasis; the floor zeroes null-space directions
        r = zbar - mbar - ubar
        xtr = mesh.all_reduce(x.T @ r, DATA_AXIS)
        rhs = xtr + (v - t) if has_l1 else xtr
        shift = l2 / rho + (1.0 if has_l1 else 0.0)
        p = q_eig.T @ w
        q2 = q_eig.T @ rhs
        denom = lam + shift
        coef = torch.where(denom > floor,
                           (lam * p + q2) / torch.clamp(denom, min=floor),
                           torch.zeros_like(denom))
        w = q_eig @ coef
        v_old = v
        if has_l1:
            v = _soft_threshold(w + t, l1 / rho)
            t = t + w - v
        else:
            v = w
        # consensus: the one feature-axis vector reduction
        mbar = margin_mean(w)
        zbar_old = zbar
        zbar = z_prox(zbar, mbar + ubar, rho)
        ubar = ubar + mbar - zbar
        s = scalar_sums(mbar, zbar, zbar_old, ubar, w, v, v_old)
        prim2 = F * s[_Sums.PRIM_ROWS]
        dual2 = (rho * F) ** 2 * s[_Sums.DUAL_ROWS]
        if has_l1:
            prim2 += s[_Sums.PRIM_COEF]
            dual2 += rho ** 2 * s[_Sums.DUAL_COEF]
        prim, dual = math.sqrt(prim2), math.sqrt(dual2)
        prim_scale = math.sqrt(max(F * s[_Sums.MBAR2],
                                   F * s[_Sums.ZBAR2])) + 1.0
        dual_scale = rho * F * math.sqrt(s[_Sums.UBAR2]) + 1.0
        value = objective(s)
        loss_history[k + 1], gnorm_history[k + 1] = value, prim
        if cfg.adapt_rho:
            new_rho = rho
            if prim > cfg.rho_mu * dual:
                new_rho = min(rho * cfg.rho_tau, RHO_MAX)
            elif dual > cfg.rho_mu * prim:
                new_rho = max(rho / cfg.rho_tau, RHO_MIN)
            scale = rho / new_rho
            ubar, t, rho = ubar * scale, t * scale, new_rho
        k += 1

    converged = prim <= tol * prim_scale and dual <= tol * dual_scale
    sol = v if has_l1 else w
    full = sol.new_zeros((mesh.num_feature, sol.shape[0]))
    if coefs_here:
        full[mesh.feature_index] = sol
    full = mesh.all_reduce(full, WORLD_AXIS).reshape(-1)
    as_t = lambda a: torch.tensor(a, dtype=x.dtype, device=x.device)
    return SolveResult(
        x=full, value=as_t(value), gradient_norm=as_t(prim), iterations=k,
        reason=int(ConvergenceReason.FUNCTION_VALUES_CONVERGED if converged
                   else ConvergenceReason.MAX_ITERATIONS),
        loss_history=as_t(loss_history), gnorm_history=as_t(gnorm_history),
        fg_count=k + 1)
