"""Stochastic per-chunk coordinate descent for streamed GLM fits (port of
photon_ml_tpu/optim/stochastic.py).

The host-stepped solvers (optim/streaming.py) re-stage every chunk of an
out-of-core objective on every oracle call, so one gradient evaluation
costs one full pass of staging bandwidth.  This lane does a full epoch of
stochastic local updates on each resident chunk before it is evicted
(Snap ML, arXiv:1803.06333; TPA-SCD, arXiv:1702.07005), so useful work per
staged byte goes up by the local epoch count:

  * `_local_epochs`: primal stochastic coordinate descent over the resident
    chunk, `epochs` epochs, each a seeded permutation of the coordinates.
    Each coordinate step is a closed-form 1-D majorized Newton update
    (losses with a global curvature bound, `PointwiseLoss.d2z_bound`, can
    never overshoot; Poisson uses current-point curvature with a step
    clip), and the chunk's margins are updated incrementally.  In the JAX
    package this is one XLA program (fori_loops); here it is torch ops
    over device tensors, with the coordinate indices read from the
    uploaded [epochs, d] permutation tensor, so the epochs run without a
    host sync.  A hand kernel for it (one persistent launch per chunk) is
    ROADMAP.md queue B's candidate.
  * `solve_stochastic`: `passes` full passes over the chunk stream
    (ops/chunked.py stages each chunk once per pass and pins it for the
    local epochs), returning a SolveResult whose loss history is the
    per-pass streaming objective.

Determinism: the per-(chunk, epoch) permutation key is PRNGKey(seed) folded
with (pass, chunk, epoch) in turn, JAX's permutations bit for bit
(utils/prng.py), so a given (plan, seed) replays the JAX package's order.
"""
from __future__ import annotations

# photonlint: disable-file=PH001 -- host-stepped BY DESIGN: like
# optim/streaming.py, the pass driver reads back exactly one scalar (the
# per-pass streaming objective) per full pass over the chunk stream

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.optim.schedule import StochasticPlan
from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult

#: curvature floor: a zero column (or an all-padding chunk) must yield a
#: zero step, not an inf one
_H_FLOOR = 1e-12
# rows per block of the curvature pre-pass: x*x is formed a block at a
# time, never for the whole chunk
_SQ_BLOCK_ROWS = 16384


def _column_sq_sums(x: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """sum_i mw_i x_ij^2 for every column j, in the promoted dtype of x and
    mw; x * x is formed in x's dtype first (a bf16 square rounds to bf16),
    as the JAX package's mw @ (x * x) forms it."""
    dt = torch.promote_types(x.dtype, mw.dtype)
    out = torch.zeros(x.shape[1], dtype=dt, device=x.device)
    for r in range(0, x.shape[0], _SQ_BLOCK_ROWS):
        xb = x[r:r + _SQ_BLOCK_ROWS]
        out += torch.mv((xb * xb).to(dt).T, mw[r:r + _SQ_BLOCK_ROWS])
    return out


def _local_epochs(c, x, labels, weights, offsets, mask, norm, perms,
                  l2_local, step_clip: float, *, loss, reduce=None):
    """`perms.shape[0]` epochs of stochastic coordinate descent on ONE
    resident chunk; `perms` [epochs, d] holds each epoch's coordinate order
    on the device.

    Minimizes the chunk's local subproblem
        sum_i mask*w * loss(z_i, y_i) + 0.5 * l2_local * ||c||^2
    in the solver's (normalized) coefficient space: with normalization
    factors f / shifts s the margin is z = x.(c*f) - (c*f).s + offset, so
    coordinate j's column is f_j * (x_j - s_j) (never materialized for the
    chunk).  Returns (updated c, the chunk's ENTRY data loss); `c` is not
    written.

    On a mesh `x` is the rank's row block of the chunk and `reduce` sums
    over the data axis, where GSPMD puts its psums in the JAX program: the
    entry loss and the column sums (xsq, xs, msum) in one all_reduce per
    chunk, then each coordinate step's gradient (with the Poisson
    curvature: 2 elements) in one all_reduce, so d * epochs + 1
    collectives per chunk.  The L2 terms enter after the sums.  None is
    the one-device path."""
    dtype = c.dtype
    d = c.shape[0]
    mw = mask if weights is None else mask * weights
    has_f = norm is not None and norm.factors is not None
    has_s = norm is not None and norm.shifts is not None
    fv = norm.factors.to(dtype) if has_f else torch.ones(d, dtype=dtype, device=c.device)
    sv = norm.shifts.to(dtype) if has_s else torch.zeros(d, dtype=dtype, device=c.device)
    base = (torch.zeros(x.shape[0], dtype=dtype, device=c.device)
            if offsets is None else offsets)
    e = c * fv
    # a bf16 chunk's products promote as JAX's x @ e (features._mv, _rmv)
    z = fops._mv(x, e) - torch.dot(e, sv) + base
    entry = torch.dot(mw, loss.loss(z, labels))

    bound = loss.d2z_bound
    if bound is not None:
        # majorized per-coordinate curvature, constant across the epochs:
        # sum_i mw * (f_j (x_ij - s_j))^2 for every j in one pass
        xsq = _column_sq_sums(x, mw)
        xs = fops._rmv(x, mw)
        msum = torch.sum(mw)
        if reduce is not None:
            sums = reduce(torch.cat([entry.reshape(1), xsq, xs,
                                     msum.reshape(1)]))
            entry, msum = sums[0], sums[-1]
            xsq, xs = sums[1:d + 1], sums[d + 1:2 * d + 1]
    elif reduce is not None:
        entry = reduce(entry.reshape(1))[0]
    if bound is not None:
        colsq = fv * fv * (xsq - 2.0 * sv * xs + sv * sv * msum)
        h = bound * colsq + l2_local
    floor = torch.tensor(_H_FLOOR, dtype=dtype, device=c.device)
    # -max(h, floor) per step, made once per chunk: the step is then one
    # division, bit-equal to -g / max(h, floor)
    neg_h_perm = None if bound is None else -torch.maximum(h, floor)[perms]
    f_perm = fv[perms] if has_f else None
    s_perm = sv[perms] if has_s else None
    c = c.clone()
    for ei in range(perms.shape[0]):
        for t in range(d):
            j = perms[ei, t:t + 1]
            colj = x.index_select(1, j).squeeze(1).to(dtype)
            if has_s:
                colj = colj - s_perm[ei, t]
            if has_f:
                colj = colj * f_perm[ei, t]
            dl = mw * loss.dz(z, labels)
            gd = torch.dot(colj, dl).reshape(1)
            if bound is not None:
                if reduce is not None:
                    gd = reduce(gd)
                delta = (gd + l2_local * c.index_select(0, j)) / neg_h_perm[ei, t]
            else:
                hd = torch.dot(mw * loss.d2z(z, labels), colj * colj).reshape(1)
                if reduce is not None:
                    gh = reduce(torch.cat([gd, hd]))
                    gd, hd = gh[:1], gh[1:]
                gj = gd + l2_local * c.index_select(0, j)
                delta = -gj / torch.maximum(hd + l2_local, floor)
            if step_clip != float("inf"):
                delta = torch.clamp(delta, -step_clip, step_clip)
            c.index_add_(0, j, delta)
            z.addcmul_(colj, delta)
    return c, entry


def resolve_step_clip(loss, step_clip: Optional[float]) -> float:
    """Explicit clip wins; otherwise bounded-curvature losses run
    unclipped (the majorized step cannot overshoot) and unbounded ones
    (Poisson) default to 1.0."""
    if step_clip is not None:
        return float(step_clip)
    return float("inf") if loss.d2z_bound is not None else 1.0


def solve_stochastic(objective, x0: torch.Tensor, plan: StochasticPlan,
                     max_iterations: Optional[int] = None) -> SolveResult:
    """Run `plan.passes` stochastic passes over a ChunkedGLMObjective's
    chunk stream (each chunk staged once per pass and pinned for
    `plan.local_epochs` local epochs).  `objective.l2_weight` must already
    carry the L2 term (solve_streamed's with_l2 dispatch does this).

    `loss_history[p]` is the streaming objective ENTERING pass p: the sum
    of each chunk's data loss at the model that chunk started from, plus
    the L2 term at the pass-entry model (one read-back per pass).  `value`
    repeats the last entry; the strict polish lane reports exact values."""
    x = x0
    dtype = x.dtype
    losses = []
    for p in range(plan.passes):
        x, entry = objective.stochastic_pass(
            x, local_epochs=plan.local_epochs, seed=plan.seed,
            pass_index=p, merge=plan.merge, step_clip=plan.step_clip)
        losses.append(float(entry))
    hist_len = (max_iterations if max_iterations is not None
                else max(plan.passes, 1)) + 1
    hist = np.full((hist_len,), np.nan)
    hist[:len(losses)] = losses
    value = losses[-1] if losses else float("nan")
    as_t = lambda a: torch.as_tensor(a, device=x.device).to(dtype)
    return SolveResult(
        x=x, value=as_t(value), gradient_norm=as_t(float("nan")),
        iterations=plan.passes, reason=int(ConvergenceReason.MAX_ITERATIONS),
        loss_history=as_t(hist),
        gnorm_history=as_t(np.full((hist_len,), np.nan)),
        coefficient_history=None, fg_count=plan.passes)
