"""Factored random effects: per-entity latent factors x a shared projection
(port of photon_ml_tpu/parallel/factored.py, one device).

reference: FactoredRandomEffectCoordinate.updateModel's alternation
(photon-api/.../algorithm/FactoredRandomEffectCoordinate.scala:100-160):
per inner iteration, (a) refit the per-entity coefficients in the latent
space, (b) refit the shared latent projection matrix as one GLM over
kron(coefficients, features) rows.

Step (a) is the batched per-entity solve of parallel/random_effect.py on
blocks projected through P by one matrix product; step (b) never builds
the kron design: `KroneckerDesign` (ops/features.py) computes its products
from X and the per-row latent factors, and the solve is the single GLM
solve of optim/config.py.  The random draws (the Gaussian projection) come
from utils/prng.py's copy of JAX's threefry, so they are the JAX package's.

On a mesh (parallel/mesh.py) the entity lanes shard over "data" as in
parallel/random_effect.py: each rank solves its lanes' latent problems
(the latent table assembled by one all_reduce), and the Kronecker refit
is a data-parallel GLM over its lanes' rows, one data-axis all_reduce per
pass, so P comes out equal on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.ops.features import KroneckerDesign
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, solve,
)
from photon_ml_tpu_torch.optim.types import SolveResult
from photon_ml_tpu_torch.parallel.random_effect import (
    EntityBlocks, assemble_lanes, fit_random_effects, stage_entity_blocks,
)
from photon_ml_tpu_torch.telemetry.timings import clock
from photon_ml_tpu_torch.utils import prng


def gaussian_projection_matrix(
    latent_dim: int,
    original_dim: int,
    keep_intercept: bool = False,
    seed: int = 7,
    dtype: torch.dtype = torch.float32,
    draw_dtype: Optional[torch.dtype] = None,
    device=None,
) -> torch.Tensor:
    """[k(+1), d] Gaussian random projection, rows = projected dims, on
    `device` (None means cuda) in `dtype`.

    Entries ~ N(0, 1) / k, clipped to [-1, 1]: the reference uses std = k,
    not sqrt(k) (ProjectionMatrix.scala:95-125).  The draw is JAX's
    `jax.random.normal(PRNGKey(seed), (k, d))` in `draw_dtype` (default
    `dtype`): the JAX package draws in its default float, float64 under
    x64 and float32 without, and those are different numbers, not rounded
    copies.  With `keep_intercept`, one extra row selects the intercept
    column (the last, per the intercept-last convention)."""
    ddt = prng.float_dtype(draw_dtype or dtype)
    z = prng.normal(prng.PRNGKey(seed), (latent_dim, original_dim), ddt)
    p = np.clip(z / ddt.type(latent_dim), -1.0, 1.0).astype(prng.float_dtype(dtype))
    if keep_intercept:
        e_last = np.zeros((1, original_dim), p.dtype)
        e_last[0, original_dim - 1] = 1.0
        p = np.concatenate([p, e_last], axis=0)
    return torch.from_numpy(p).to(resolve_device(device))


def project_blocks(blocks: EntityBlocks, projection: torch.Tensor) -> EntityBlocks:
    """Features -> latent space: one [E, S, d] x [d, k] product (reference:
    ProjectionMatrixBroadcast.projectRandomEffectDataSet)."""
    x_lat = torch.matmul(blocks.x, projection.T)
    return dataclasses.replace(blocks, x=x_lat * blocks.mask[:, :, None])


def principal_subspace_projection(w: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Warm [k, d] latent projection from a sibling solution matrix: rows
    = the top-k right singular vectors of w (an [E, d] plain random-effect
    coefficient matrix), the directions per-entity effects actually vary
    in.  `fallback` (the Gaussian projection) fills rows beyond w's rank
    and rows whose singular value is not above 1e-7 * s[0] (all of them
    for an all-zero w).  Singular vectors are defined up to sign (and up
    to rotation where singular values coincide); the latent solve that
    follows starts from zero factors and is equivariant to both."""
    k = fallback.shape[0]
    _, s, vt = torch.linalg.svd(w, full_matrices=False)
    idx = torch.clamp(torch.arange(k, device=w.device), max=vt.shape[0] - 1)
    take = torch.arange(k, device=w.device) < min(k, vt.shape[0])
    top = torch.where(take[:, None], vt[idx], fallback)
    informative = (s[idx] > 1e-7 * torch.clamp(s[0], min=1e-30)) & take
    return torch.where(informative[:, None], top, fallback).to(fallback.dtype)


@dataclasses.dataclass
class FactoredSolveResult:
    latent_coefficients: torch.Tensor            # [E, k]
    projection: torch.Tensor                     # [k, d]
    random_effect_result: Optional[SolveResult]  # last inner iteration, [E]-leading
    latent_result: Optional[SolveResult]         # last inner iteration
    # per inner iteration, on the host: the latent-space solve's batched
    # rounds, largest and summed lane iteration counts and seconds, and the projection
    # refit's iterations, value+gradient passes and seconds (the port's
    # own record; the JAX package keeps none)
    inner: List[dict] = dataclasses.field(default_factory=list)


def refit_latent_projection(
    blocks: EntityBlocks,
    latent_coefficients: torch.Tensor,
    projection: torch.Tensor,
    loss: PointwiseLoss,
    mesh=None,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
    row_weights: Optional[torch.Tensor] = None,
    budget=None,
) -> Tuple[torch.Tensor, SolveResult]:
    """One projection-matrix refit: the blocks flattened to rows, flatten(P)
    the coefficient vector of a GLM over the implicit kron(c_e, x) design,
    warm-started from the current P.  `row_weights` multiply the rows'
    weights (the latent down-sampling); `budget` (optim/schedule.py
    SolveBudget) caps the solve.  reference:
    FactoredRandomEffectCoordinate.updateLatentProjectionMatrix.

    On a mesh, `blocks`, `latent_coefficients` and `row_weights` are this
    rank's lanes and their rows, and the solve sums its data terms over the
    data axis."""
    from photon_ml_tpu_torch.parallel.fixed_effect import data_reducer
    E, S, d = blocks.x.shape
    k = latent_coefficients.shape[1]
    n = E * S
    factors = torch.repeat_interleave(latent_coefficients, S, dim=0)   # [n, k]
    weights = None if blocks.weights is None else blocks.weights.reshape(n)
    if row_weights is not None:
        weights = row_weights if weights is None else weights * row_weights
    offsets = None if blocks.offsets is None else blocks.offsets.reshape(n)
    design = KroneckerDesign(blocks.x.reshape(n, d), factors)
    obj = GLMObjective(loss, design, blocks.labels.reshape(n), weights=weights,
                       offsets=offsets, mask=blocks.mask.reshape(n),
                       reduce=None if mesh is None else data_reducer(mesh))
    res = solve(obj, projection.reshape(-1), config, reg, reg_weight, budget=budget)
    return res.x.reshape(k, d), res


def fit_factored_random_effects(
    blocks: EntityBlocks,
    loss: PointwiseLoss,
    mesh=None,
    *,
    latent_coefficients: torch.Tensor,
    projection: torch.Tensor,
    num_inner_iterations: int = 1,
    re_config: OptimizerConfig = OptimizerConfig(),
    re_reg: RegularizationContext = RegularizationContext(),
    re_reg_weight: float = 0.0,
    latent_config: OptimizerConfig = OptimizerConfig(),
    latent_reg: RegularizationContext = RegularizationContext(),
    latent_reg_weight: float = 0.0,
    latent_row_weights_fn: Optional[Callable[[int], Optional[torch.Tensor]]] = None,
    re_budget=None,
    latent_budget=None,
    cache_key=None,
) -> FactoredSolveResult:
    """The alternation (reference: FactoredRandomEffectCoordinate
    .updateModel): `num_inner_iterations` rounds of the per-entity latent
    solve, then the projection refit.  `latent_row_weights_fn(iteration)`
    supplies the refit's per-row sampling weights (a fresh draw per inner
    iteration, as runWithSampling).  `re_budget`/`latent_budget`
    (optim/schedule.py SolveBudget) cap every round's latent-space and
    projection solves.

    On a mesh the blocks' lanes stage per rank under `cache_key`; the
    returned latent coefficients and result are the full [E]-leading ones
    on every rank."""
    C, P = latent_coefficients, projection
    E = blocks.x.shape[0]
    lanes = lambda a: a
    if mesh is not None:
        from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
        key = cache_key if cache_key is not None else ("factored", "anon")
        blocks = stage_entity_blocks(blocks, mesh, key, P.dtype)
        lanes = lambda a: default_residency().stage_update(
            mesh, a, 0.0, dtype=P.dtype, key=key, field="lanes")
    C_local = lanes(C)
    re_res = lat_res = None
    inner: List[dict] = []
    for it in range(num_inner_iterations):
        t0 = clock()
        re_res = fit_random_effects(project_blocks(blocks, P), loss, None,
                                    x0=C_local, config=re_config, reg=re_reg,
                                    reg_weight=re_reg_weight, budget=re_budget)
        C_local = re_res.x
        if mesh is not None:
            re_res = assemble_lanes(mesh, re_res, E)
        C = re_res.x
        t1 = clock()
        rw = latent_row_weights_fn(it) if latent_row_weights_fn else None
        if rw is not None and mesh is not None:
            rw = lanes(rw.reshape(E, -1)).reshape(-1)
        P, lat_res = refit_latent_projection(blocks, C_local, P, loss, mesh, latent_config,
                                             latent_reg, latent_reg_weight, row_weights=rw,
                                             budget=latent_budget)
        inner.append({"re_rounds": re_res.rounds,
                      "re_max_iterations": int(re_res.iterations.max()),
                      "re_total_iterations": int(re_res.iterations.sum()),
                      "re_seconds": t1 - t0,
                      "latent_iterations": lat_res.iterations,
                      "latent_fg_count": lat_res.fg_count,
                      "latent_hv_count": lat_res.hv_count,
                      "latent_seconds": clock() - t1})
    return FactoredSolveResult(latent_coefficients=C, projection=P,
                               random_effect_result=re_res, latent_result=lat_res,
                               inner=inner)
