"""Fixed-effect GLM training, on one device or data-parallel over a mesh
(port of photon_ml_tpu/parallel/fixed_effect.py).

One device: the solve is optim/config.py::solve, so on the card every
value+gradient pass of LBFGS/OWLQN is one launch of the hand-written fused
kernel for a dense X (ops/hopper_kernels.py), or kernels A and B for a
PaddedSparse (ops/sparse_kernels.py), with the residual scores as offsets.

On a mesh (parallel/mesh.py) every rank holds its row block, padded to a
data-axis multiple with zero features, label 0.5, offset 0 and weight 0
(a padded row's loss is finite and weighs nothing, so no row mask is
added: every rank runs the kernel path of one device, and a rank whose
block has no padding takes no weights it did not have), and staged once
per coordinate through the mesh residency layer.  Each pass runs the same kernels on the rank's rows,
then ONE data-axis all_reduce of (value, gradient) packed in one vector;
the L2 term enters after the sum, once.  Every rank then steps the same
host-stepped solver on the same reduced values, so the iterates are equal
on every rank.  A sparse shard carries its own column view, built from its
own rows, so kernel B stays on the path (the JAX package drops the column
view on a mesh: a row-interleaved stream cannot shard over rows).

The consensus-ADMM lane (optim/admm.py) column-shards a dense design over
the mesh's feature axis as well: `fit_fixed_effect_admm`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.admm import (
    ADMMConfig, ADMMOperands, admm_solve, gram_eig,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, solve,
)
from photon_ml_tpu_torch.optim.types import SolveResult
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS, FEATURE_AXIS, pad_and_shard_rows,
)


def _residency(residency):
    from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
    return residency if residency is not None else default_residency()


def data_reducer(mesh):
    """The objective's `reduce`: one data-axis all_reduce (sum)."""
    return lambda t: mesh.all_reduce(t, DATA_AXIS)


_BF16_ADMM = ("the consensus-ADMM lane takes no bf16 design: its per-shard Gram "
              "eigendecomposition has no bfloat16 kernel in the JAX package "
              "(photon_ml_tpu/parallel/fixed_effect.py:243, jnp.linalg.eigh in "
              "_cached_gram_eig: 'Unsupported dtype bfloat16'); train a bf16 X "
              "on the monolithic lane or widen it first")


def _refuse_bf16(x) -> None:
    if getattr(x, "dtype", None) == torch.bfloat16:
        raise NotImplementedError(_BF16_ADMM)


def _staged_weights(res, key, mesh, objective, dtype):
    """The rank's row weights, 0 on padded rows: the objective's, else
    ones over real rows when the block has padding, else None."""
    n = objective.labels.shape[0]
    if objective.weights is not None:
        return res.stage_static(key, "weights", mesh, objective.weights, 0.0,
                                dtype=dtype)
    if mesh.block(n)[1] <= n:
        return None
    return res.stage_static(key, "weights", mesh, objective.labels, 0.0,
                            dtype=dtype, build=lambda: np.ones(n))


def stage_objective(objective: GLMObjective, mesh, key, dtype,
                    residency=None) -> GLMObjective:
    """This rank's objective: its row blocks of the static arrays (design
    matrix, labels, weights, mask; the normalization context is [d] and
    stays as given), staged ONCE per
    coordinate under `key`, the residual offsets staged per visit (warm),
    and `reduce` summing its data terms over the data axis.  A bf16 design
    matrix stays bf16 (each rank's passes run the kernels on it); the
    other arrays take `dtype`."""
    res = _residency(residency)
    _, (x_dev,) = pad_and_shard_rows(mesh, objective.x, residency_key=key,
                                     dtype=dtype, residency=res)
    return objective.replace(
        x=x_dev,
        labels=res.stage_static(key, "labels", mesh, objective.labels, 0.5,
                                dtype=dtype),
        weights=_staged_weights(res, key, mesh, objective, dtype),
        mask=res.stage_static(key, "mask", mesh, objective.mask, 0.0,
                              dtype=dtype),
        offsets=res.stage_update(mesh, objective.offsets, 0.0, dtype=dtype,
                                 key=key, field="offsets"),
        reduce=data_reducer(mesh))


def fit_fixed_effect(
    objective: GLMObjective,
    x0: torch.Tensor,
    mesh=None,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
    budget=None,
    residency_key=None,
) -> SolveResult:
    """One fixed-effect solve; `budget` (optim/schedule.py SolveBudget)
    caps it and x0 is not written.  With a mesh, this rank's blocks of the
    objective stage through the residency layer under `residency_key`
    (the coordinate's key; None stages under an anonymous key), x0 is
    staged warm, and the solve runs data-parallel in x0's dtype."""
    if mesh is None:
        return solve(objective, x0, config, reg, reg_weight, budget=budget)
    key = residency_key if residency_key is not None else ("fe", "anon")
    obj = stage_objective(objective, mesh, key, x0.dtype)
    x0 = _residency(None).stage_update(mesh, x0, spec="replicated",
                                       dtype=x0.dtype, key=key, field="x0")
    return solve(obj, x0, config, reg, reg_weight, budget=budget)


def score_fixed_effect(model: GeneralizedLinearModel, x: fops.FeatureMatrix,
                       mesh=None, offsets: Optional[torch.Tensor] = None,
                       residency_key=None) -> torch.Tensor:
    """Margins x.w (+ offsets).  On a mesh each rank scores its staged row
    block and the [n] margins are assembled on every rank by one
    data-axis all_reduce."""
    w = model.coefficients.means
    if mesh is None:
        z = fops.matvec(x, w)
    else:
        key = residency_key if residency_key is not None else ("fe", "anon")
        n, (x_dev,) = pad_and_shard_rows(mesh, x, residency_key=key,
                                         dtype=w.dtype)
        z = mesh.assemble(fops.matvec(x_dev, w), n)
    return z if offsets is None else z + offsets


# -- consensus-ADMM lane: column-sharded staging + fit -------------------------

def _column_block(x, j: int, block_width: int):
    """Columns [j*d_F, (j+1)*d_F) of a dense [n, d] design, zero-padded to
    d_F (a view when no padding is needed)."""
    lo = j * block_width
    cols = x[:, lo: lo + block_width]
    if cols.shape[1] == block_width:
        return cols
    out = np.zeros((x.shape[0], block_width), dtype=np.asarray(cols).dtype) \
        if isinstance(x, np.ndarray) else cols.new_zeros((x.shape[0], block_width))
    out[:, : cols.shape[1]] = cols
    return out


def _fold_x0(x0, num_feature: int, block_width: int):
    """[d] warm start -> [F, d_F] shard grid (zero-padded tail); a [d]
    solution comes back as grid.reshape(-1)[:d]."""
    d = x0.shape[0]
    d_pad = num_feature * block_width
    if isinstance(x0, np.ndarray):
        out = np.zeros(d_pad, x0.dtype)
        out[:d] = x0
        return out.reshape(num_feature, block_width)
    out = x0.new_zeros(d_pad)
    out[:d] = x0
    return out.reshape(num_feature, block_width)


def stage_admm_grid(key, mesh, x, dtype, residency=None):
    """This rank's memoized block X_ij of the column-block grid (field
    "x_grid"): its padded row block of column block j.  Returns (n, d,
    block_width, block)."""
    _refuse_bf16(x)
    n, d = x.shape
    block_width = -(-d // mesh.num_feature)
    block = _residency(residency).stage_static(
        key, "x_grid", mesh, x, 0.0, dtype=dtype,
        build=lambda: _column_block(x, mesh.feature_index, block_width))
    return n, d, block_width, block


def fit_fixed_effect_admm(
    objective: GLMObjective,
    x0: torch.Tensor,
    mesh,
    admm_config: ADMMConfig = ADMMConfig(),
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight=0.0,
    budget=None,
    polish_budget=None,
    polish: Optional[bool] = None,
    residency_key=None,
) -> SolveResult:
    """One feature-sharded fixed-effect solve on the consensus-ADMM lane:
    rank (i, j) holds X_ij, its Gram eigendecomposition stays with it, and
    each iteration costs one feature-axis [n_local] all_reduce and one
    data-axis [d_F] all_reduce (plus one packed scalar sum).

    Needs a dense 2-D design, no normalization and no box or named
    constraints.  `polish` (default: the config's flag) runs the strict
    monolithic solver once afterwards, warm-started from the consensus
    solution, under `polish_budget`."""
    if not isinstance(objective.x, (np.ndarray, torch.Tensor)) \
            or np.ndim(objective.x) != 2:
        raise ValueError(
            "the ADMM lane needs a dense 2-D design block; sparse / "
            "structured FeatureMatrix coordinates use the monolithic lane")
    if objective.norm is not None:
        raise ValueError(
            "the ADMM lane does not compose with normalization contexts "
            "(per-shard Gram caching assumes raw columns); normalize the "
            "data or use the monolithic lane")
    if config.box_lower is not None or config.box_upper is not None \
            or config.constraints is not None:
        raise ValueError("box/named constraints are a monolithic-lane "
                         "feature; the ADMM lane does not project")
    from photon_ml_tpu_torch.optim.schedule import RegWeights
    dtype = x0.dtype
    key = residency_key if residency_key is not None else ("admm", "anon")
    res = _residency(None)
    n, d, block_width, x_block = stage_admm_grid(key, mesh, objective.x,
                                                 dtype, res)
    q_eig, lam_eig, lam_max = res.stage_derived(
        key, "gram_eig", mesh, x_block, lambda: gram_eig(mesh, x_block))
    labels = res.stage_static(key, "labels", mesh, objective.labels, 0.5,
                              dtype=dtype)
    weights = _staged_weights(res, key, mesh, objective, dtype)
    mask = res.stage_static(key, "mask", mesh, objective.mask, 0.0, dtype=dtype)
    kappa = torch.ones_like(labels) if weights is None else weights
    if mask is not None:
        kappa = kappa * mask
    offsets = res.stage_update(mesh, objective.offsets, 0.0, dtype=dtype,
                               key=key, field="offsets")
    w0 = res.stage_update(mesh, _fold_x0(x0, mesh.num_feature, block_width),
                          spec="feature", dtype=dtype, key=key, field="x0")
    if isinstance(reg_weight, RegWeights):
        l1_w, l2_w = reg_weight.l1_weight, reg_weight.l2_weight
    else:
        l1_w, l2_w = reg.split(reg_weight)
    ops = ADMMOperands(x=x_block, q_eig=q_eig, lam_eig=lam_eig,
                       lam_max=lam_max, labels=labels, kappa=kappa,
                       offsets=offsets, l1_weight=float(l1_w),
                       l2_weight=float(l2_w))
    result = admm_solve(objective.loss, reg.has_l1, ops, w0, admm_config,
                        mesh, budget=budget)
    result.x = result.x[:d]
    do_polish = admm_config.polish if polish is None else polish
    if do_polish:
        admm_iterations = result.iterations
        result = fit_fixed_effect(objective, result.x, mesh, config, reg,
                                  reg_weight, budget=polish_budget,
                                  residency_key=residency_key)
        result.iterations += admm_iterations
    return result


def score_fixed_effect_admm(model: GeneralizedLinearModel, x, mesh,
                            offsets: Optional[torch.Tensor] = None,
                            residency_key=None) -> torch.Tensor:
    """Margins through the ADMM lane's staged grid blocks (scoring shares
    the cold "x_grid" entry the solver staged): each rank's X_ij w_j, one
    feature-axis all_reduce for its row block's margins, then the [n]
    assembled over the data axis."""
    means = model.coefficients.means
    key = residency_key if residency_key is not None else ("admm", "anon")
    n, _, block_width, x_block = stage_admm_grid(key, mesh, x, means.dtype)
    w = _fold_x0(means, mesh.num_feature, block_width)[mesh.feature_index]
    z = mesh.assemble(mesh.all_reduce(x_block @ w, FEATURE_AXIS), n)
    return z if offsets is None else z + offsets
