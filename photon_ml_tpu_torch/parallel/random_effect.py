"""Random-effect training: batched per-entity solves (port of
photon_ml_tpu/parallel/random_effect.py, single device).

Entities are grouped at data-prep time into padded dense blocks
  x[E, S, d], labels[E, S], mask[E, S]
and every per-entity LBFGS/OWLQN/TRON solve of a block runs at once, lane
by lane, in the host-stepped batched solver (optim/batched.py).  Masked rows
contribute nothing (where(), not a product).  d is the per-entity projected
dimension (the index-map projector gathers each entity's observed features
into a dense local space).

On a mesh (parallel/mesh.py) the entity lanes shard over "data": a block's
lanes pad to a data-axis multiple with all-masked lanes, each rank stages
its own lanes once per coordinate (the mesh residency layer; offsets and
x0 per visit) and solves them in one batched solve, and the [E]-leading
results are assembled on every rank by ONE data-axis all_reduce of a
zero-filled table in which each rank wrote its lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optim import batched
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext,
)
from photon_ml_tpu_torch.optim.types import SolveResult


@dataclasses.dataclass
class EntityBlocks:
    """Padded per-entity batches.  `entity_mask` marks real (vs padding)
    entities; the mask counts real rows.  Entity ids live host-side in the
    data layer's RandomEffectDataset."""

    x: torch.Tensor                           # [E, S, d]
    labels: torch.Tensor                      # [E, S]
    mask: torch.Tensor                        # [E, S] 1.0 = real row
    weights: Optional[torch.Tensor] = None    # [E, S]
    offsets: Optional[torch.Tensor] = None    # [E, S]

    @property
    def num_entities(self) -> int:
        return self.x.shape[0]

    @property
    def samples_per_entity(self) -> int:
        return self.x.shape[1]

    @property
    def dim(self) -> int:
        return self.x.shape[2]

    @property
    def entity_mask(self) -> torch.Tensor:
        return (self.mask.sum(dim=1) > 0).to(self.x.dtype)

    def with_offsets(self, offsets: torch.Tensor) -> "EntityBlocks":
        """Residual exchange for coordinate descent: a tensor assignment."""
        return dataclasses.replace(self, offsets=offsets)


def _masked(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # where() not multiply: a non-finite loss on a padded row must not
    # poison the aggregate (inf * 0 == nan)
    return torch.where(mask != 0, v, torch.zeros_like(v))


def batched_value_and_gradient(
    loss: PointwiseLoss, blocks: EntityBlocks, coefficients: torch.Tensor,
    l2_weight=0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane's masked GLM objective at once: ([E] values, [E, d]
    gradients) of sum_s mask*w*l(z, y) + l2/2 |c|^2, z = x.c + offset."""
    z = torch.einsum("esd,ed->es", blocks.x, coefficients)
    if blocks.offsets is not None:
        z = z + blocks.offsets
    l, dl = loss.loss_and_dz(z, blocks.labels)
    if blocks.weights is not None:
        l = l * blocks.weights
        dl = dl * blocks.weights
    l, dl = _masked(l, blocks.mask), _masked(dl, blocks.mask)
    value = l.sum(dim=1) + 0.5 * l2_weight * (coefficients * coefficients).sum(dim=1)
    grad = torch.einsum("es,esd->ed", dl, blocks.x) + l2_weight * coefficients
    return value, grad


def batched_hessian_vector_at(
    loss: PointwiseLoss, blocks: EntityBlocks, coefficients: torch.Tensor,
    l2_weight=0.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """v [E, d] -> every lane's masked Hv [E, d] at `coefficients`: the
    margins and l'' are computed here, once, for every v."""
    z = torch.einsum("esd,ed->es", blocks.x, coefficients)
    if blocks.offsets is not None:
        z = z + blocks.offsets
    d2 = loss.d2z(z, blocks.labels)

    def hv(v: torch.Tensor) -> torch.Tensor:
        t = d2 * torch.einsum("esd,ed->es", blocks.x, v)
        if blocks.weights is not None:
            t = t * blocks.weights
        t = _masked(t, blocks.mask)
        return torch.einsum("es,esd->ed", t, blocks.x) + l2_weight * v

    return hv


def batched_hessian_vector(
    loss: PointwiseLoss, blocks: EntityBlocks, coefficients: torch.Tensor,
    v: torch.Tensor, l2_weight=0.0,
) -> torch.Tensor:
    """Every lane's Hv [E, d] of the masked GLM objective with its L2
    term: sum_s mask*w*l''(z)*(x.v)*x + l2*v."""
    return batched_hessian_vector_at(loss, blocks, coefficients, l2_weight)(v)


def lanes_value_and_gradient(
    loss: PointwiseLoss, blocks: EntityBlocks, offsets: torch.Tensor,
    coefficients: torch.Tensor, l2_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K candidates' per-entity objectives over one bucket at once: the
    algebra of batched_value_and_gradient with the blocks [E, S, d] shared
    by the K candidates (one batched product against [E, d, K] reads them
    once), per-candidate residual offsets [K, E, S] and L2 weights [K].
    Lanes are candidate-major: coefficients [K * E, d] -> ([K * E] values,
    [K * E, d] gradients)."""
    K = offsets.shape[0]
    E, _, d = blocks.x.shape
    c = coefficients.reshape(K, E, d)
    z = torch.bmm(blocks.x, c.permute(1, 2, 0)) + offsets.permute(1, 2, 0)  # [E, S, K]
    l, dl = loss.loss_and_dz(z, blocks.labels[..., None])
    if blocks.weights is not None:
        l = l * blocks.weights[..., None]
        dl = dl * blocks.weights[..., None]
    mask = blocks.mask[..., None]
    l, dl = _masked(l, mask), _masked(dl, mask)
    value = l.sum(dim=1).T + 0.5 * l2_weights[:, None] * (c * c).sum(-1)     # [K, E]
    grad = (torch.bmm(blocks.x.transpose(1, 2), dl).permute(2, 0, 1)
            + l2_weights[:, None, None] * c)                                # [K, E, d]
    return value.reshape(K * E), grad.reshape(K * E, d)


def lanes_hessian_vector_at(
    loss: PointwiseLoss, blocks: EntityBlocks, offsets: torch.Tensor,
    coefficients: torch.Tensor, l2_weights: torch.Tensor,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """V [K * E, d] -> every candidate lane's masked Hv at `coefficients`,
    with its L2 term, the blocks shared as in lanes_value_and_gradient."""
    K = offsets.shape[0]
    E, _, d = blocks.x.shape
    c = coefficients.reshape(K, E, d)
    z = torch.bmm(blocks.x, c.permute(1, 2, 0)) + offsets.permute(1, 2, 0)
    d2 = loss.d2z(z, blocks.labels[..., None])
    mask = blocks.mask[..., None]

    def hv(v: torch.Tensor) -> torch.Tensor:
        vk = v.reshape(K, E, d)
        t = d2 * torch.bmm(blocks.x, vk.permute(1, 2, 0))
        if blocks.weights is not None:
            t = t * blocks.weights[..., None]
        t = _masked(t, mask)
        out = (torch.bmm(blocks.x.transpose(1, 2), t).permute(2, 0, 1)
               + l2_weights[:, None, None] * vk)
        return out.reshape(K * E, d)

    return hv


def stage_entity_blocks(blocks: EntityBlocks, mesh, key, dtype,
                        residency=None) -> EntityBlocks:
    """This rank's lanes of `blocks` (host numpy or device leaves), padded
    with all-masked lanes (label 0.5): the static leaves staged once under
    `key` (anchored on each leaf's identity), the offsets per visit."""
    from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
    res = residency if residency is not None else default_residency()
    static = lambda field, a, fill: res.stage_static(key, field, mesh, a, fill,
                                                     dtype=dtype)
    return EntityBlocks(
        x=static("x", blocks.x, 0.0), labels=static("labels", blocks.labels, 0.5),
        mask=static("mask", blocks.mask, 0.0),
        weights=static("weights", blocks.weights, 0.0),
        offsets=res.stage_update(mesh, blocks.offsets, 0.0, dtype=dtype,
                                 key=key, field="offsets"))


def assemble_lanes(mesh, result: SolveResult, num_entities: int) -> SolveResult:
    """Every rank's [E_local]-leading result fields -> the [E]-leading
    result on every rank, by ONE data-axis all_reduce of a zero-filled
    float64 table (exact for every field's dtype) in which each rank wrote
    its lanes.  Host counts (rounds, read-backs) stay this rank's."""
    fields = [f.name for f in dataclasses.fields(SolveResult)
              if isinstance(getattr(result, f.name), torch.Tensor)]
    parts = [getattr(result, f) for f in fields]
    e_local = parts[0].shape[0]
    flat = [p.reshape(e_local, -1) for p in parts]
    table = mesh.assemble(torch.cat([p.to(torch.float64) for p in flat], dim=1),
                          num_entities)
    out = dataclasses.replace(result)
    col = 0
    for f, p, fl in zip(fields, parts, flat):
        w = fl.shape[1]
        setattr(out, f, table[:, col: col + w].to(p.dtype).reshape(
            (num_entities,) + tuple(p.shape[1:])))
        col += w
    return out


def fit_random_effects(
    blocks: EntityBlocks,
    loss: PointwiseLoss,
    mesh=None,
    x0: Optional[torch.Tensor] = None,
    config: OptimizerConfig = OptimizerConfig(),
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
    budget=None,
    cache_key=None,
) -> SolveResult:
    """All per-entity solves of one block as one batched solve.  Returns a
    SolveResult whose fields have a leading [E] axis (x: [E, d], value:
    [E], ...).  One lambda and one `budget` (optim/schedule.py
    SolveBudget) are shared by every entity.  x0 is not written.

    On a mesh, this rank's lanes stage under `cache_key` (the
    coordinate's key and bucket), solve in x0's dtype and are assembled
    with the other ranks' into the full result on every rank."""
    if mesh is not None:
        E = blocks.x.shape[0]
        dtype = x0.dtype
        key = cache_key if cache_key is not None else ("re", "anon")
        local = stage_entity_blocks(blocks, mesh, key, dtype)
        from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
        x0_local = default_residency().stage_update(
            mesh, x0, 0.0, dtype=dtype, key=key, field="x0")
        res = fit_random_effects(local, loss, None, x0_local, config, reg,
                                 reg_weight, budget)
        return assemble_lanes(mesh, res, E)
    E, _, d = blocks.x.shape
    if x0 is None:
        x0 = torch.zeros((E, d), dtype=blocks.x.dtype, device=blocks.x.device)
    _, l2_w = reg.split(reg_weight)
    return batched.solve(
        lambda c: batched_value_and_gradient(loss, blocks, c, l2_w),
        x0, config, reg, reg_weight, loss=loss,
        hessian_vector_at=lambda c: batched_hessian_vector_at(loss, blocks, c, l2_w),
        budget=budget)


def scatter_local_to_global(coefficients: torch.Tensor, projection,
                            global_dim: int) -> torch.Tensor:
    """[E, d_local] local-space coefficients -> [E, d_global] by scattering
    along each entity's projection columns (-1 = padding)."""
    if projection is None:
        return coefficients
    proj = torch.as_tensor(projection, device=coefficients.device)
    cols = torch.clamp(proj, min=0).to(torch.int64)
    vals = torch.where(proj >= 0, coefficients, torch.zeros_like(coefficients))
    out = torch.zeros((coefficients.shape[0], global_dim),
                      dtype=coefficients.dtype, device=coefficients.device)
    return out.scatter_add_(1, cols, vals)


def score_entity_blocks(coefficients: torch.Tensor, blocks: EntityBlocks) -> torch.Tensor:
    """Margins for every (entity, sample) cell: [E, S].  Masked cells
    score 0."""
    scores = torch.einsum("esd,ed->es", blocks.x, coefficients)
    if blocks.offsets is not None:
        scores = scores + blocks.offsets
    return scores * blocks.mask


def score_by_entity(coefficients: torch.Tensor, x: torch.Tensor,
                    entity_index: torch.Tensor) -> torch.Tensor:
    """Score flat rows against their entity's model: one gather + row dot.
    Rows with entity_index -1 (unseen entity) score 0, the missing-score
    default."""
    num_entities = coefficients.shape[0]
    if num_entities == 0:
        # empty coefficient table: every row is unseen and scores 0
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    in_range = (entity_index >= 0) & (entity_index < num_entities)
    safe_idx = torch.clamp(entity_index, 0, num_entities - 1)
    s = (x * coefficients[safe_idx]).sum(dim=-1)
    return torch.where(in_range, s, torch.zeros_like(s))


def score_entities_scatter(coefficients, projection, x, lanes, *,
                           global_dim: int) -> torch.Tensor:
    """Index-map-projected per-entity scoring: scatter to global space,
    then entity gather + row dot."""
    g = scatter_local_to_global(coefficients, projection, global_dim)
    return score_by_entity(g, x, lanes)


def score_entities_matmul(coefficients, projection_matrix, x, lanes) -> torch.Tensor:
    """Dense-projection scoring (random-projection and factored latent
    models): [E, k] @ [k, d], then entity gather + row dot."""
    return score_by_entity(coefficients @ projection_matrix, x, lanes)


def score_entities_plain(coefficients, x, lanes) -> torch.Tensor:
    return score_by_entity(coefficients, x, lanes)


def random_effect_variances(
    blocks: EntityBlocks, loss: PointwiseLoss, coefficients: torch.Tensor,
    reg: RegularizationContext = RegularizationContext(),
    reg_weight: float = 0.0,
) -> torch.Tensor:
    """Per-entity coefficient variances 1 / (diag(H) + 1e-12) from the
    masked Hessian diagonals.  Pass the reg/reg_weight used for training so
    the L2 term enters the curvature."""
    _, l2_w = reg.split(reg_weight)
    z = torch.einsum("esd,ed->es", blocks.x, coefficients)
    if blocks.offsets is not None:
        z = z + blocks.offsets
    d2 = loss.d2z(z, blocks.labels)
    if blocks.weights is not None:
        d2 = d2 * blocks.weights
    d2 = _masked(d2, blocks.mask)
    hd = torch.einsum("es,esd->ed", d2, blocks.x * blocks.x)
    return 1.0 / (hd + l2_w + 1e-12)
