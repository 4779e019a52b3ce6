"""Prior-anchored per-entity solves: the math core of the online tier (port
of photon_ml_tpu/game/anchored.py).

Production GLMix freshness comes from cheap random-effect-only refits: the
per-entity subproblems are independent (the executor-sharding insight the
distributed coordinate descent literature exploits — arXiv 1611.02101;
Snap ML 1803.06333 shows local sub-solves at micro-batch scale are where
the hardware wins), so a handful of entities with new feedback can be
re-solved without touching the fixed effect or the other entities.

A fresh-feedback refit must not let a few rows blow away the batch
solution, so the subproblem is ANCHORED at the current coefficients c0:

    min_c  sum_s w_s * loss(x_s . c + o_s, y_s)  +  lam/2 * ||c - c0||^2

Solved in DELTA space (c = c0 + delta): folding x.c0 into the offsets
turns the anchor into a plain L2 penalty on delta,

    min_d  sum_s w_s * loss(x_s . d + (o_s + x_s . c0), y_s) + lam/2 ||d||^2

which is exactly the shape the batched random-effect solver
(`parallel.random_effect.fit_random_effects`, the host-stepped batched
LBFGS of optim/batched.py over torch `bmm`s) takes: the online tier reuses
it at micro-batch size, warm-started at delta=0 (i.e. at the current
coefficients).  One practical consequence the online updater leans on:
when `o_s` already holds the FULL model margin of the row (own coordinate
included), `o_s + x_s . c0` is just `margin + base offset` — no
per-coordinate margin decomposition is needed.

Also here: per-entity sub-dataset extraction (carve the rows of a set of
entities out of a GameDataset) and the OFFLINE refit reference that the
parity gates compare the online path against — it goes through the
training-side dataset build (`build_random_effect_dataset`), i.e. a
genuinely different block-construction path arriving at the same optimum.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.optim import (OptimizerConfig, RegularizationContext,
                                       RegularizationType, SolveResult)
from photon_ml_tpu_torch.parallel.random_effect import (EntityBlocks,
                                                        fit_random_effects)

#: the anchor is a pure L2 pull toward the prior in delta space
ANCHOR_REG = RegularizationContext(RegularizationType.L2)


def _fold_prior_offsets(x, prior, offsets, mask):
    """offsets' = offsets + x . prior, masked (padding cells stay 0)."""
    return (offsets + torch.einsum("esd,ed->es", x, prior)) * mask


def lane_all_finite(rows: torch.Tensor) -> torch.Tensor:
    """[E] finite flag per entity lane — the online quarantine predicate."""
    return torch.isfinite(rows).all(dim=-1)


def solve_anchored(blocks: EntityBlocks, prior: torch.Tensor,
                   loss, config: OptimizerConfig,
                   anchor_weight: float, budget=None,
                   ) -> Tuple[torch.Tensor, SolveResult]:
    """All entities' anchored subproblems as ONE batched solve.

    `prior` is [E, d] (the current coefficient rows, on the blocks' device
    and in their dtype); returns (new_rows [E, d], delta-space
    SolveResult).  The solve is optim/batched.py's host-stepped LBFGS over
    the blocks (one read-back per round), so nothing is compiled and any
    (E, S, d) runs as it comes."""
    E, S, d = blocks.x.shape
    if tuple(prior.shape) != (E, d):
        raise ValueError(f"prior must be [{E}, {d}], got {tuple(prior.shape)}")
    offsets = (blocks.offsets if blocks.offsets is not None
               else torch.zeros_like(blocks.labels))
    folded = dataclasses.replace(
        blocks, offsets=_fold_prior_offsets(blocks.x, prior, offsets,
                                            blocks.mask))
    res = fit_random_effects(
        folded, loss, x0=torch.zeros_like(prior), config=config,
        reg=ANCHOR_REG, reg_weight=anchor_weight, budget=budget)
    return prior + res.x, res


# -- per-entity sub-dataset extraction ----------------------------------------

def entity_rows(dataset, re_type: str, entity_ids) -> np.ndarray:
    """Canonical row ids of `dataset` whose `re_type` entity is in
    `entity_ids` (raw id values) — the extraction step of an
    entities-only refit."""
    vocab = np.asarray(dataset.entity_vocabs[re_type])
    wanted = set(np.asarray(entity_ids).tolist())
    vocab_hit = np.asarray([v in wanted for v in vocab.tolist()])
    idx = np.asarray(dataset.entity_indices[re_type])
    return np.flatnonzero((idx >= 0) & vocab_hit[np.maximum(idx, 0)])


def sub_dataset_for_entities(dataset, re_type: str, entity_ids):
    """Row-slice of `dataset` containing exactly the given entities' rows
    (shared vocabularies, canonical order preserved within the slice)."""
    return dataset.subset(entity_rows(dataset, re_type, entity_ids))


def offline_anchored_refit(  # photonlint: flush-point -- returns host rows: one read-back of the solved lanes
    dataset,
    re_type: str,
    feature_shard: str,
    prior_rows: Dict[object, np.ndarray],
    loss,
    config: OptimizerConfig = OptimizerConfig(),
    anchor_weight: float = 1.0,
    dtype=np.float64,
    *,
    device=None,
) -> Dict[object, np.ndarray]:
    """The parity REFERENCE for online updates: refit the dataset's
    entities' anchored subproblems through the TRAINING-side machinery.

    `dataset` holds the same feedback rows the online path consumed, with
    `dataset.offsets` already set to (full-model margin + base offset) per
    row — the same residual fold the online updater uses.  Blocks are
    built by `data.batching.build_random_effect_dataset` (identity
    projector, no caps) on the host in `dtype` and solved on `device`
    (None means cuda) in the same dtype: a different
    grouping/padding/packing path than the online FeedbackBuffer's,
    converging on the same per-entity optima (the anchor makes each
    subproblem strongly convex, so the f64 parity gate is well-posed).  Returns {entity_id: new row [d]} on the host."""
    from photon_ml_tpu_torch.data.batching import (RandomEffectDataConfig,
                                                   build_random_effect_dataset)
    if dataset.offsets is None:
        raise ValueError("offline_anchored_refit needs dataset.offsets = "
                         "full-model margins + base offsets (the residual "
                         "fold); build the dataset with offsets")
    red = build_random_effect_dataset(
        dataset, RandomEffectDataConfig(re_type, feature_shard,
                                        projector="identity",
                                        max_buckets=1), dtype=dtype,
        device=device, block_dtype=torch.from_numpy(np.zeros(0, dtype)).dtype)
    lane_ids = np.asarray(dataset.entity_vocabs[re_type])[red.entity_ids]
    missing = [v for v in lane_ids.tolist() if v not in prior_rows]
    if missing:
        raise ValueError(f"no prior row for entities {missing[:5]!r} — the "
                         "refit anchors every entity at its current row")
    blocks = red.blocks
    prior = torch.as_tensor(
        np.stack([np.asarray(prior_rows[v], dtype=dtype)
                  for v in lane_ids.tolist()]),
        dtype=blocks.x.dtype, device=blocks.x.device)
    new_rows, _res = solve_anchored(blocks, prior, loss, config,
                                    anchor_weight)
    out_np = new_rows.detach().cpu().numpy()
    return {v: out_np[i] for i, v in enumerate(lane_ids.tolist())}


def anchored_objective_np(x, y, w, offsets, c, prior, loss_name: str,
                          anchor_weight: float) -> float:
    """Host-numpy f64 anchored objective at `c` — the independent oracle
    the tests cross-check `solve_anchored` against (no torch involved)."""
    x = np.asarray(x, np.float64)
    z = x @ np.asarray(c, np.float64) + np.asarray(offsets, np.float64)
    y = np.asarray(y, np.float64)
    w = np.ones_like(z) if w is None else np.asarray(w, np.float64)
    if loss_name == "logistic_regression":
        per = np.logaddexp(0.0, z) - y * z
    elif loss_name == "linear_regression":
        per = 0.5 * (z - y) ** 2
    else:
        raise ValueError(f"unsupported oracle loss {loss_name!r}")
    diff = np.asarray(c, np.float64) - np.asarray(prior, np.float64)
    return float(np.sum(w * per) + 0.5 * anchor_weight * np.sum(diff * diff))
