"""Segment-op grouped metrics: all groups evaluated in one vectorized pass
(a host-numpy copy of photon_ml_tpu/evaluation/segmented.py).

Role of the reference's per-group local evaluators under MultiEvaluator
(photon-api/.../evaluation/MultiEvaluator.scala:49-64: groupByKey +
LocalEvaluator per group + mean of finite results).  The reference runs one
LocalEvaluator task per group; per-entity AUC / precision@k over millions of
groups would dominate validation wall clock if done as a Python loop, so
every metric here is a flat array program over the group-sorted arrays:
reduceat segment sums, cumulative sums with per-segment offsets, and rank
arithmetic — no per-group Python.

Inputs: arrays already sorted so groups are contiguous, plus `bounds` — the
[num_groups + 1] array of segment start indices (bounds[-1] == len).
Outputs: one value per group (NaN where the metric is undefined for the
group, matching the local evaluators).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _seg_sum(values: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    if len(values) == 0:
        return np.zeros(max(len(bounds) - 1, 0))
    return np.add.reduceat(values, bounds[:-1])


def grouped_auc(
    bounds: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    weights: Optional[np.ndarray],
) -> np.ndarray:
    """Per-group tie-aware weighted midrank AUC.

    Same statistic as evaluators.area_under_roc_curve, computed for every
    group at once: within each group, AUC = sum over score-tie-runs T of
    wp_T * (wn_strictly_below_T + wn_T / 2), normalized by wp_g * wn_g.
    reference: AreaUnderROCCurveLocalEvaluator.scala:25-71.
    """
    n = int(bounds[-1]) if len(bounds) else 0
    num_groups = len(bounds) - 1
    if n == 0:
        return np.full(num_groups, np.nan)
    w = np.ones(n) if weights is None else weights
    pos = labels > 0.5
    # group id per row, then per-group score sort (stable lexsort: score
    # minor, group major keeps groups contiguous)
    gid = np.repeat(np.arange(num_groups), np.diff(bounds))
    order = np.lexsort((scores, gid))
    s, p, wo, g = scores[order], pos[order], w[order], gid[order]

    # tie runs: maximal runs of equal (group, score)
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = (g[1:] != g[:-1]) | (s[1:] != s[:-1])
    run_starts = np.flatnonzero(new_run)
    wp_t = np.add.reduceat(np.where(p, wo, 0.0), run_starts)
    wn_t = np.add.reduceat(np.where(~p, wo, 0.0), run_starts)
    g_t = g[run_starts]

    # negatives strictly below each run, within its group: global running sum
    # of run negatives minus the group's offset
    cw = np.cumsum(wn_t)
    new_group_t = np.empty(len(run_starts), dtype=bool)
    new_group_t[0] = True
    new_group_t[1:] = g_t[1:] != g_t[:-1]
    group_start_t = np.flatnonzero(new_group_t)
    offsets = np.where(group_start_t > 0, cw[group_start_t - 1], 0.0)
    runs_per_group = np.diff(np.append(group_start_t, len(run_starts)))
    wn_below_t = cw - wn_t - np.repeat(offsets, runs_per_group)

    contrib_t = wp_t * (wn_below_t + 0.5 * wn_t)
    # back to per-group space.  Groups can be empty in principle only if
    # bounds had zero-length segments; bounds comes from nonzero diffs so
    # every group has >= 1 row and appears in g_t.
    numer = np.add.reduceat(contrib_t, group_start_t)
    wp_g = np.add.reduceat(wp_t, group_start_t)
    wn_g = np.add.reduceat(wn_t, group_start_t)
    with np.errstate(divide="ignore", invalid="ignore"):
        auc = numer / (wp_g * wn_g)
    return np.where((wp_g > 0) & (wn_g > 0), auc, np.nan)


def grouped_precision_at_k(
    k: int,
    bounds: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-group hits-in-top-k / k (unweighted, denominator always k —
    reference: PrecisionAtKLocalEvaluator.scala `1.0 * hits / k`).  Top-k
    ties resolve by original row order, matching a stable descending sort."""
    del weights
    n = int(bounds[-1]) if len(bounds) else 0
    num_groups = len(bounds) - 1
    if n == 0:
        return np.full(num_groups, np.nan)
    gid = np.repeat(np.arange(num_groups), np.diff(bounds))
    order = np.lexsort((-scores, gid))   # stable: ties keep original order
    g_sorted = gid[order]
    # rank within group = global position - group start position
    start_of_group = np.repeat(bounds[:-1], np.diff(bounds))
    rank = np.arange(n) - start_of_group
    in_top_k = rank < k
    hits = np.where(in_top_k & (labels[order] > 0.5), 1.0, 0.0)
    return _seg_sum(hits, bounds) / k


def grouped_rmse(
    bounds: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    weights: Optional[np.ndarray],
) -> np.ndarray:
    w = np.ones_like(scores) if weights is None else weights
    se = _seg_sum(w * (scores - labels) ** 2, bounds)
    return np.sqrt(se / _seg_sum(w, bounds))


def grouped_mean_loss(loss, bounds, scores, labels, weights):
    """Per-group weighted mean of a pointwise loss (the elementwise loss is
    one array op, the port's torch loss in float64 on the host; only the
    segment means differ per group)."""
    l = loss.loss(torch.from_numpy(np.asarray(scores, dtype=np.float64)),
                  torch.from_numpy(np.asarray(labels, dtype=np.float64))).numpy()
    w = np.ones_like(l) if weights is None else weights
    return _seg_sum(w * l, bounds) / _seg_sum(w, bounds)
