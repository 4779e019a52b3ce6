"""Evaluation metrics: AUC, RMSE, per-task losses, grouped multi-evaluators
(port of photon_ml_tpu/evaluation/evaluators.py).

The host metrics are numpy float64, as in the JAX package (AUC is the
tie-aware rank statistic: one sort, midranks).  Every built-in ungrouped
metric also has a device form (`Evaluator.device_fn`) in torch, which the
training loop uses so a validation metric costs one scalar readback instead
of a copy of the [n] scores.  Grouped metrics evaluate every group in one
vectorized pass over the group-sorted arrays (evaluation/segmented.py, as
the JAX package does); the metric's host form stays the per-group oracle
and serves a grouped metric without a segmented form.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import segmented as seg
from photon_ml_tpu_torch.ops import losses as L


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def area_under_roc_curve(scores, labels, weights=None) -> float:
    """Tie-aware weighted AUC via midranks.  NaN when one class is absent."""
    s, y = _np(scores), _np(labels)
    w = np.ones_like(s) if weights is None else _np(weights)
    pos = y > 0.5
    wp, wn = w[pos].sum(), w[~pos].sum()
    if wp == 0 or wn == 0:
        return float("nan")
    order = np.argsort(s, kind="stable")
    s_sorted, w_sorted, pos_sorted = s[order], w[order], pos[order]
    # AUC = sum over score tie-groups G of wp_G * (wn_below_G + wn_G/2),
    # normalized by wp*wn
    bounds = np.concatenate([[0], np.nonzero(np.diff(s_sorted))[0] + 1])
    wp_g = np.add.reduceat(np.where(pos_sorted, w_sorted, 0.0), bounds)
    wn_g = np.add.reduceat(np.where(~pos_sorted, w_sorted, 0.0), bounds)
    wn_below = np.concatenate([[0.0], np.cumsum(wn_g)[:-1]])
    return float(np.sum(wp_g * (wn_below + 0.5 * wn_g)) / (wp * wn))


def rmse(scores, labels, weights=None) -> float:
    s, y = _np(scores), _np(labels)
    w = np.ones_like(s) if weights is None else _np(weights)
    return float(np.sqrt(np.sum(w * (s - y) ** 2) / np.sum(w)))


def _loss_metric(loss: L.PointwiseLoss):
    def fn(scores, labels, weights=None) -> float:
        z = torch.from_numpy(_np(scores))
        l = loss.loss(z, torch.from_numpy(_np(labels)))
        w = torch.ones_like(z) if weights is None else torch.from_numpy(_np(weights))
        return float(torch.sum(w * l) / torch.sum(w))
    return fn


# ---------------------------------------------------------------------------
# device metrics: tensors in, a 0-dim tensor out, no host sync
# ---------------------------------------------------------------------------

def device_auc(scores: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tie-aware weighted AUC on the device: a stable sort and two
    cumulative scans, the same midrank algebra as `area_under_roc_curve`.

    Per tie group G the contribution is wp_G * (wn_below_G + wn_G/2); each
    element reads its group's bounds from fills over the nondecreasing
    negative-weight cumsum: a group start carries the weight strictly below
    the group (forward cummax), a group end the weight through the group
    (reverse cummin)."""
    s = scores
    w = torch.ones_like(s) if weights is None else weights
    pos = labels > 0.5
    ss, order = torch.sort(s, stable=True)
    ws, ps = w[order], pos[order]
    zero = torch.zeros_like(ws)
    wn = torch.where(ps, zero, ws)
    wp = torch.where(ps, ws, zero)
    cn = torch.cumsum(wn, 0)
    cn_ex = cn - wn
    changed = ss[1:] != ss[:-1]
    true = torch.ones((1,), dtype=torch.bool, device=s.device)
    new_g = torch.cat([true, changed])
    end_g = torch.cat([changed, true])
    inf = torch.full_like(cn, float("inf"))
    below = torch.cummax(torch.where(new_g, cn_ex, -inf), 0).values
    through = torch.flip(torch.cummin(torch.flip(torch.where(end_g, cn, inf), [0]), 0).values,
                         [0])
    wp_total, wn_total = wp.sum(), wn.sum()
    auc = (wp * (below + 0.5 * (through - below))).sum() / (wp_total * wn_total)
    return torch.where((wp_total > 0) & (wn_total > 0), auc,
                       torch.full_like(auc, float("nan")))


def device_rmse(scores, labels, weights=None) -> torch.Tensor:
    w = torch.ones_like(scores) if weights is None else weights
    return torch.sqrt(torch.sum(w * (scores - labels) ** 2) / torch.sum(w))


def device_mean_loss(scores, labels, weights=None, *, loss) -> torch.Tensor:
    l = loss.loss(scores, labels)
    w = torch.ones_like(scores) if weights is None else weights
    return torch.sum(w * l) / torch.sum(w)


def precision_at_k(k: int, scores, labels, weights=None) -> float:
    """hits-in-top-k / k, unweighted, with denominator k even for groups of
    fewer than k rows (reference: PrecisionAtKLocalEvaluator.scala)."""
    del weights
    s, y = _np(scores), _np(labels)
    top = np.argsort(-s, kind="stable")[:k]
    return float((y[top] > 0.5).sum() / k)


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """name + metric + direction (reference: Evaluator.betterThan).
    `device_fn`, when present, computes the same metric as a device
    scalar."""

    name: str
    fn: Callable
    larger_is_better: bool
    device_fn: Optional[Callable] = None

    def __call__(self, scores, labels, weights=None) -> float:
        return self.fn(scores, labels, weights)

    def evaluate_on_device(self, scores, labels, weights=None):
        """Device-scalar evaluation, or None when this metric has no
        device form."""
        if self.device_fn is None:
            return None
        return self.device_fn(scores, labels, weights)

    def better_than(self, a: float, b: float) -> bool:
        if np.isnan(a):
            return False
        if np.isnan(b):
            return True
        return a > b if self.larger_is_better else a < b


@dataclasses.dataclass(frozen=True)
class MultiEvaluator:
    """Grouped metric: evaluate per id group, average the finite results
    (reference: MultiEvaluator.scala:49-64).  `group_index` is a
    canonical-order int column (an entity_indices column).

    When `segmented` is set (every built-in metric), all groups are
    computed in one vectorized pass (evaluation/segmented.py); `local`
    remains the per-group oracle and the fallback for custom metrics."""

    name: str
    local: Callable  # (scores, labels, weights) -> float
    larger_is_better: bool
    min_group_size: int = 1
    # (bounds, scores, labels, weights) -> per-group value array, inputs
    # group-sorted with bounds[i]:bounds[i+1] slicing group i
    segmented: Optional[Callable] = None

    def evaluate_grouped(self, group_index, scores, labels, weights=None) -> float:
        g = np.asarray(group_index)
        s, y = _np(scores), _np(labels)
        w = None if weights is None else _np(weights)
        valid = g >= 0
        order = np.argsort(g[valid], kind="stable")
        gv, sv, yv = g[valid][order], s[valid][order], y[valid][order]
        wv = None if w is None else w[valid][order]
        bounds = np.concatenate([[0], np.nonzero(np.diff(gv))[0] + 1, [len(gv)]])
        if self.segmented is not None:
            vals = np.asarray(self.segmented(bounds, sv, yv, wv))
        else:
            vals = np.asarray([
                self.local(sv[a:b], yv[a:b], None if wv is None else wv[a:b])
                for a, b in zip(bounds[:-1], bounds[1:])])
        keep = np.isfinite(vals) & (np.diff(bounds) >= self.min_group_size)
        return float(np.mean(vals[keep])) if keep.any() else float("nan")

    def better_than(self, a: float, b: float) -> bool:
        if np.isnan(a):
            return False
        if np.isnan(b):
            return True
        return a > b if self.larger_is_better else a < b


def _loss_evaluator(name: str, loss: L.PointwiseLoss) -> Evaluator:
    return Evaluator(name, _loss_metric(loss), larger_is_better=False,
                     device_fn=lambda s, y, w=None: device_mean_loss(s, y, w, loss=loss))


AUC = Evaluator("AUC", area_under_roc_curve, larger_is_better=True,
                device_fn=device_auc)
RMSE = Evaluator("RMSE", rmse, larger_is_better=False, device_fn=device_rmse)
LOGISTIC_LOSS = _loss_evaluator("LOGISTIC_LOSS", L.LOGISTIC)
SQUARED_LOSS = _loss_evaluator("SQUARED_LOSS", L.SQUARED)
POISSON_LOSS = _loss_evaluator("POISSON_LOSS", L.POISSON)
SMOOTHED_HINGE_LOSS = _loss_evaluator("SMOOTHED_HINGE_LOSS", L.SMOOTHED_HINGE)

_BY_NAME = {e.name: e for e in (AUC, RMSE, LOGISTIC_LOSS, SQUARED_LOSS,
                                POISSON_LOSS, SMOOTHED_HINGE_LOSS)}


def _segmented_table():
    table = {"AUC": seg.grouped_auc, "RMSE": seg.grouped_rmse}
    for name, loss in (("LOGISTIC_LOSS", L.LOGISTIC),
                       ("SQUARED_LOSS", L.SQUARED),
                       ("POISSON_LOSS", L.POISSON),
                       ("SMOOTHED_HINGE_LOSS", L.SMOOTHED_HINGE)):
        table[name] = (lambda b, s, y, w, _l=loss:
                       seg.grouped_mean_loss(_l, b, s, y, w))
    return table


_SEGMENTED = _segmented_table()


def default_evaluator_for_task(task_type: str) -> Evaluator:
    """reference: GameEstimator.prepareTrainingLossEvaluator task mapping."""
    return {
        "logistic_regression": LOGISTIC_LOSS,
        "linear_regression": SQUARED_LOSS,
        "poisson_regression": POISSON_LOSS,
        "smoothed_hinge_loss_linear_svm": SMOOTHED_HINGE_LOSS,
    }[task_type]


def default_validation_evaluator_for_task(task_type: str) -> Evaluator:
    """AUC for classification, RMSE for linear, the Poisson loss for
    Poisson."""
    return {
        "logistic_regression": AUC,
        "linear_regression": RMSE,
        "poisson_regression": POISSON_LOSS,
        "smoothed_hinge_loss_linear_svm": AUC,
    }[task_type]


def parse_evaluator(spec: str):
    """Parse "AUC", "RMSE", "PRECISION@K:10:groupCol", "AUC:groupCol" ->
    (evaluator, group column or None)."""
    parts = spec.split(":")
    head = parts[0].upper()
    if head == "PRECISION@K":
        if len(parts) != 3:
            raise ValueError(f"PRECISION@K needs k and group column: {spec!r}")
        k = int(parts[1])
        return MultiEvaluator(
            f"PRECISION@{k}:{parts[2]}",
            lambda s, y, w, _k=k: precision_at_k(_k, s, y, w),
            larger_is_better=True,
            segmented=lambda b, s, y, w, _k=k: seg.grouped_precision_at_k(
                _k, b, s, y, w)), parts[2]
    if len(parts) == 2:
        base = _BY_NAME[head]
        return MultiEvaluator(f"{base.name}:{parts[1]}", base.fn,
                              base.larger_is_better,
                              segmented=_SEGMENTED.get(base.name)), parts[1]
    if head in _BY_NAME:
        return _BY_NAME[head], None
    raise ValueError(f"unknown evaluator {spec!r}; known: {sorted(_BY_NAME)}")
