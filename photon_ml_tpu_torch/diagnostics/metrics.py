"""Extended model-quality metrics (the diagnostics metric map; a host-numpy
copy of photon_ml_tpu/diagnostics/metrics.py, `evaluate_glm` scoring with
the port's models).

Rebuild of photon-diagnostics/.../Evaluation.scala:31-198:
  - regression facet: MAE / MSE / RMSE
  - binary facet: area under PR, area under ROC, peak F1
  - per-datum log likelihood (logistic and Poisson families)
  - corrected Akaike information criterion (AICc) from the log likelihood
    and the count of effective (|c| > 1e-9) parameters

The reference computes the binary metrics through spark-mllib
BinaryClassificationMetrics (threshold sweep); here one descending sort
yields the full confusion-count curves.  Host numpy — these are reporting
paths, not training paths.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

MEAN_ABSOLUTE_ERROR = "Mean absolute error"
MEAN_SQUARE_ERROR = "Mean square error"
ROOT_MEAN_SQUARE_ERROR = "Root mean square error"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
AREA_UNDER_ROC = "Area under ROC"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"
AKAIKE_INFORMATION_CRITERION = "Akaike information criterion"
_EPSILON = 1e-9

MetricsMap = Dict[str, float]


def _binary_curves(predictions: np.ndarray, labels: np.ndarray):
    """One descending sort -> (recall, precision, fpr, tpr) step curves with
    threshold at every distinct prediction (the spark-mllib
    BinaryClassificationMetrics sweep, vectorized)."""
    order = np.argsort(-predictions, kind="stable")
    y = labels[order] > 0.5
    p_sorted = predictions[order]
    tp = np.cumsum(y)
    fp = np.cumsum(~y)
    # keep only the last index of each tie-group of predictions
    keep = np.nonzero(np.diff(p_sorted, append=-np.inf))[0]
    tp, fp = tp[keep], fp[keep]
    pos, neg = tp[-1], fp[-1]
    recall = tp / max(pos, 1)
    precision = tp / np.maximum(tp + fp, 1)
    tpr = recall
    fpr = fp / max(neg, 1)
    return recall, precision, fpr, tpr


def _degenerate(labels: np.ndarray) -> bool:
    """Single-class or empty input: threshold metrics are undefined — NaN,
    matching evaluation/evaluators.py (MultiEvaluator then drops the value)."""
    y = labels > 0.5
    return len(labels) == 0 or y.all() or (~y).all()


def area_under_pr(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Trapezoid over the PR curve with the (0, firstPrecision) start point
    spark-mllib prepends (not (0, 1): when the top-scoring tie group contains
    negatives, precision[0] < 1 and starting at 1 would inflate the area)."""
    if _degenerate(labels):
        return float("nan")
    recall, precision, _, _ = _binary_curves(predictions, labels)
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0]], precision])
    return float(np.trapezoid(p, r))


def area_under_roc(predictions: np.ndarray, labels: np.ndarray) -> float:
    if _degenerate(labels):
        return float("nan")
    _, _, fpr, tpr = _binary_curves(predictions, labels)
    f = np.concatenate([[0.0], fpr, [1.0]])
    t = np.concatenate([[0.0], tpr, [1.0]])
    return float(np.trapezoid(t, f))


def peak_f1(predictions: np.ndarray, labels: np.ndarray) -> float:
    if _degenerate(labels):
        return float("nan")
    recall, precision, _, _ = _binary_curves(predictions, labels)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.where(denom > 0, denom, 1), 0.0)
    return float(np.max(f1)) if len(f1) else float("nan")


def logistic_log_likelihood(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Mean per-datum log likelihood from predicted probabilities, with the
    reference's epsilon clamping (Evaluation.scala:150-162)."""
    p = np.clip(predictions, _EPSILON, 1.0 - _EPSILON)
    return float(np.mean(labels * np.log(p) + (1.0 - labels) * np.log1p(-p)))


def poisson_log_likelihood(margins: np.ndarray, labels: np.ndarray) -> float:
    """Mean of y*wTx - exp(wTx) - log(y!) (Evaluation.scala:138-148)."""
    from scipy.special import gammaln
    return float(np.mean(labels * margins - np.exp(margins)
                         - gammaln(1.0 + labels)))


def _aicc(log_likelihood_per_datum: float, n: int, coefficients: np.ndarray) -> float:
    """Corrected AIC (Evaluation.scala:105-121): effective parameters =
    coefficients with |c| > 1e-9."""
    k = int(np.sum(np.abs(coefficients) > _EPSILON))
    total_ll = n * log_likelihood_per_datum
    base = 2.0 * (k - total_ll)
    denom = n - k - 1.0
    # JVM double semantics: x/0.0 = Inf (degenerate n <= k+1 case)
    correction = 2.0 * k * (k + 1) / denom if denom != 0 else math.inf
    return base + correction


def evaluate_scores(
    task_type: str,
    predictions: np.ndarray,
    margins: np.ndarray,
    labels: np.ndarray,
    coefficients: Optional[np.ndarray] = None,
) -> MetricsMap:
    """Metric map from precomputed predictions (mean function w/ offset) and
    margins.  Facets by task exactly as the reference matches on model type."""
    predictions = np.asarray(predictions, dtype=np.float64)
    margins = np.asarray(margins, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    m: MetricsMap = {}
    if task_type in ("linear_regression", "poisson_regression"):
        err = predictions - labels
        m[MEAN_ABSOLUTE_ERROR] = float(np.mean(np.abs(err)))
        m[MEAN_SQUARE_ERROR] = float(np.mean(err * err))
        m[ROOT_MEAN_SQUARE_ERROR] = math.sqrt(m[MEAN_SQUARE_ERROR])
    if task_type in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        m[AREA_UNDER_PRECISION_RECALL] = area_under_pr(predictions, labels)
        m[AREA_UNDER_ROC] = area_under_roc(predictions, labels)
        m[PEAK_F1_SCORE] = peak_f1(predictions, labels)
    if task_type == "logistic_regression":
        m[DATA_LOG_LIKELIHOOD] = logistic_log_likelihood(predictions, labels)
    elif task_type == "poisson_regression":
        m[DATA_LOG_LIKELIHOOD] = poisson_log_likelihood(margins, labels)
    if DATA_LOG_LIKELIHOOD in m and coefficients is not None:
        m[AKAIKE_INFORMATION_CRITERION] = _aicc(
            m[DATA_LOG_LIKELIHOOD], len(labels), np.asarray(coefficients))
    return m


def evaluate_glm(
    model,
    x,
    labels,
    offsets: Optional[np.ndarray] = None,
    ) -> MetricsMap:
    """reference: Evaluation.evaluate(model, dataSet) — score once with the
    mean function + offset, derive every facet from it.  The margins are
    computed on the model's device, in its dtype, and read back once; the
    mean function and the metrics run in float64 on the host."""
    import torch
    means = model.coefficients.means
    x = torch.as_tensor(np.asarray(x), dtype=means.dtype, device=means.device)
    margins = model.compute_score(x).detach().cpu().numpy().astype(np.float64)
    if offsets is not None:
        margins = margins + np.asarray(offsets, dtype=np.float64)
    predictions = type(model).loss.mean(torch.from_numpy(margins)).numpy()
    return evaluate_scores(type(model).task_type, predictions, margins,
                           np.asarray(labels),
                           coefficients=means.detach().cpu().numpy())
