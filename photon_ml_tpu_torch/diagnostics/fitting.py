"""Fitting diagnostic: learning curves over growing training portions (port
of photon_ml_tpu/diagnostics/fitting.py).

Rebuild of photon-diagnostics/.../fitting/FittingDiagnostic.scala:33-131:
tag rows into 10 partitions, hold partition 9 out, train on growing prefixes
(1/9, 2/9, ... of the non-holdout data) with warm starts, record each metric
on train and holdout per portion.  Subsets are weight masks over the shared
feature matrix — no data movement: each of the nine solves runs
optim/config.py::solve over the port's GLMObjective with weights
member * w, so on the card every value+gradient pass is one launch of the
single fused kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.bootstrap import dense_on
from photon_ml_tpu_torch.diagnostics.metrics import evaluate_scores
from photon_ml_tpu_torch.ops import TASK_LOSSES, GLMObjective
from photon_ml_tpu_torch.optim import OptimizerConfig, RegularizationContext, solve

NUM_TRAINING_PARTITIONS = 10          # reference: FittingDiagnostic object
MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 10


@dataclasses.dataclass
class FittingReport:
    # metric -> {"portions": [...], "train": [...], "test": [...]}
    metrics: Dict[str, Dict[str, List[float]]]
    message: str = ""
    # per solve: iterations and value+gradient passes; not part of the
    # report's JSON
    solves: List[dict] = dataclasses.field(default_factory=list, repr=False,
                                           compare=False)

    def to_dict(self) -> dict:
        return {"metrics": self.metrics, "message": self.message}


def fitting_diagnostic(
    x,
    labels,
    task_type: str,
    *,
    weights: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    optimizer_config: OptimizerConfig = OptimizerConfig(),
    regularization: RegularizationContext = RegularizationContext(),
    regularization_weight: float = 0.0,
    seed: int = 7,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> FittingReport:
    """reference: FittingDiagnostic.diagnose.  Returns an empty report when
    there is not enough data (reference: numSamples <= dim * 10 guard).  On
    `device` (default cuda) in `dtype` (default: x's own)."""
    from photon_ml_tpu_torch import resolve_device
    x = dense_on(x, resolve_device(device), dtype)
    dtype, device = x.dtype, x.device
    n, d = x.shape
    if n <= d * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION:
        return FittingReport({}, message=(
            f"not enough data for learning curves: {n} rows <= "
            f"{d * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION}"))

    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    y = as_t(np.asarray(labels, dtype=np.float64))
    base_w = (np.ones(n) if weights is None
              else np.asarray(weights, dtype=np.float64))
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, NUM_TRAINING_PARTITIONS, size=n)
    holdout = tags == NUM_TRAINING_PARTITIONS - 1
    off = None if offsets is None else as_t(np.asarray(offsets))
    loss = TASK_LOSSES[task_type]
    labels_np = np.asarray(labels, dtype=np.float64)

    curves: Dict[str, Dict[str, List[float]]] = {}
    solves: List[dict] = []
    x0 = torch.zeros((d,), dtype=dtype, device=device)
    lam = float(torch.tensor(regularization_weight, dtype=dtype))
    for max_tag in range(NUM_TRAINING_PARTITIONS - 1):
        member = tags <= max_tag
        portion = 100.0 * member.sum() / n
        w = as_t(member * base_w)
        obj = GLMObjective(loss, x, y, weights=w, offsets=off)
        res = solve(obj, x0, optimizer_config, regularization, lam)
        x0 = res.x  # warm start the next, larger portion (reference scanLeft)
        solves.append({"iterations": int(res.iterations),
                       "passes": int(res.fg_count if res.fg_count is not None
                                     else res.iterations + 1)})
        margins = (x @ res.x).cpu().numpy()
        if offsets is not None:
            margins = margins + np.asarray(offsets)
        preds = loss.mean(torch.from_numpy(margins)).numpy()
        coefs = res.x.cpu().numpy()
        m_train = evaluate_scores(task_type, preds[member], margins[member],
                                  labels_np[member], coefficients=coefs)
        m_test = evaluate_scores(task_type, preds[holdout], margins[holdout],
                                 labels_np[holdout], coefficients=coefs)
        for metric, v_test in m_test.items():
            entry = curves.setdefault(
                metric, {"portions": [], "train": [], "test": []})
            entry["portions"].append(round(portion, 2))
            entry["train"].append(m_train.get(metric, float("nan")))
            entry["test"].append(v_test)
    return FittingReport(curves, solves=solves)
