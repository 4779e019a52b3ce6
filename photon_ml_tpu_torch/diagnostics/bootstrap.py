"""Bootstrap training: coefficient and metric confidence intervals (port of
photon_ml_tpu/diagnostics/bootstrap.py).

Rebuild of photon-diagnostics/.../BootstrapTraining.scala:29-181 +
CoefficientSummary.scala + BootstrapTrainingDiagnostic.scala.

A replica is a weight vector: row membership for all k replicas is drawn
as a [k, n] 0/1 matrix (numpy, the JAX package's draws), training weights
= w * member, holdout rows = the others.  The JAX package runs the k solves
as jax.vmap of its solve over the weight rows; here they are the k lanes of
one batched solve (optim/batched.py) over ops/lanes.py::FixedEffectLanes
with the member matrix as its lane mask: on the card one launch of the
lanes kernel per pass for up to max_lanes(d) replicas, each lane's weights
w * member_k read as one bit per row.  The holdout margins are one matrix
product of X and the replicas' coefficients, read back once; the metrics
run on the host.  A bf16 X keeps its bf16 storage, and the replicas'
labels, weights, offsets and state take X's dtype, as the JAX package's
do (photon_ml_tpu/diagnostics/bootstrap.py:112-126): each pass runs in
float32 and its results are rounded to bf16 (ops/lanes.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.diagnostics.metrics import evaluate_scores
from photon_ml_tpu_torch.ops import TASK_LOSSES
from photon_ml_tpu_torch.ops.lanes import FixedEffectLanes, lanes_matvec
from photon_ml_tpu_torch.optim import OptimizerConfig, RegularizationContext, batched


@dataclasses.dataclass
class CoefficientSummary:
    """Five-number summary + mean/std over bootstrap replicas (reference:
    supervised/model/CoefficientSummary.scala — quartiles/min/max)."""

    min: float
    q1: float
    median: float
    q3: float
    max: float
    mean: float
    std: float

    @staticmethod
    def from_samples(samples: np.ndarray) -> "CoefficientSummary":
        s = np.asarray(samples, dtype=np.float64)
        q1, med, q3 = np.percentile(s, [25, 50, 75])
        return CoefficientSummary(float(s.min()), float(q1), float(med),
                                  float(q3), float(s.max()),
                                  float(s.mean()), float(s.std()))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BootstrapReport:
    num_samples: int
    # per-coefficient summaries, 1:1 with the coefficient vector
    coefficient_summaries: List[CoefficientSummary]
    # metric name -> summary over replicas (holdout evaluation)
    metric_summaries: Dict[str, CoefficientSummary]
    # per-coefficient: True when the cross-replica IQR excludes zero
    significant_mask: np.ndarray
    # the replicas' coefficients [k, d] and their batched solve (route,
    # lane groups, value+gradient rounds, per-replica iterations and
    # passes); not part of the report's JSON
    coefficients: Optional[np.ndarray] = dataclasses.field(default=None, repr=False,
                                                           compare=False)
    solve: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)

    def to_dict(self) -> dict:
        return {
            "num_samples": self.num_samples,
            "coefficient_summaries": [c.to_dict() for c in self.coefficient_summaries],
            "metric_summaries": {k: v.to_dict() for k, v in self.metric_summaries.items()},
            "num_significant": int(self.significant_mask.sum()),
        }


def dense_on(x, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A dense feature shard as a tensor on `device`: a tensor already
    there is used as it is (in `dtype` when given); anything else goes
    through np.asarray, as the JAX package's diagnostics take it."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def bootstrap_training(
    x,
    labels,
    task_type: str,
    *,
    num_bootstrap_samples: int = 10,
    training_portion: float = 0.75,
    weights: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    optimizer_config: OptimizerConfig = OptimizerConfig(),
    regularization: RegularizationContext = RegularizationContext(),
    regularization_weight: float = 0.0,
    warm_start: Optional[np.ndarray] = None,
    seed: int = 7,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> BootstrapReport:
    """Train k replica models on random subsamples, evaluate each on its
    holdout, aggregate coefficient + metric CIs.  On `device` (default
    cuda) in `dtype` (default: x's own).

    reference: BootstrapTraining.bootstrap (scala:132-181; split-tag
    subsampling with the `populationPortionPerBootstrapSample` cap at 0.9)
    plus aggregateCoefficient/MetricsConfidenceIntervals (scala:48-100).
    """
    from photon_ml_tpu_torch import resolve_device
    if num_bootstrap_samples <= 1:
        raise ValueError("number of bootstrap samples must be > 1")
    if not 0.0 < training_portion <= 1.0:
        raise ValueError("training portion must be in (0, 1]")
    portion = min(0.9, training_portion)  # reference: never more than 90%

    x = dense_on(x, resolve_device(device), dtype)
    dtype, device = x.dtype, x.device
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    y = as_t(labels)
    n, d = x.shape
    k = num_bootstrap_samples
    rng = np.random.default_rng(seed)
    member = (rng.random((k, n)) < portion)
    x0 = (torch.zeros((k, d), dtype=dtype, device=device) if warm_start is None
          else as_t(warm_start).expand(k, d).contiguous())
    loss = TASK_LOSSES[task_type]
    # one offset vector for every replica, in the kernel's [k, n] layout
    off = None if offsets is None else as_t(offsets).expand(k, n).contiguous()
    # lambda in the solve's dtype, as the JAX package passes it
    lam = float(torch.tensor(regularization_weight, dtype=dtype))
    l2 = regularization.split(lam)[1]
    oracle = FixedEffectLanes(
        loss, x, y, off, torch.full((k,), l2, dtype=dtype, device=device),
        weights=None if weights is None else as_t(weights),
        lane_keep=torch.from_numpy(member).to(device))
    res = batched.solve(oracle.value_and_gradient, x0, optimizer_config, regularization,
                        lam, loss=loss, hessian_vector_at=oracle.hessian_vector_at)
    # numpy holds no bf16: a bf16 state's values come to the host widened
    host = lambda t: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    coefs = host(res.x)                             # [k, d]

    # holdout metrics per replica (host-side reporting loop)
    margins_all = host(lanes_matvec(x, res.x))      # [k, n]
    if offsets is not None:
        margins_all = margins_all + np.asarray(offsets)
    per_metric: Dict[str, List[float]] = {}
    labels_np = np.asarray(labels, dtype=np.float64)
    for r in range(num_bootstrap_samples):
        hold = ~member[r]
        if not hold.any():
            continue
        margins = margins_all[r, hold]
        preds = loss.mean(torch.from_numpy(margins)).numpy()
        metrics = evaluate_scores(task_type, preds, margins, labels_np[hold],
                                  coefficients=coefs[r])
        for k_, v in metrics.items():
            per_metric.setdefault(k_, []).append(v)

    coef_summaries = [CoefficientSummary.from_samples(coefs[:, j])
                      for j in range(d)]
    metric_summaries = {k_: CoefficientSummary.from_samples(np.asarray(v))
                        for k_, v in per_metric.items()}
    significant = np.asarray([(c.q1 > 0) or (c.q3 < 0) for c in coef_summaries])
    passes = res.fg_count if res.fg_count is not None else res.iterations + 1
    return BootstrapReport(
        num_samples=num_bootstrap_samples,
        coefficient_summaries=coef_summaries,
        metric_summaries=metric_summaries,
        significant_mask=significant,
        coefficients=coefs,
        solve={"route": oracle.route, "lane_groups": len(oracle.groups),
               "rounds": res.rounds, "iterations": res.iterations.tolist(),
               "passes": passes.tolist()})
