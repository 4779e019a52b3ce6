"""Feature importance rankings (a host-numpy copy of
photon_ml_tpu/diagnostics/importance.py).

Rebuild of photon-diagnostics/.../featureimportance/*:
  - expected-magnitude importance |c_j * meanAbs(x_j)|
    (ExpectedMagnitudeFeatureImportanceDiagnostic.scala:42-58)
  - variance importance |c_j * var(x_j)|
    (VarianceFeatureImportanceDiagnostic.scala:41-57)
ranked descending with the rank -> importance summary the HTML report plots.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary


@dataclasses.dataclass
class FeatureImportanceReport:
    importance_type: str
    # (feature key, index, importance), sorted descending by importance
    ranked: List[Tuple[str, int, float]]

    def top(self, k: int = 20) -> List[Tuple[str, int, float]]:
        return self.ranked[:k]

    def to_dict(self, top_k: int = 50) -> dict:
        return {"importance_type": self.importance_type,
                "top": [{"feature": f, "index": i, "importance": v}
                        for f, i, v in self.top(top_k)]}


def feature_importance(
    coefficients,
    summary: Optional[BasicStatisticalSummary] = None,
    feature_keys: Optional[Sequence[str]] = None,
    importance_type: str = "expected_magnitude",
) -> FeatureImportanceReport:
    """importance_type in {"expected_magnitude", "variance"}; without a
    statistics summary every feature scale defaults to 1 (reference: the
    summary None case in getImportances)."""
    c = np.asarray(coefficients, dtype=np.float64)
    if importance_type == "expected_magnitude":
        scale = summary.mean_abs if summary is not None else np.ones_like(c)
    elif importance_type == "variance":
        scale = summary.variance if summary is not None else np.ones_like(c)
    else:
        raise ValueError(f"unknown importance type {importance_type!r}")
    imp = np.abs(c * np.asarray(scale))
    keys = (list(feature_keys) if feature_keys is not None
            else [f"feature_{j}" for j in range(len(c))])
    order = np.argsort(-imp, kind="stable")
    ranked = [(keys[j], int(j), float(imp[j])) for j in order]
    return FeatureImportanceReport(importance_type, ranked)
