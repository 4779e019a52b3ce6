"""Hosmer-Lemeshow goodness-of-fit (calibration) test for logistic models
(a host-numpy copy of photon_ml_tpu/diagnostics/hl.py).

Rebuild of photon-diagnostics/.../diagnostics/hl/*:
  - bin count heuristic: min(dim + 2, 0.9*sqrt(n) + 0.9*log1p(n))
    (DefaultPredictedProbabilityVersusObservedFrequencyBinner.scala — the
    reference uses DATA_HEURISTIC_FACTOR_A for BOTH terms, reproduced here).
    Deliberate divergence: we floor the count at 3 so chi^2 keeps >= 1 degree
    of freedom on tiny/low-dim inputs; the reference takes the plain min and
    can produce a degenerate (< 3 bin) test there.
  - equal-width predicted-probability bins; per bin chi^2 contribution
    (obs-exp)^2/exp for positives and negatives, skipped when exp == 0, with
    a warning when expected < 5 (HosmerLemeshowDiagnostic.scala:25-120)
  - dof = bins - 2, p-value + standard confidence-level cutoffs
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

STANDARD_CONFIDENCE_LEVELS = (0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
                              0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999)
MINIMUM_EXPECTED_IN_BUCKET = 5


@dataclasses.dataclass
class HosmerLemeshowBin:
    lower: float
    upper: float
    observed_pos: float
    observed_neg: float
    expected_pos: float
    expected_neg: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HosmerLemeshowReport:
    chi_squared: float
    degrees_of_freedom: int
    prob_at_chi_square: float          # CDF(chi2) — near 1 = poor calibration
    cutoffs: List[Tuple[float, float]]
    bins: List[HosmerLemeshowBin]
    warnings: List[str]

    @property
    def p_value(self) -> float:
        return 1.0 - self.prob_at_chi_square

    def to_dict(self) -> dict:
        return {"chi_squared": self.chi_squared,
                "degrees_of_freedom": self.degrees_of_freedom,
                "prob_at_chi_square": self.prob_at_chi_square,
                "p_value": self.p_value,
                "cutoffs": self.cutoffs,
                "bins": [b.to_dict() for b in self.bins],
                "warnings": self.warnings}


def _bin_count(num_items: int, num_dimensions: int) -> int:
    by_dim = num_dimensions + 2
    by_data = int(0.9 * math.sqrt(num_items) + 0.9 * math.log1p(num_items))
    return max(3, min(by_data, by_dim))


def hosmer_lemeshow(
    predicted_probabilities,
    labels,
    num_dimensions: int,
) -> HosmerLemeshowReport:
    """reference: HosmerLemeshowDiagnostic.diagnose."""
    p = np.asarray(predicted_probabilities, dtype=np.float64)
    y = np.asarray(labels, dtype=np.float64) > 0.5
    n = len(p)
    bins = _bin_count(n, num_dimensions)
    edges = np.linspace(0.0, 1.0, bins + 1)
    which = np.clip(np.digitize(p, edges[1:-1]), 0, bins - 1)

    out_bins: List[HosmerLemeshowBin] = []
    warnings: List[str] = []
    chi2_score = 0.0
    for b in range(bins):
        sel = which == b
        exp_pos = float(p[sel].sum())
        exp_neg = float((1.0 - p[sel]).sum())
        obs_pos = float(y[sel].sum())
        obs_neg = float((~y[sel]).sum())
        if exp_pos > 0:
            chi2_score += (obs_pos - exp_pos) ** 2 / exp_pos
        if exp_neg > 0:
            chi2_score += (obs_neg - exp_neg) ** 2 / exp_neg
        for name, e in (("positive", exp_pos), ("negative", exp_neg)):
            if e < MINIMUM_EXPECTED_IN_BUCKET:
                warnings.append(
                    f"bin [{edges[b]:.3f}, {edges[b + 1]:.3f}): expected "
                    f"{name} count {e:.2f} too small for a sound chi^2 term")
        out_bins.append(HosmerLemeshowBin(float(edges[b]), float(edges[b + 1]),
                                          obs_pos, obs_neg, exp_pos, exp_neg))

    dof = max(1, bins - 2)
    # imported here: importing scipy.stats starts a process (numpy's CPU
    # feature probe), which importing the port must not
    from scipy.stats import chi2 as _chi2
    dist = _chi2(dof)
    cutoffs = [(lvl, float(dist.ppf(lvl))) for lvl in STANDARD_CONFIDENCE_LEVELS]
    return HosmerLemeshowReport(
        chi_squared=float(chi2_score), degrees_of_freedom=dof,
        prob_at_chi_square=float(dist.cdf(chi2_score)),
        cutoffs=cutoffs, bins=out_bins, warnings=warnings)
