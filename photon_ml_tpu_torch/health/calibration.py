"""Streaming Hosmer–Lemeshow calibration over fixed probability bins (a
copy of photon_ml_tpu/health/calibration.py: host numpy and scipy).

The offline diagnostics tier (`diagnostics/hl.py`) computes the HL test in
one batch pass with a data-dependent bin count; a serving process sees its
labels as a stream and cannot hold them.  This accumulator keeps ONLY the
four per-bin sums the chi^2 needs — expected/observed positives and
negatives — so memory is O(bins) forever and an update is a digitize +
four bincounts on the incoming batch (no per-row Python).

The bin rule is hl.py's, with the bin COUNT fixed up front (score deciles
by default) instead of derived from n: equal-width probability edges over
[0, 1], `digitize` against the interior edges, and the identical per-bin
chi^2 contribution `(obs-exp)^2/exp` for positives and negatives with
zero-expectation bins skipped.  Feeding the same (p, y) traffic through
this accumulator and through `hosmer_lemeshow` (with a dimension count
that yields the same bin count) produces the same chi^2 / p-value up to
float summation order — the tier-1 parity test holds them to 1e-12.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class CalibrationWindow:
    """One closed window's HL verdict + the per-bin evidence."""

    count: int
    chi_squared: float
    degrees_of_freedom: int
    prob_at_chi_square: float      # CDF(chi2) — near 1 = poor calibration
    expected_pos: List[float]
    expected_neg: List[float]
    observed_pos: List[float]
    observed_neg: List[float]

    @property
    def p_value(self) -> float:
        return 1.0 - self.prob_at_chi_square

    def to_dict(self) -> dict:
        return {"count": self.count, "chi_squared": self.chi_squared,
                "degrees_of_freedom": self.degrees_of_freedom,
                "prob_at_chi_square": self.prob_at_chi_square,
                "p_value": self.p_value}


class StreamingCalibration:
    """O(bins) streaming accumulator for the HL calibration statistic.

    NOT thread-safe: the HealthMonitor serializes updates under its own
    lock (one lock for the whole health state, not one per accumulator).
    Weights are deliberately ignored — `diagnostics/hl.py` defines the
    unweighted test and is this accumulator's parity oracle.
    """

    def __init__(self, bins: int = 10):
        if bins < 3:
            raise ValueError(f"calibration needs >= 3 bins for a chi^2 "
                             f"with >= 1 dof, got {bins}")
        self.bins = int(bins)
        self.edges = np.linspace(0.0, 1.0, self.bins + 1)
        self._exp_pos = np.zeros(self.bins)
        self._exp_neg = np.zeros(self.bins)
        self._obs_pos = np.zeros(self.bins)
        self._obs_neg = np.zeros(self.bins)
        self.count = 0

    def update(self, probs: np.ndarray, labels: np.ndarray) -> None:
        """Accumulate a batch of (predicted probability, binary label)."""
        p = np.asarray(probs, np.float64)
        y = np.asarray(labels, np.float64) > 0.5
        which = np.clip(np.digitize(p, self.edges[1:-1]), 0, self.bins - 1)
        self._exp_pos += np.bincount(which, weights=p, minlength=self.bins)
        self._exp_neg += np.bincount(which, weights=1.0 - p,
                                     minlength=self.bins)
        self._obs_pos += np.bincount(which, weights=y.astype(np.float64),
                                     minlength=self.bins)
        self._obs_neg += np.bincount(which, weights=(~y).astype(np.float64),
                                     minlength=self.bins)
        self.count += len(p)

    def report(self) -> Optional[CalibrationWindow]:
        """The HL verdict over everything accumulated so far (None when
        empty).  Same per-bin algebra as `diagnostics.hl.hosmer_lemeshow`:
        chi^2 terms skipped where the expectation is zero, dof = bins - 2
        floored at 1."""
        if self.count == 0:
            return None
        # imported here: importing scipy.stats starts a process (numpy's CPU
        # feature probe), and importing the port starts none
        from scipy.stats import chi2 as _chi2
        chi2_score = 0.0
        for exp, obs in ((self._exp_pos, self._obs_pos),
                         (self._exp_neg, self._obs_neg)):
            nz = exp > 0
            chi2_score += float(np.sum((obs[nz] - exp[nz]) ** 2 / exp[nz]))
        dof = max(1, self.bins - 2)
        return CalibrationWindow(
            count=self.count, chi_squared=chi2_score,
            degrees_of_freedom=dof,
            prob_at_chi_square=float(_chi2(dof).cdf(chi2_score)),
            expected_pos=self._exp_pos.tolist(),
            expected_neg=self._exp_neg.tolist(),
            observed_pos=self._obs_pos.tolist(),
            observed_neg=self._obs_neg.tolist())

    def take(self) -> Optional[CalibrationWindow]:
        """Close the window: report + reset the accumulators."""
        out = self.report()
        self.reset()
        return out

    def reset(self) -> None:
        self._exp_pos[:] = 0.0
        self._exp_neg[:] = 0.0
        self._obs_pos[:] = 0.0
        self._obs_neg[:] = 0.0
        self.count = 0
