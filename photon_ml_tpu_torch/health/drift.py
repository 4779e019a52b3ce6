"""Score-distribution drift: PSI + binned KS against an install baseline
(a copy of photon_ml_tpu/health/drift.py: host numpy).

The baseline is a reservoir of the first `baseline_size` margins the live
model produces after `ModelRegistry.install()` — reset on every full-model
swap, CARRIED across row-level delta publishes (a delta is the same model
version refining itself; resetting there would blind the detector to
exactly the degradation the online tier can cause).  Once the reservoir
fills, its empirical quantiles become the bin edges (equal-mass bins make
PSI well-conditioned: no empty baseline bins by construction), and every
subsequent score costs one `searchsorted` lane + a bincount add.

Two statistics per closed window, both from the same histogram:

  * PSI — sum over bins of (cur - base) * ln(cur / base) with fractions
    floored at `_EPS` (the standard smoothing; an empty current bin must
    not produce an infinite index).  Industry folklore: < 0.1 stable,
    0.1-0.25 drifting, > 0.25 act.
  * KS — max |CDF_cur - CDF_base| evaluated at the bin boundaries (the
    binned sup-statistic; with equal-mass baseline bins the resolution is
    1/bins, which is exactly the granularity the gate thresholds speak).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_EPS = 1e-4


@dataclasses.dataclass
class DriftWindow:
    """One closed drift window's statistics."""

    count: int
    psi: float
    ks: float
    fractions: list          # current-window per-bin fractions

    def to_dict(self) -> dict:
        return {"count": self.count, "psi": self.psi, "ks": self.ks}


class DriftDetector:
    """Baseline-relative score-distribution drift (PSI + binned KS).

    NOT thread-safe: the HealthMonitor serializes access under its lock.
    """

    def __init__(self, bins: int = 10, baseline_size: int = 2048):
        if bins < 2:
            raise ValueError(f"drift needs >= 2 bins, got {bins}")
        self.bins = int(bins)
        self.baseline_size = int(baseline_size)
        self._base_buf = np.empty(self.baseline_size)
        self._base_n = 0
        self._edges: Optional[np.ndarray] = None   # interior edges [bins-1]
        self._base_frac: Optional[np.ndarray] = None
        self._hist = np.zeros(self.bins, np.int64)
        self.window_count = 0

    @property
    def baseline_ready(self) -> bool:
        return self._edges is not None

    def reset_baseline(self) -> None:
        """Forget everything: a new model version is live (full swap)."""
        self._base_n = 0
        self._edges = None
        self._base_frac = None
        self._hist[:] = 0
        self.window_count = 0

    def _finalize_baseline(self) -> None:
        sample = self._base_buf[:self._base_n]
        qs = np.linspace(0.0, 1.0, self.bins + 1)[1:-1]
        self._edges = np.quantile(sample, qs)
        counts = np.bincount(
            np.searchsorted(self._edges, sample, side="right"),
            minlength=self.bins).astype(np.float64)
        self._base_frac = counts / counts.sum()

    def observe(self, scores: np.ndarray) -> int:
        """Accumulate a batch of raw margins.  Returns how many landed in
        the CURRENT window (rows consumed by baseline collection don't
        count toward window geometry)."""
        s = np.asarray(scores, np.float64)
        if self._edges is None:
            take = min(len(s), self.baseline_size - self._base_n)
            if take:
                self._base_buf[self._base_n:self._base_n + take] = s[:take]
                self._base_n += take
            if self._base_n >= self.baseline_size:
                self._finalize_baseline()
            s = s[take:]
            if not len(s):
                return 0
        self._hist += np.bincount(
            np.searchsorted(self._edges, s, side="right"),
            minlength=self.bins)
        self.window_count += len(s)
        return len(s)

    def take(self) -> Optional[DriftWindow]:
        """Close the current window: compute PSI/KS vs the baseline and
        reset the histogram (None when the baseline is not ready or the
        window is empty)."""
        if self._edges is None or self.window_count == 0:
            return None
        total = float(self._hist.sum())
        cur = self._hist / total
        b = np.maximum(self._base_frac, _EPS)
        c = np.maximum(cur, _EPS)
        psi = float(np.sum((c - b) * np.log(c / b)))
        ks = float(np.max(np.abs(np.cumsum(cur) - np.cumsum(self._base_frac))))
        out = DriftWindow(count=int(total), psi=psi, ks=ks,
                          fractions=cur.tolist())
        self._hist[:] = 0
        self.window_count = 0
        return out
