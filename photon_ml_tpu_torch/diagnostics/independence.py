"""Kendall-tau independence analysis between two paired samples (a
host-numpy copy of photon_ml_tpu/diagnostics/independence.py).

Rebuild of photon-diagnostics/.../independence/KendallTauAnalysis.scala:35-131:
concordant/discordant/tied pair counts -> tau-alpha, tau-beta, z score, and a
two-sided normal probability.  The reference samples down to ~sqrt(n) points
then forms the full Cartesian pair set through a Spark shuffle; here the
subsample's pair comparison is one numpy broadcast.

Used to test whether prediction errors are independent of the predictions
(the legacy driver pairs (prediction, error)).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class KendallTauReport:
    num_concordant: int
    num_discordant: int
    num_items: int
    num_pairs: int
    effective_pairs: int
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    p_value: float          # two-sided mass inside |z| (reference convention)
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def kendall_tau_analysis(a, b, max_items: int = 2000, seed: int = 7
                         ) -> KendallTauReport:
    """reference: KendallTauAnalysis.analyze (pair classification at
    checkConcordance, scala:104-131; statistics at scala:64-90)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) != len(b):
        raise ValueError("paired samples must have equal length")
    n_all = len(a)
    # reference rate = min(1, sqrt(n)/n) -> expected sample ~sqrt(n); a floor
    # of 200 is added (deliberate divergence) so small inputs keep enough
    # pairs for a meaningful z-score, and max_items caps the O(m^2) compare
    target = min(n_all, max_items, max(200, int(math.sqrt(n_all))))
    if n_all > target:
        idx = np.random.default_rng(seed).choice(n_all, size=target, replace=False)
        a, b = a[idx], b[idx]
    m = len(a)

    da = np.sign(a[:, None] - a[None, :])
    db = np.sign(b[:, None] - b[None, :])
    iu = np.triu_indices(m, k=1)
    da, db = da[iu], db[iu]
    concordant = int(np.sum((da != 0) & (da == db)))
    discordant = int(np.sum((da != 0) & (db != 0) & (da != db)))
    ties_a = int(np.sum(da == 0))
    ties_b = int(np.sum((da != 0) & (db == 0)))

    num_pairs = m * (m - 1) // 2
    no_ties_a = num_pairs - ties_a
    no_ties_b = num_pairs - ties_b
    cd = concordant + discordant
    tau_alpha = (concordant - discordant) / cd if cd else 0.0
    denom = math.sqrt(float(no_ties_a) * float(no_ties_b))
    tau_beta = (concordant - discordant) / denom if denom else 0.0
    var_num = 2.0 * (2.0 * m + 5.0)
    var_den = 9.0 * m * (m - 1)
    d = math.sqrt(var_num / var_den) if var_den > 0 else 1.0
    z_alpha = tau_alpha / d
    p_value = math.erf(abs(z_alpha) / math.sqrt(2.0))

    msg = ""
    if ties_a + ties_b > 0:
        msg = (f"detected ties (A: {ties_a}, B: {ties_b}); the tau-alpha "
               "z-score over-estimates independence")
    return KendallTauReport(concordant, discordant, m, num_pairs, cd,
                            tau_alpha, tau_beta, z_alpha, p_value, msg)
