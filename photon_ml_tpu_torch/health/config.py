"""HealthConfig: the knobs of the live model-health layer (a copy of
photon_ml_tpu/health/config.py).

Every threshold is Optional — None disables that gate — so an operator can
run pure drift monitoring (no labels needed), pure calibration monitoring,
or the full set.  Windows are COUNT-based (labeled rows / scored rows),
never wall-clock, so detection latency is deterministic under replay and
the bench can gate "tripped within <= 3 evaluation windows" exactly.

`cli.serve --health-config` takes this as inline JSON or `@file`
(`from_dict` rejects unknown keys loudly — a typo'd threshold must not
silently disarm a gate).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: every gate the monitor can evaluate, in report order
GATE_NAMES = ("calibration", "drift_psi", "drift_ks", "auc", "loss",
              "delta_l2", "freeze_rate")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Model-health gates + window geometry (cli.serve --health-config)."""

    # -- window geometry ----------------------------------------------------
    window_labels: int = 256      # labeled rows per calibration/loss window
    window_scores: int = 4096     # scored rows per drift window
    baseline_scores: int = 2048   # baseline reservoir collected per install
    calibration_bins: int = 10    # probability deciles (hl.py formula)
    drift_bins: int = 10          # baseline-quantile score bins
    sustain_windows: int = 2      # consecutive breaches that trip a gate
    recovery_windows: int = 2     # consecutive clean windows that recover

    # -- gate thresholds (None = gate disabled) -----------------------------
    calibration_p_min: Optional[float] = 1e-3  # HL p-value floor
    psi_max: Optional[float] = 0.25            # population stability index
    ks_max: Optional[float] = 0.2              # binned KS statistic
    auc_min: Optional[float] = None            # window AUC floor
    loss_max: Optional[float] = None           # window mean-loss ceiling
    delta_l2_max: Optional[float] = None       # max per-row delta L2/window
    freeze_max: Optional[int] = None           # frozen entities per window

    # -- actions on a tripped gate ------------------------------------------
    pause_updates: bool = True                 # pause the OnlineUpdater
    rollback_on: Tuple[str, ...] = ()          # gates that also trigger the
    #                                            delta-aware rollback

    def __post_init__(self):
        for name in ("window_labels", "window_scores", "baseline_scores",
                     "calibration_bins", "drift_bins", "sustain_windows",
                     "recovery_windows"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"HealthConfig.{name} must be >= 1")
        object.__setattr__(self, "rollback_on", tuple(self.rollback_on))
        unknown = set(self.rollback_on) - set(GATE_NAMES)
        if unknown:
            raise ValueError(
                f"HealthConfig.rollback_on names unknown gate(s) "
                f"{sorted(unknown)} (gates: {list(GATE_NAMES)})")

    @classmethod
    def from_dict(cls, d: dict) -> "HealthConfig":
        if not isinstance(d, dict):
            raise ValueError("health config must be a JSON object")
        allowed = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - allowed
        if bad:
            raise ValueError(f"health config: unknown key(s) {sorted(bad)} "
                             f"(allowed: {sorted(allowed)})")
        return cls(**d)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["rollback_on"] = list(self.rollback_on)
        return out

    def thresholds(self) -> dict:
        """gate name -> threshold (None = disabled), in GATE_NAMES order."""
        return {
            "calibration": self.calibration_p_min,
            "drift_psi": self.psi_max,
            "drift_ks": self.ks_max,
            "auc": self.auc_min,
            "loss": self.loss_max,
            "delta_l2": self.delta_l2_max,
            "freeze_rate": (None if self.freeze_max is None
                            else float(self.freeze_max)),
        }
