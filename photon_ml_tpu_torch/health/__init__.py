"""Live model health: streaming calibration, drift detection, and
health-gated online updates (port of photon_ml_tpu/health/: host numpy,
so window statistics, gate trips and rollbacks follow the JAX package's).

The online tier (photon_ml_tpu_torch/online/) rewrites the live model from its
own traffic; this package watches whether those continuous updates — or
the traffic itself — are degrading the model, and GATES the update loop
on the verdict:

  - `calibration.StreamingCalibration` — O(bins) streaming Hosmer–
    Lemeshow over probability deciles, same per-bin algebra as the
    offline `diagnostics/hl.py` (which stays the parity oracle).
  - `drift.DriftDetector` — score-distribution PSI + binned KS against a
    baseline histogram snapshotted at each `ModelRegistry.install()`
    (reset on swap, carried across deltas).
  - `monitor.HealthMonitor` — window clocks, sliding loss/AUC, delta-
    magnitude/freeze-rate vitals, and the gate state machine: sustained
    breaches flip /healthz to degraded, pause the OnlineUpdater, and
    (per config) trigger the delta-aware rollback; sustained recovery
    resumes updates.
  - `config.HealthConfig` — thresholds + window geometry
    (`cli.serve --health-config`).

Wire-up: `ScoringService(..., health=HealthConfig())`; metrics ride the
serving Prometheus text + JSON surfaces as the `health.*` family, and
every window evaluation is a telemetry span with trip/recovery events.
"""
from photon_ml_tpu_torch.health.calibration import (  # noqa: F401
    CalibrationWindow, StreamingCalibration,
)
from photon_ml_tpu_torch.health.config import GATE_NAMES, HealthConfig  # noqa: F401
from photon_ml_tpu_torch.health.drift import DriftDetector, DriftWindow  # noqa: F401
from photon_ml_tpu_torch.health.monitor import HealthMonitor  # noqa: F401
