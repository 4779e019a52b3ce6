"""Online scoring subsystem (port of photon_ml_tpu/serving/): low-latency
request/response GAME inference on one CUDA device.

  - `scorer.CompiledScorer` — a GAME model directory loaded into
    device-resident tensors (fixed-effect coefficients, stacked
    random-effect tables with host-side id->row hash maps, MF factors),
    scoring each request chunk padded to a power-of-two bucket in one
    host-to-device copy and one pass of torch ops.
  - `batcher.MicroBatcher` — dynamic micro-batching: concurrent score()
    calls coalesce into one padded device call, with max-wait / max-batch
    knobs and load shedding (`Overloaded`, `DeadlineExceeded`).
  - `registry.ModelRegistry` — versioned scorers with zero-downtime hot
    swap, row-level delta swaps (`apply_delta`) and delta-aware rollback
    (exact pre-delta rows restored).
  - `service.ScoringService` — the assembled in-process service, with
    `metrics.ServingMetrics` observability (latency percentiles, batch
    occupancy, entity hit-rate, shed counts, model staleness) and
    ScoringBatchEvent/ModelSwapEvent/ModelDeltaEvent hooks
    (utils/events.py).

The online updater on top of this package is photon_ml_tpu_torch/online/
(`ScoringService(updates=...)`), the health monitor
photon_ml_tpu_torch/health/ (`ScoringService(health=...)`), and the
replica runtime and the routing front photon_ml_tpu_torch/fleet/.

CLI entrypoint: `python -m photon_ml_tpu_torch.cli.serve`.
"""
from photon_ml_tpu_torch.serving.batcher import (  # noqa: F401
    BatcherConfig, DeadlineExceeded, MicroBatcher, Overloaded, ServingError,
)
from photon_ml_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from photon_ml_tpu_torch.serving.registry import (  # noqa: F401
    ModelRegistry, StaleDeltaError,
)
from photon_ml_tpu_torch.serving.scorer import CompiledScorer  # noqa: F401
from photon_ml_tpu_torch.serving.service import (  # noqa: F401
    ScoringService, ServingConfig,
)
