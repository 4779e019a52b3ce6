"""Online learning tier (port of photon_ml_tpu/online/): per-entity
random-effect updates into the live scorer, without a full refit or a
full-model cutover.

  - `feedback.FeedbackBuffer` — bounded intake coalescing labeled
    observations per (coordinate, entity), backpressure -> Overloaded,
    per-entity dedup window (a host-only copy).
  - `updater.OnlineUpdater` — background loop draining touched entities
    into the batched RE solver's padded pow-2 layout at micro-batch size,
    each entity's subproblem ANCHORED at its current coefficients
    (game/anchored.py); non-finite solves freeze the entity (never the
    live table); fault sites `online.solve` / `online.publish` retry
    transiently.
  - `delta.ModelDelta` — the changed rows of the stacked RE tables + a
    version vector; `serving.ModelRegistry.apply_delta` scatters them
    into the live scorer's tables under the registry lock and
    `rollback()` restores the exact pre-delta rows.

Wire-up: `ScoringService(..., updates=OnlineUpdateConfig())` or
`cli.serve --enable-updates` (POST /feedback); delta persistence lives in
models/io.py (`save_model_delta` / `load_model_delta`).
"""
from photon_ml_tpu_torch.online.delta import CoordinateDelta, ModelDelta  # noqa: F401
from photon_ml_tpu_torch.online.feedback import (  # noqa: F401
    EntityFeedback, FeedbackBuffer, Observation,
)
from photon_ml_tpu_torch.online.updater import (  # noqa: F401
    OnlineUpdateConfig, OnlineUpdater,
)
