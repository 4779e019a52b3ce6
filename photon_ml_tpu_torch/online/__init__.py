"""Online learning tier (port of photon_ml_tpu/online/, in part).

`delta.ModelDelta` — the changed rows of the stacked random-effect tables
plus a version vector; `serving.ModelRegistry.apply_delta` scatters them
into the live scorer's tables under the registry lock and `rollback()`
restores the exact pre-delta rows.  The feedback buffer and the background
updater (`feedback.py`, `updater.py`) wait for ROADMAP.md queue A item 22.
"""
from photon_ml_tpu_torch.online.delta import CoordinateDelta, ModelDelta  # noqa: F401
