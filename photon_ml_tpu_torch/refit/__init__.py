"""Continuous training: replication-log exhaust -> compacted dataset ->
warm refit -> fleet swap (port of photon_ml_tpu/refit/).

The closed loop that turns five shipped subsystems into one self-healing
production system: the durable feedback lane
(fleet/replog.py FeedbackLog) is replayed by a LogCompactor into sealed,
sha256'd training chunk files; a RefitDriver runs a warm-started GAME
fit anchored on the current serving model, validates the candidate
against the incumbent on a held-back tail of the log, and publishes a
winner through ModelRegistry.install() so it rides the replication log
to the whole fleet as an ordinary swap (rollback intact); a RefitTrigger
decides WHEN — manual one-shot, cron-style interval, or automatically on
a sustained health-gate trip.  See COMPONENTS.md "Continuous training".
On a CUDA registry the fixed-effect pass of a dense fixed effect runs
the hand-written fused value-and-gradient kernel
(csrc/fused_value_and_gradient.cu), one launch per pass.
"""
from photon_ml_tpu_torch.refit.compactor import (CompactedDataset,  # noqa: F401
                                           CompactionError, CompactorConfig,
                                           LogCompactor)
from photon_ml_tpu_torch.refit.driver import (RefitConfig, RefitDriver,  # noqa: F401
                                        RefitError, RefitResult)
from photon_ml_tpu_torch.refit.trigger import (RefitTrigger,  # noqa: F401
                                         TriggerConfig)
