from photon_ml_tpu_torch.utils.events import (  # noqa: F401
    Event, EventEmitter, EventListener, LoggingEventListener,
    OptimizationLogEvent, SetupEvent, TrainingFinishEvent, TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.faults import (  # noqa: F401
    EXIT_PREEMPTED, FatalFault, FaultPlan, FaultSpec, GracefulPreemption,
    Preempted, TransientFault, is_transient,
)
