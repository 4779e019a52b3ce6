"""Observer-style event hooks for external training consumers (a copy of
photon_ml_tpu/utils/events.py).

Rebuild of photon-client/.../event/{Event,EventEmitter,EventListener}.scala:
typed events (setup, training start/finish, per-model optimization log —
Event.scala:36-60) fanned out to registered listeners.  Listener exceptions
are ISOLATED per listener (log + continue, EventEmitter sendEvent wraps
each handle in Try): one broken consumer can neither kill training nor
starve the listeners registered after it — tests/test_telemetry.py pins
this down.

Every emitted event is also routed into the telemetry run log (when the
tracer is armed) tagged with the ACTIVE SPAN ID, so an
OptimizationLogEvent or ScoringBatchEvent lands in the same timeline as
the spans and fault/quarantine records it belongs to.

Listeners can be registered programmatically or by dotted class path (the
reference registers listener class names from CLI flags, Driver.scala:
108-118).
"""
from __future__ import annotations

import dataclasses
import importlib
import logging
import threading
from typing import Any, Dict, List, Optional

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Event:
    """Base event (reference: Event.scala)."""


@dataclasses.dataclass
class SetupEvent(Event):
    """reference: PhotonSetupEvent — carries the run configuration."""

    params: Dict[str, Any]


@dataclasses.dataclass
class TrainingStartEvent(Event):
    time: float


@dataclasses.dataclass
class TrainingFinishEvent(Event):
    time: float


@dataclasses.dataclass
class OptimizationLogEvent(Event):
    """reference: PhotonOptimizationLogEvent — per trained model: the
    regularization weights used, convergence histories, and final metrics."""

    regularization_weights: Dict[str, float]
    objective_history: List[float]
    final_metrics: Dict[str, float]


@dataclasses.dataclass
class ScoringBatchEvent(Event):
    """One coalesced serving device-batch (serving/): how many concurrent
    requests were batched, how full the padded bucket was, and where the
    time went — the observability hook for the online scoring service."""

    time: float
    num_requests: int
    num_rows: int
    bucket_size: int
    queue_wait_s: float
    score_s: float
    model_version: Optional[str] = None


@dataclasses.dataclass
class ModelSwapEvent(Event):
    """A serving hot swap (or rollback): the registry atomically replaced
    the live scorer; in-flight batches finished on the previous version."""

    time: float
    version: str
    previous_version: Optional[str]
    action: str = "swap"  # "swap" | "rollback" | "delta_rollback"
    warmup_s: float = 0.0


@dataclasses.dataclass
class ModelDeltaEvent(Event):
    """A row-level delta swap (serving/online): changed rows of the live
    scorer's stacked random-effect tables were scattered in place under
    the registry lock — no full-model cutover."""

    time: float
    version: str
    delta_seq: int
    coordinates: Dict[str, int]     # coordinate -> rows updated
    num_rows: int
    publish_s: float = 0.0


class EventListener:
    """reference: EventListener.scala — handle() + close()."""

    def handle(self, event: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoggingEventListener(EventListener):
    """Default listener: events into the standard logging stream."""

    def handle(self, event: Event) -> None:
        _log.info("%s", event)


class EventEmitter:
    """reference: EventEmitter.scala — thread-safe register/clear/send with
    listener exceptions contained."""

    def __init__(self):
        from photon_ml_tpu_torch.utils import locktrace
        self._lock = locktrace.tracked(threading.Lock(),
                                       "EventEmitter._lock")
        self._listeners: List[EventListener] = []

    def register_listener(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def register_listener_class(self, dotted_path: str) -> None:
        """'pkg.module.ClassName' -> instantiate and register (reference:
        Driver.scala:108-118 registering listeners by class name).  The path
        comes straight from a CLI flag, so failures name the offending path
        instead of surfacing a bare AttributeError/ImportError."""
        module_name, _, cls_name = dotted_path.rpartition(".")
        if not module_name:
            raise ValueError(
                f"event-listener path {dotted_path!r} is not a dotted "
                "'pkg.module.ClassName' path")
        try:
            module = importlib.import_module(module_name)
        except ImportError as e:
            raise ValueError(
                f"cannot import module {module_name!r} from event-listener "
                f"path {dotted_path!r}: {e}") from e
        try:
            cls = getattr(module, cls_name)
        except AttributeError:
            raise ValueError(
                f"module {module_name!r} has no attribute {cls_name!r} "
                f"(from event-listener path {dotted_path!r})") from None
        self.register_listener(cls())

    def clear_listeners(self) -> None:
        # swap the list under the lock, close OUTSIDE it: listener close
        # hooks are arbitrary consumer code, and running them while
        # holding the emitter lock would nest foreign locks inside it
        with self._lock:
            doomed, self._listeners = self._listeners, []
        for listener in doomed:
            try:
                listener.close()
            except Exception:
                _log.exception("event listener close failed")

    def send_event(self, event: Event) -> None:
        _route_to_telemetry(event)
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            # isolation contract: a listener that raises is logged and the
            # REMAINING listeners still receive the event (only exiting-
            # process exceptions propagate)
            try:
                listener.handle(event)
            except Exception:
                _log.exception("event listener failed on %s", type(event).__name__)


def _route_to_telemetry(event: Event) -> None:
    """Emitted event -> telemetry run-log record with the active span id
    (no-op when the tracer is disarmed).  Field values are flattened to
    JSON-safe scalars; containers collapse to their sizes (an
    OptimizationLogEvent's whole objective history belongs in the result
    object, not in every run-log line)."""
    from photon_ml_tpu_torch import telemetry
    tracer = telemetry.active_tracer()
    if tracer is None:
        return
    attrs = {}
    for f in dataclasses.fields(event):
        v = getattr(event, f.name)
        if isinstance(v, (bool, int, float, str)) or v is None:
            attrs[f.name] = v
        elif isinstance(v, (list, tuple, dict)):
            attrs[f.name + "_len"] = len(v)
        else:
            attrs[f.name] = str(v)
    tracer.event("emitted." + type(event).__name__, attrs)
