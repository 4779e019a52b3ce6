"""Flight recorder: the last N seconds of every process, on disk before
anyone asks (a copy of photon_ml_tpu/telemetry/flight.py).

Postmortems of a serving fleet die on a timing problem: the interesting
window is the seconds BEFORE the health gate tripped / the replica was
marked unhealthy / the process caught SIGTERM, and by the time an operator
attaches, that window is gone.  The flight recorder keeps it resident: an
always-on BOUNDED ring of recent telemetry records (closed spans, instant
events, and photon log lines), fed by the armed tracer's observer tap
(`core.set_observer`) and a logging handler — and dumps the whole ring to
a durable, correlated bundle when a registered trigger fires.

DISARM SEMANTICS (the `faults.fire()` contract): with no recorder
installed, `trigger()`/`record_event()` are a module-global None check and
return.  Armed, a record is one deque append (O(1), bounded memory).

TRIGGERS is the registry of dump reasons, the flight twin of
`utils.faults.SITES`: every trigger name must have a telemetry event
constant in `telemetry/events.py` (a port test diffs the registries), so
the trigger taxonomy cannot drift from the event vocabulary operators
grep for.

Correlation across processes: a trigger mints a `trigger_id`; the fleet
front broadcasts it (`POST /flight/dump`) to every reachable replica when
it fires a fleet-level trigger (a replica leaving rotation), so the
bundles from all live processes share the id and can be laid side by
side.  Bundle files are written atomically (`utils.durable`) as
`flight-<trigger_id>-<proc>-<pid>.json`.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch.telemetry import core as _core

logger = logging.getLogger("photon_ml_tpu_torch")

#: registered dump triggers: name -> what fires it.  The flight twin of
#: `utils.faults.SITES` — every name here must have a telemetry event
#: constant in telemetry/events.py.
TRIGGERS: Dict[str, str] = {
    "health.gate_trip": "a model-health gate tripped (health/monitor.py)",
    "replica.failed": "a replica marked itself failed (fatal apply)",
    "replica.unhealthy": "the front took a replica out of rotation",
    "model.rollback": "a model rollback executed on the live registry",
    "serve.drain": "SIGTERM graceful drain of a serving process",
    "serve.crash": "a serving process is dying on an unhandled error",
    "shard.lost": "an entity shard's last healthy replica left rotation",
}

#: default ring capacity (records, not bytes): spans + events + log lines
RING_RECORDS = 4096

#: log-line length cap inside the ring (tracebacks can be huge)
MAX_LOG_CHARS = 500


class _RingLogHandler(logging.Handler):
    """Feeds photon log lines into the recorder ring (WARNING+ by
    default: the anomaly trail, not the request firehose)."""

    def __init__(self, recorder: "FlightRecorder",
                 level: int = logging.WARNING):
        super().__init__(level=level)
        self._recorder = recorder

    def emit(self, record):
        try:
            msg = record.getMessage()
            if len(msg) > MAX_LOG_CHARS:
                msg = msg[:MAX_LOG_CHARS] + "..."
            self._recorder._append({
                "kind": "log", "level": record.levelname,
                "logger": record.name, "message": msg,
                "wall_s": record.created})
        except Exception:  # observability must never kill the observed
            pass


class FlightRecorder:
    """One process's bounded ring + dump machinery.  Install via
    `flight.install(dump_dir, proc=...)`; all methods are thread-safe."""

    def __init__(self, dump_dir: Optional[str] = None,
                 proc: str = "proc", ring_records: int = RING_RECORDS,
                 log_level: int = logging.WARNING):
        self.dump_dir = dump_dir
        self.proc = proc
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=int(ring_records))
        self.dumps = 0
        self.recorded = 0
        self._log_handler = _RingLogHandler(self, level=log_level)
        logger.addHandler(self._log_handler)

    # -- recording (the hot path) ------------------------------------------

    def _append(self, record: dict) -> None:
        with self._lock:
            self._ring.append(record)
            self.recorded += 1

    def observe(self, kind: str, record: dict, tracer) -> None:
        """The tracer observer tap (core.set_observer): closed spans and
        instant events land in the ring stamped with wall time."""
        rel = record.get("t0_s", record.get("t_s", 0.0))
        self._append({"kind": kind, "wall_s": tracer._wall0 + rel,
                      **{k: v for k, v in record.items()
                         if k not in ("kind",)}})

    def record_event(self, name: str, **attrs) -> None:
        """A recorder-only instant (used by trigger paths so the ring
        itself documents why it was dumped)."""
        self._append({"kind": "event", "name": name, "wall_s": time.time(),
                      "attrs": {k: str(v) for k, v in attrs.items()}})

    # -- dumping ------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, trigger_id: str,
             attrs: Optional[dict] = None) -> Optional[str]:
        """Write the ring to a durable bundle; returns the path (None
        when no dump_dir is configured — the ring stays in memory).
        Never raises: a failing dump logs and returns None."""
        from photon_ml_tpu_torch import telemetry
        from photon_ml_tpu_torch.utils import durable
        records = self.snapshot()
        bundle = {
            "format_version": 1,
            "reason": reason,
            "trigger_id": trigger_id,
            "proc": self.proc,
            "pid": self.pid,
            "dumped_at_unix_s": time.time(),
            "attrs": {k: str(v) for k, v in (attrs or {}).items()},
            "window_s": ([min(r.get("wall_s", 0.0) for r in records),
                          max(r.get("wall_s", 0.0) for r in records)]
                         if records else None),
            "records": records,
            "metrics": telemetry.snapshot(),
        }
        with self._lock:
            self.dumps += 1
        if self.dump_dir is None:
            logger.warning("flight recorder: trigger %r (%s) fired but no "
                           "dump directory is configured — the ring stays "
                           "in memory only", reason, trigger_id)
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-{trigger_id}-{self.proc}-{self.pid}.json")
            durable.atomic_write_json(path, bundle)
            logger.warning("flight recorder: dumped %d record(s) to %s "
                           "(reason=%s)", len(records), path, reason)
            return path
        except Exception as e:  # a failing dump must not kill the trigger
            logger.error("flight recorder: dump for %r FAILED: %s",
                         reason, e)
            return None

    def close(self) -> None:
        logger.removeHandler(self._log_handler)


# -- process-global activation (faults.install_plan-style) --------------------

_ACTIVE: Optional[FlightRecorder] = None


def active_recorder() -> Optional[FlightRecorder]:
    return _ACTIVE


def armed() -> bool:
    return _ACTIVE is not None


def install(dump_dir: Optional[str] = None, proc: str = "proc",
            ring_records: int = RING_RECORDS,
            log_level: int = logging.WARNING) -> FlightRecorder:
    """Arm the flight recorder process-globally (last-wins) and tap the
    tracer's record stream."""
    global _ACTIVE
    prev = _ACTIVE
    recorder = FlightRecorder(dump_dir=dump_dir, proc=proc,
                              ring_records=ring_records,
                              log_level=log_level)
    _ACTIVE = recorder
    _core.set_observer(recorder.observe)
    if prev is not None:
        prev.close()
    return recorder


def shutdown() -> Optional[FlightRecorder]:
    global _ACTIVE
    recorder, _ACTIVE = _ACTIVE, None
    _core.set_observer(None)
    if recorder is not None:
        recorder.close()
    return recorder


class enabled:
    """`with flight.enabled(dump_dir) as rec:` — scoped arming."""

    def __init__(self, dump_dir: Optional[str] = None, proc: str = "proc",
                 ring_records: int = RING_RECORDS):
        self._kw = dict(dump_dir=dump_dir, proc=proc,
                        ring_records=ring_records)

    def __enter__(self) -> FlightRecorder:
        self.recorder = install(**self._kw)
        return self.recorder

    def __exit__(self, *exc):
        if _ACTIVE is self.recorder:
            shutdown()
        else:
            self.recorder.close()


def new_trigger_id(reason: str) -> str:
    """Trigger ids are sortable and collision-safe across one fleet:
    millisecond wall time + pid (the minting process's)."""
    safe = reason.replace(".", "-")
    return f"{safe}-{int(time.time() * 1e3)}-{os.getpid()}"


def trigger(reason: str, trigger_id: Optional[str] = None,
            **attrs) -> Optional[str]:
    """Fire a registered trigger: record it in the ring, emit the
    matching telemetry event, dump the bundle.  Zero-cost disarmed
    (module-global None check).  Returns the bundle path (or None)."""
    recorder = _ACTIVE
    if recorder is None:
        return None
    if reason not in TRIGGERS:
        raise ValueError(
            f"unknown flight trigger {reason!r} — register it in "
            f"telemetry.flight.TRIGGERS (known: {sorted(TRIGGERS)})")
    tid = trigger_id or new_trigger_id(reason)
    from photon_ml_tpu_torch import telemetry
    telemetry.event("flight_dump", reason=reason, trigger_id=tid,
                    **{k: str(v) for k, v in attrs.items()})
    recorder.record_event("flight_dump", reason=reason, trigger_id=tid,
                          **attrs)
    return recorder.dump(reason, tid, attrs=attrs)
