"""Span tracer: hierarchical, thread-aware run timelines with fault-style
disarm semantics (a copy of photon_ml_tpu/telemetry/core.py).

  * `span(name, **attrs)` — a context manager producing one node of a
    hierarchical trace.  Spans nest per THREAD (thread-local stacks), so
    the training loop, the streaming Prefetcher and the AsyncCheckpointer
    writer each get their own track with correct parent/child edges
    inside it.
  * `push(name, **attrs)` / `pop(handle)` — the explicit form for regions
    that cannot wrap a `with` block (the descent loop's outer-iteration /
    coordinate-visit levels).  `pop` is self-healing: it closes any spans
    left open below its handle, and `Tracer.finish()` closes whatever an
    exception path abandoned, so a preempted fit still exports a complete
    timeline.
  * `event(name, **attrs)` — an instant event attached to the CURRENT
    span (fault injections, quarantine rollbacks, checkpoint recoveries,
    EventEmitter events); the span id correlates it with the JSONL run
    log and the Chrome trace.
  * the compile watch — the port compiles no graphs; what it builds at
    run time is its CUDA kernels.  `ops/_build.py` reports each nvcc build
    and each library load to `note_kernel_library`; while a watching
    tracer is armed, each report becomes a `compile` instant event (the
    library's name and whether nvcc ran) and increments the
    `kernel.builds_and_loads` counter that `retrace_count()` reads (the
    JAX package's `jax.retraces`).  A warm fit shows 0 at every visit.

DISARM SEMANTICS (the contract the hot paths rely on, same discipline as
`utils.faults.fire`): with no tracer installed, `span()` is a module-global
None check returning a shared no-op singleton — no span objects, no list
appends, nothing on the device hot path.  Armed tracing touches HOST
values only (names, ints, floats); call sites never pass a device tensor
(`_json_safe` would `str()` it, which reads it back), so tracing adds no
synchronization.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch.telemetry import metrics as _metrics

logger = logging.getLogger("photon_ml_tpu_torch")

#: hard cap on retained finished spans/events; beyond it the tracer counts
#: drops instead of growing without bound (a week-long serving process must
#: not OOM on its own observability)
MAX_RECORDS = 200_000

#: attr-value length cap in exported records
MAX_ATTR_CHARS = 400

#: the registry counter of kernel builds and library loads seen while a
#: watching tracer was armed (the JAX package counts XLA compiles as
#: `jax.retraces`)
BUILD_COUNTER = "kernel.builds_and_loads"


class SpanRecord:
    """One span: identity + tree edges + timing.  `t0`/`dur_s` are
    perf-counter seconds relative to the tracer's start."""

    __slots__ = ("span_id", "parent_id", "name", "attrs", "tid",
                 "thread_name", "t0", "dur_s", "_tracer")

    def __init__(self, tracer, span_id, parent_id, name, attrs, tid,
                 thread_name, t0):
        self._tracer = tracer
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.tid = tid
        self.thread_name = thread_name
        self.t0 = t0
        self.dur_s: Optional[float] = None  # None while open


class _NoopSpan:
    """The shared disarmed span: a no-op context manager.  There is ONE
    instance per process — `span()` disarmed allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """Armed `span()` context manager: push on enter, pop on exit."""

    __slots__ = ("_tracer", "_name", "_attrs", "_record")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> SpanRecord:
        self._record = self._tracer.push(self._name, self._attrs)
        return self._record

    def __exit__(self, *exc):
        self._tracer.pop(self._record)
        return False


def _json_safe(value):
    if isinstance(value, (bool, int, float)) or value is None:
        return value
    s = str(value)
    return s if len(s) <= MAX_ATTR_CHARS else s[:MAX_ATTR_CHARS] + "..."


class Tracer:
    """One armed tracing session.  Created/installed via
    `telemetry.install()`; all recording methods are thread-safe.

    `proc` is the process's ROLE label ("train", "front", "replica",
    "publisher", ...) — multi-process trace merging (`telemetry.
    distributed`) keys per-process timelines on the (proc, pid) pair the
    run log's leading `meta` record carries."""

    def __init__(self, run_log: Optional[str] = None,
                 watch_compiles: bool = True,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 max_records: int = MAX_RECORDS,
                 proc: Optional[str] = None):
        self.registry = registry or _metrics.default_registry()
        self.retrace_counter = self.registry.counter(BUILD_COUNTER)
        self.proc = proc or "proc"
        self.pid = os.getpid()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 1
        self._max_records = max_records
        self.spans: List[SpanRecord] = []      # finished spans
        self.events: List[dict] = []           # instant events
        self.dropped = 0
        self._open_count = 0
        self._finished = False
        self._run_log_path = run_log
        self._run_log = None
        if run_log is not None:
            d = os.path.dirname(os.path.abspath(run_log))
            os.makedirs(d, exist_ok=True)
            # LINE-buffered: a SIGKILLed process's log keeps every record
            # written before the kill (the merge tool and the flight
            # recorder exist precisely for those last seconds — a block-
            # buffered tail would lose them)
            self._run_log = open(run_log, "a", encoding="utf-8",
                                 buffering=1)
            # the merge tool anchors this process's perf-counter timeline
            # (and names its Perfetto process track) from this record
            self._log_record({
                "kind": "meta", "name": "process_meta", "span": None,
                "proc": self.proc, "pid": self.pid,
                "wall0_unix_s": self._wall0})
        # the compile watch: kernel builds/loads reported by ops/_build.py
        # (note_kernel_library) become events while this tracer is armed
        self.watch_compiles = bool(watch_compiles)

    # -- span stack --------------------------------------------------------

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def current_span(self) -> Optional[SpanRecord]:
        stack = self._stack()
        return stack[-1] if stack else None

    def push(self, name: str, attrs: Optional[dict] = None) -> SpanRecord:
        stack = self._stack()
        thread = threading.current_thread()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            self._open_count += 1
        record = SpanRecord(
            self, span_id,
            stack[-1].span_id if stack else None,
            name, attrs or {}, thread.ident, thread.name, self.now())
        stack.append(record)
        return record

    def pop(self, record: Optional[SpanRecord]) -> None:
        """Close `record` (and any deeper spans its scope abandoned — an
        exception between push and pop must not corrupt the stack)."""
        if record is None or record.dur_s is not None:
            return
        stack = self._stack()
        if record not in stack:
            # foreign thread / already healed: close it standalone
            self._close(record)
            return
        while stack:
            top = stack.pop()
            self._close(top)
            if top is record:
                return

    def _close(self, record: SpanRecord) -> None:
        record.dur_s = max(self.now() - record.t0, 0.0)
        with self._lock:
            self._open_count -= 1
            if len(self.spans) < self._max_records:
                self.spans.append(record)
            else:
                self.dropped += 1
        line = {
            "kind": "span", "name": record.name, "span": record.span_id,
            "parent": record.parent_id, "tid": record.tid,
            "thread": record.thread_name,
            "t0_s": round(record.t0, 6), "dur_s": round(record.dur_s, 6),
            "attrs": {k: _json_safe(v) for k, v in record.attrs.items()},
        }
        self._log_record(line)
        self._notify_observer("span", line)

    def span(self, name: str, attrs: Optional[dict] = None) -> _Span:
        return _Span(self, name, attrs or {})

    # -- instant events ----------------------------------------------------

    def event(self, name: str, attrs: Optional[dict] = None) -> None:
        current = self.current_span()
        record = {
            "kind": "event", "name": name,
            "span": current.span_id if current is not None else None,
            "tid": threading.current_thread().ident,
            "t_s": round(self.now(), 6),
            "attrs": {k: _json_safe(v) for k, v in (attrs or {}).items()},
        }
        with self._lock:
            if len(self.events) < self._max_records:
                self.events.append(record)
            else:
                self.dropped += 1
        self._log_record(record)
        self._notify_observer("event", record)

    def _notify_observer(self, kind: str, record: dict) -> None:
        obs = _OBSERVER
        if obs is None:
            return
        try:
            obs(kind, record, self)
        except Exception:  # an observer must never kill the traced code
            pass

    # -- run log -----------------------------------------------------------

    def _log_record(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"))
        # the handle is read AND written under the lock: finish() swaps it
        # to None concurrently with producer threads logging
        with self._lock:
            f = self._run_log
            if f is None:
                return
            try:
                f.write(line + "\n")
            except ValueError:  # closed mid-shutdown race: drop, not crash
                pass

    # -- lifecycle ---------------------------------------------------------

    def finish(self) -> None:
        """Close abandoned spans (exception paths), stop the compile
        watch, flush + close the run log.  Idempotent."""
        if self._finished:
            return
        self._finished = True
        # heal this thread's stack; other threads' open spans are closed
        # from their records at export time (chrome export treats open
        # spans as ending now)
        stack = getattr(self._tls, "stack", None)
        while stack:
            self._close(stack.pop())
        with self._lock:
            if self._run_log is not None:
                try:
                    self._run_log.flush()
                    self._run_log.close()
                finally:
                    self._run_log = None

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"spans": len(self.spans), "events": len(self.events),
                    "open_spans": self._open_count,
                    "dropped": self.dropped,
                    "run_log": self._run_log_path,
                    "proc": self.proc,
                    "wall0_unix_s": self._wall0}


# -- process-global activation (faults.install_plan-style) --------------------

_ACTIVE: Optional[Tracer] = None
_LAST: Optional[Tracer] = None   # kept for export after shutdown

#: one process-global record observer (the flight recorder's tap): called
#: as fn(kind, record_dict, tracer) on every closed span / instant event
#: of whichever tracer is armed.  A plain module global, same disarm
#: discipline as _ACTIVE — the armed hot path pays one None check.
_OBSERVER = None


def set_observer(fn) -> None:
    """Install (or clear, with None) the process-global record observer.
    Last-wins, like install(); telemetry.flight owns the only production
    observer."""
    global _OBSERVER
    _OBSERVER = fn


def active_tracer() -> Optional[Tracer]:
    return _ACTIVE


def last_tracer() -> Optional[Tracer]:
    return _ACTIVE if _ACTIVE is not None else _LAST


def armed() -> bool:
    return _ACTIVE is not None


def install(run_log: Optional[str] = None, watch_compiles: bool = True,
            registry: Optional[_metrics.MetricsRegistry] = None,
            proc: Optional[str] = None) -> Tracer:
    """Arm tracing process-globally; returns the Tracer.  An existing
    tracer is finished and replaced (last-wins, like faults.install_plan)."""
    global _ACTIVE, _LAST
    prev = _ACTIVE
    tracer = Tracer(run_log=run_log, watch_compiles=watch_compiles,
                    registry=registry, proc=proc)
    _ACTIVE = tracer
    if prev is not None:
        prev.finish()
        _LAST = prev
    return tracer


def shutdown() -> Optional[Tracer]:
    """Disarm: finish the active tracer (kept reachable via last_tracer()
    so a trace can still be exported after the run)."""
    global _ACTIVE, _LAST
    tracer, _ACTIVE = _ACTIVE, None
    if tracer is not None:
        tracer.finish()
        _LAST = tracer
    return tracer


class enabled:
    """`with telemetry.enabled() as tracer:` — scoped arming."""

    def __init__(self, run_log: Optional[str] = None,
                 watch_compiles: bool = True,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 proc: Optional[str] = None):
        self._kw = dict(run_log=run_log, watch_compiles=watch_compiles,
                        registry=registry, proc=proc)

    def __enter__(self) -> Tracer:
        self.tracer = install(**self._kw)
        return self.tracer

    def __exit__(self, *exc):
        if _ACTIVE is self.tracer:
            shutdown()
        else:
            self.tracer.finish()


# -- the hot-path entry points ------------------------------------------------
#
# Each is a module-global None check when disarmed: no allocation beyond
# the **attrs dict the call itself builds (the same cost profile as
# faults.fire(**ctx), which the zero-overhead gates already accept).

def span(name: str, **attrs):
    """Context manager for one span; the shared no-op singleton when
    disarmed."""
    tracer = _ACTIVE
    if tracer is None:
        return NOOP_SPAN
    return tracer.span(name, attrs)


def push(name: str, **attrs) -> Optional[SpanRecord]:
    """Open a span without a `with` block; pair with pop(handle).  None
    when disarmed."""
    tracer = _ACTIVE
    if tracer is None:
        return None
    return tracer.push(name, attrs)


def pop(handle: Optional[SpanRecord]) -> None:
    if handle is not None:
        handle._tracer.pop(handle)


def event(name: str, **attrs) -> None:
    """Instant event attached to the current span; no-op when disarmed."""
    tracer = _ACTIVE
    if tracer is None:
        return
    tracer.event(name, attrs)


def current_span_id() -> Optional[int]:
    tracer = _ACTIVE
    if tracer is None:
        return None
    current = tracer.current_span()
    return current.span_id if current is not None else None


def note_kernel_library(library: str, nvcc: bool, seconds: float) -> None:
    """The compile watch's hook (ops/_build.py): one nvcc build or one
    library load becomes a `compile` event under the current span and an
    increment of the tracer's BUILD_COUNTER.  A module-global None check
    when disarmed."""
    tracer = _ACTIVE
    if tracer is None or not tracer.watch_compiles:
        return
    tracer.retrace_counter.inc()
    tracer.event("compile", {"signature": f"{library} nvcc={nvcc}",
                             "library": library, "nvcc": bool(nvcc),
                             "seconds": round(float(seconds), 6)})


def retrace_count() -> int:
    """Current value of the process-global kernel build/load counter (only
    advances while a tracer's compile watch is armed)."""
    return _metrics.counter(BUILD_COUNTER).value
