"""Runtime lock-order tracking (a copy of photon_ml_tpu/utils/locktrace.py).

The JAX package derives its whole-program lock-acquisition-order graph
statically (its linter's concurrency pass); this module records the orders
the process ACTUALLY takes, so the two can be cross-validated: every
observed "acquired B while holding A" must be an edge of the static graph,
or `assert_consistent` raises `LockOrderViolation`.

Disarm semantics (the same discipline as `utils.faults.fire` and the
telemetry tracer): with no tracker installed, `tracked(lock, name)` is a
module-global None check that returns the RAW lock unchanged — the hot
paths then acquire plain `threading.Lock` objects with zero wrapper
overhead and zero allocation.  Arming happens before construction:

    with locktrace.enabled() as tracker:
        checkpointer = AsyncCheckpointer(...)   # locks built now are traced
        ... concurrent work ...
    tracker.assert_consistent(static_edges)

Lock names follow the static graph's node naming — `"ClassName._attr"`
(`FaultPlan._lock`, `AsyncCheckpointer._cv`) — which is what makes the
edge sets comparable.  Constructors opt in with

    self._lock = locktrace.tracked(threading.Lock(), "FaultPlan._lock")

a pure pass-through when disarmed.

The tracker records, per observed edge, the first witness: thread name
plus a trimmed acquisition stack — enough to find the nesting in source.
Acquisition counts are kept per lock; stacks are captured only on FIRST
observation of an edge, so armed overhead stays proportional to the edge
set, not the acquisition count.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["LockOrderViolation", "LockTracker", "TracedLock",
           "TracedCondition", "active", "enabled", "install", "shutdown",
           "tracked"]

#: frames kept per witness stack (innermost last, tracker frames trimmed)
MAX_STACK_FRAMES = 10


class LockOrderViolation(AssertionError):
    """Observed runtime acquisition orders disagree with the static
    lock-order graph (see `LockTracker.assert_consistent`)."""


class TracedLock:
    """Wrapper around a raw `threading.Lock`/`RLock` that reports
    acquisition order to the tracker.  Supports the full lock protocol
    (`with`, acquire/release, locked)."""

    __slots__ = ("_raw", "_name", "_tracker")

    def __init__(self, raw, name: str, tracker: "LockTracker"):
        self._raw = raw
        self._name = name
        self._tracker = tracker

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._tracker.note_acquired(self._name)
        return got

    def release(self) -> None:
        self._tracker.note_released(self._name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self._raw.__enter__()
        self._tracker.note_acquired(self._name)
        return self

    def __exit__(self, *exc):
        self._tracker.note_released(self._name)
        return self._raw.__exit__(*exc)

    def __repr__(self):
        return f"<TracedLock {self._name} {self._raw!r}>"


class TracedCondition(TracedLock):
    """Traced `threading.Condition`.  `wait()` keeps the lock on the held
    stack: the condition variable releases and reacquires the SAME lock
    internally, so no new ordering fact is produced."""

    __slots__ = ()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._raw.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._raw.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._raw.notify(n)

    def notify_all(self) -> None:
        self._raw.notify_all()


class LockTracker:
    """Per-thread held-lock stacks + the observed acquisition-order edge
    set with first-witness stacks."""

    def __init__(self, max_stack: int = MAX_STACK_FRAMES):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.max_stack = int(max_stack)
        #: (outer, inner) -> (thread name, witness stack lines)
        self._edges: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]] = {}
        self._acquisitions: Dict[str, int] = {}
        self.wrapped = 0

    # -- wrapping -----------------------------------------------------------
    def wrap(self, lock, name: str):
        with self._lock:
            self.wrapped += 1
        if hasattr(lock, "notify_all"):
            return TracedCondition(lock, name, self)
        return TracedLock(lock, name, self)

    # -- recording ----------------------------------------------------------
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquired(self, name: str) -> None:
        held = self._held()
        fresh = [(outer, name) for outer in held if outer != name]
        with self._lock:
            self._acquisitions[name] = self._acquisitions.get(name, 0) + 1
            fresh = [e for e in fresh if e not in self._edges]
            if fresh:
                stack = tuple(
                    f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                    for f in traceback.extract_stack()[:-2]
                    [-self.max_stack:])
                thread = threading.current_thread().name
                for edge in fresh:
                    self._edges[edge] = (thread, stack)
        held.append(name)

    def note_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- reporting ----------------------------------------------------------
    def edges(self) -> Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]]:
        with self._lock:
            return dict(self._edges)

    def acquisitions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._acquisitions)

    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "locks_wrapped": self.wrapped,
                "acquisitions": dict(self._acquisitions),
                "edges": sorted(f"{a} -> {b}" for a, b in self._edges),
            }

    # -- validation ---------------------------------------------------------
    def validate_against(self, static_edges) -> List[str]:
        """Cross-validate observed orders with the static graph.  Returns
        problem descriptions (empty = consistent):

          * an observed edge whose REVERSE is static is an inversion the
            static pass predicted in the other direction — the two
            disagree on the global order;
          * an observed edge absent from the static graph entirely means
            the static call-graph missed a real nesting — a gap in the
            analysis that must be closed, not ignored.
        """
        static = set(static_edges)
        problems: List[str] = []
        for (a, b), (thread, stack) in sorted(self.edges().items()):
            if (a, b) in static:
                continue
            kind = ("REVERSES the static order"
                    if (b, a) in static else
                    "has no static counterpart (call-graph gap)")
            problems.append(
                f"observed {a} -> {b} on thread {thread!r} {kind}; "
                f"witness: {' < '.join(stack[-4:])}")
        return problems

    def assert_consistent(self, static_edges) -> None:
        problems = self.validate_against(static_edges)
        if problems:
            raise LockOrderViolation(
                "runtime lock-acquisition orders disagree with the static "
                "lock-order graph:\n  " + "\n  ".join(problems))


# -- process-global activation (faults.install_plan-style) --------------------

_ACTIVE: Optional[LockTracker] = None


def active() -> Optional[LockTracker]:
    return _ACTIVE


def install(tracker: Optional[LockTracker] = None) -> LockTracker:
    """Arm lock tracing process-globally; returns the tracker.  Locks
    constructed BEFORE arming stay raw — arm first, then build the
    objects under test."""
    global _ACTIVE
    _ACTIVE = tracker if tracker is not None else LockTracker()
    return _ACTIVE


def shutdown() -> Optional[LockTracker]:
    global _ACTIVE
    tracker, _ACTIVE = _ACTIVE, None
    return tracker


class enabled:
    """`with locktrace.enabled() as tracker:` — scoped arming."""

    def __init__(self, tracker: Optional[LockTracker] = None):
        self._tracker = tracker

    def __enter__(self) -> LockTracker:
        self.tracker = install(self._tracker)
        return self.tracker

    def __exit__(self, *exc):
        if _ACTIVE is self.tracker:
            shutdown()


def tracked(lock, name: str):
    """The constructor hook: `self._lock = locktrace.tracked(
    threading.Lock(), "Class._lock")`.  Disarmed it is a module-global
    None check returning the raw lock — zero overhead on every later
    acquisition."""
    tracker = _ACTIVE
    if tracker is None:
        return lock
    return tracker.wrap(lock, name)
