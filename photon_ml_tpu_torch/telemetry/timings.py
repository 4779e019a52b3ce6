"""PhaseTimings: contiguous per-fit span accounting, bridged into the
span tracer (a copy of photon_ml_tpu/telemetry/timings.py).

Every timed phase of a fit lands both in the per-fit dict (the cli summary,
armed or not) and, when the tracer is armed, in the hierarchical trace as a
named span.  game/coordinate_descent.py re-exports PhaseTimings.

`clock()` is the raw timestamp for modules that need a bare duration.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

from photon_ml_tpu_torch.telemetry import core as _core


def clock() -> float:
    """Monotonic high-resolution seconds (the telemetry time base)."""
    return time.perf_counter()


class PhaseTimings(dict):
    """Accumulating span timer: label -> seconds.  Spans are CONTIGUOUS
    over the descent loop, so their sum accounts for the whole fit wall
    clock; an unattributed gap means an untimed stage.

    `host_blocked` tracks, per span label, the seconds the host spent
    BLOCKED on device readbacks (scalar syncs, `float()` objective fetches,
    [n]-tensor copies into numpy evaluators, the pipelined boundary flush).
    host_blocked_total()/wall is the host-blocked fraction; it also lands
    in the `train.host_blocked_s`/`train.host_blocked_frac` gauges at fit
    end (game/coordinate_descent.py).

    When the tracer is armed, `span(label, name=..., **attrs)` also emits
    a telemetry span (`name` defaults to the label), so the per-fit dict
    and the exported timeline are the same measurement, not two."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_blocked: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, label: str, host_blocked: bool = False,
             name: str = None, **attrs):
        tspan = _core.span(name if name is not None else label, **attrs)
        t0 = clock()
        try:
            with tspan:
                yield
        finally:
            dt = clock() - t0
            self[label] = self.get(label, 0.0) + dt
            if host_blocked:
                self.add_blocked(label, dt)

    @contextlib.contextmanager
    def blocked(self, label: str):
        """Time a host-blocking readback into `host_blocked` WITHOUT
        opening a new accounting span (the enclosing span already covers
        the wall time)."""
        t0 = clock()
        try:
            yield
        finally:
            self.add_blocked(label, clock() - t0)

    def add_blocked(self, label: str, seconds: float) -> None:
        self.host_blocked[label] = self.host_blocked.get(label, 0.0) + seconds

    def host_blocked_total(self) -> float:
        return float(sum(self.host_blocked.values()))

    def total(self) -> float:
        return float(sum(self.values()))
