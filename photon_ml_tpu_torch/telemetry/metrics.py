"""Metrics registry: counters, gauges, bounded-reservoir histograms (a
copy of photon_ml_tpu/telemetry/metrics.py).

One uniform surface for the accounting quantities (PhaseTimings.
host_blocked, StreamStats, StoreStats, checkpoint/retry counters): an
instrument is created once by name, incremented from any thread, and read
back via `snapshot()` — which is what `telemetry.snapshot()` and the
cli.train summary render.

Design constraints, in order:

  * cheap writes — an increment is one lock + one int/float add, the same
    cost class as the accumulators it replaces (the TRACER is the part
    with disarm semantics; counters are always live, like StreamStats
    always was);
  * bounded memory — `Histogram` keeps a fixed-size reservoir (a deque
    ring, newest-N) for percentile estimates while `count`/`sum`/`max`/
    `min` stay exact.  Replaces the unbounded percentile lists the naive
    approach grows per request;
  * JSON-safe snapshots — every snapshot value is an int or float, so a
    snapshot can land verbatim in training-summary.json.

Instruments are process-global when created through the module-level
`counter()/gauge()/histogram()` helpers (one registry serves training,
streaming, and checkpointing accounting); components that need isolated
numbers per instance (a ScoringService's metrics, one per service object)
create their own `MetricsRegistry`.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Optional

from photon_ml_tpu_torch.utils import locktrace

__all__ = ["Counter", "Gauge", "Histogram", "LabeledCounter",
           "MetricsRegistry", "default_registry", "counter", "gauge",
           "histogram"]


class Counter:
    """Monotonically increasing value (int or float increments)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = locktrace.tracked(threading.Lock(), "Counter._lock")
        self._value = 0

    def inc(self, amount=1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative increment "
                             f"{amount} (use a Gauge for values that fall)")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (host-side floats/ints only — never feed a
    device array here; reading one would force a sync)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = locktrace.tracked(threading.Lock(), "Gauge._lock")
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, amount) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Distribution sketch with a BOUNDED reservoir.

    `count`/`sum`/`max`/`min` are exact over every observation; the
    percentile estimates come from the newest-`reservoir` observations (a
    deque ring — the sliding-window behavior ServingMetrics' latency ring
    already had, now shared).  Memory is O(reservoir) forever.
    """

    __slots__ = ("name", "_lock", "_ring", "count", "sum", "max", "min")

    def __init__(self, name: str, reservoir: int = 4096):
        if reservoir < 1:
            raise ValueError(f"histogram {name!r}: reservoir must be >= 1, "
                             f"got {reservoir}")
        self.name = name
        self._lock = locktrace.tracked(threading.Lock(), "Histogram._lock")
        self._ring = collections.deque(maxlen=int(reservoir))
        self.count = 0
        self.sum = 0.0
        self.max: Optional[float] = None
        self.min: Optional[float] = None

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self._ring.append(v)
            if self.max is None or v > self.max:
                self.max = v
            if self.min is None or v < self.min:
                self.min = v

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the reservoir window (None when
        empty).  p in [0, 100]."""
        with self._lock:
            window = sorted(self._ring)
        if not window:
            return None
        rank = min(int(len(window) * p / 100.0), len(window) - 1)
        return window[rank]

    def percentiles(self, ps=(50, 90, 95, 99)) -> Dict[str, Optional[float]]:
        with self._lock:
            window = sorted(self._ring)
        out: Dict[str, Optional[float]] = {}
        for p in ps:
            if not window:
                out[f"p{p:g}"] = None
            else:
                rank = min(int(len(window) * p / 100.0), len(window) - 1)
                out[f"p{p:g}"] = window[rank]
        return out

    @property
    def window(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            window = sorted(self._ring)
            out = {"count": self.count, "sum": self.sum,
                   "max": self.max, "min": self.min,
                   "window": len(window)}
        for p in (50, 90, 95, 99):
            if not window:
                out[f"p{p}"] = None
            else:
                rank = min(int(len(window) * p / 100.0), len(window) - 1)
                out[f"p{p}"] = window[rank]
        return out


class LabeledCounter:
    """A FAMILY of counters distinguished by label values — the fleet
    front's per-(replica, outcome) request accounting.  Children are
    ordinary Counters created on first use of a label combination, so an
    increment costs one dict lookup more than a plain counter; the label
    cardinality is operator-bounded (replica URLs x a small outcome
    enum), never per-request data.

    Prometheus renders each child as `name_total{k="v",...}`; the JSON
    snapshot renders the same children keyed by the canonical
    `k=v,k2=v2` string — one series set on both surfaces, by
    construction."""

    __slots__ = ("name", "label_names", "_lock", "_children")

    def __init__(self, name: str, label_names):
        if not label_names:
            raise ValueError(f"labeled counter {name!r} needs at least "
                             "one label name (use a Counter otherwise)")
        self.name = name
        self.label_names = tuple(label_names)
        self._lock = locktrace.tracked(threading.Lock(),
                                       "LabeledCounter._lock")
        self._children: Dict[tuple, Counter] = {}

    def labels(self, **kv) -> Counter:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"labeled counter {self.name!r} takes labels "
                f"{list(self.label_names)}, got {sorted(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name)
                self._children[key] = child
            return child

    def inc(self, amount=1, **kv) -> None:
        self.labels(**kv).inc(amount)

    def series(self) -> Dict[tuple, object]:
        """{label-value tuple (in label_names order): value}."""
        with self._lock:
            children = dict(self._children)
        return {key: child.value for key, child in children.items()}

    def snapshot(self) -> Dict[str, object]:
        """{canonical "k=v,k2=v2" string: value} — the JSON surface."""
        return {",".join(f"{n}={v}" for n, v in zip(self.label_names, key)):
                value for key, value in sorted(self.series().items())}


class MetricsRegistry:
    """Named instruments, created on first use; re-asking for a name
    returns the same instrument (asking with a different type raises —
    a counter silently shadowing a gauge would corrupt both)."""

    def __init__(self):
        self._lock = locktrace.tracked(threading.Lock(),
                                       "MetricsRegistry._lock")
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, reservoir: int = 4096) -> Histogram:
        return self._get(name, Histogram, reservoir)

    def labeled_counter(self, name: str, label_names) -> LabeledCounter:
        inst = self._get(name, LabeledCounter, tuple(label_names))
        if inst.label_names != tuple(label_names):
            raise TypeError(
                f"labeled counter {name!r} already registered with labels "
                f"{list(inst.label_names)}, requested {list(label_names)}")
        return inst

    def names(self):
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...},
        "labeled": {...}} — every value JSON-safe."""
        with self._lock:
            items = list(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "labeled": {}}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            elif isinstance(inst, LabeledCounter):
                out["labeled"][name] = inst.snapshot()
            else:
                out["histograms"][name] = inst.snapshot()
        return out


# -- process-global default registry ------------------------------------------

_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT


def counter(name: str) -> Counter:
    return default_registry().counter(name)


def gauge(name: str) -> Gauge:
    return default_registry().gauge(name)


def histogram(name: str, reservoir: int = 4096) -> Histogram:
    return default_registry().histogram(name, reservoir)
