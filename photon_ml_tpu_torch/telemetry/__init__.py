"""Unified telemetry: span tracing, a metrics registry, and exportable
run timelines (a copy of photon_ml_tpu/telemetry, host code only).

Three layers, one import:

  * the SPAN TRACER (`core`) — `telemetry.span(name, **attrs)` produces a
    hierarchical, thread-aware trace of a run (fit -> outer iterations ->
    coordinate visits -> solves / chunk staging / checkpoint writes), with
    `utils.faults.fire()`-style disarm semantics: a module-global None
    check and a shared no-op singleton when off — no span objects, no
    device reads, nothing allocated.
  * the METRICS REGISTRY (`metrics`) — counters/gauges/bounded-reservoir
    histograms that the accounting surfaces (PhaseTimings' host-blocked
    time, StreamStats, StoreStats, quarantine/containment events,
    checkpoint/retry counters, the `kernel.builds_and_loads` counter of
    the compile watch) publish through, so ONE `telemetry.snapshot()`
    returns everything.  Always live.
  * EXPORTERS (`export`) — Chrome-trace/Perfetto JSON (`--trace-out` on
    cli.train), a JSONL run log correlated with EventEmitter events and
    fault/quarantine/recovery records by span id, and Prometheus text
    exposition.

Arming:

    tracer = telemetry.install(run_log="out/run-log.jsonl")
    ... run the fit ...
    telemetry.write_chrome_trace("out/trace.json")
    telemetry.shutdown()

or scoped: `with telemetry.enabled() as tracer: ...`.
"""
from photon_ml_tpu_torch.telemetry.core import (  # noqa: F401
    MAX_RECORDS, NOOP_SPAN, SpanRecord, Tracer, active_tracer, armed,
    current_span_id, enabled, event, install, last_tracer, pop, push,
    retrace_count, set_observer, shutdown, span,
)
from photon_ml_tpu_torch.telemetry.export import (  # noqa: F401
    CHROME_REQUIRED_KEYS, chrome_trace_events, prometheus_text,
    render_prometheus_snapshot, validate_chrome_trace,
)
from photon_ml_tpu_torch.telemetry.export import (
    write_chrome_trace as _write_chrome_trace,
)
from photon_ml_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, LabeledCounter, MetricsRegistry, counter,
    default_registry, gauge, histogram,
)
from photon_ml_tpu_torch.telemetry import distributed, events, flight  # noqa: F401
from photon_ml_tpu_torch.telemetry.timings import PhaseTimings, clock  # noqa: F401

# collectors: named callables whose dict results ride along in snapshot()
# (a ScoringService registers its metrics snapshot here so one call
# returns training AND serving state); unregister on close.
_COLLECTORS = {}


def register_collector(name: str, fn) -> None:
    _COLLECTORS[name] = fn


def unregister_collector(name: str) -> None:
    _COLLECTORS.pop(name, None)


def snapshot() -> dict:
    """Everything: the default registry's instruments, every registered
    collector, and (when a tracer is or was armed) its record counts.
    All values JSON-safe — this dict lands verbatim in
    training-summary.json."""
    out = {"metrics": default_registry().snapshot()}
    for name, fn in sorted(_COLLECTORS.items()):
        try:
            out[name] = fn()
        except Exception as e:  # a dead collector must not kill a snapshot
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    tracer = last_tracer()
    if tracer is not None:
        out["tracer"] = tracer.stats()
    return out


def write_chrome_trace(path: str, tracer=None) -> dict:
    """Export the active (or most recently finished) tracer's timeline."""
    tracer = tracer if tracer is not None else last_tracer()
    if tracer is None:
        raise RuntimeError("no tracer has been installed this process — "
                           "call telemetry.install() before the run")
    return _write_chrome_trace(tracer, path)
