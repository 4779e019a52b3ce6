"""The port's telemetry == the JAX package's.

In this process, on host values only: the same script of span/push/pop/
event/counter/gauge/histogram calls (an abandoned span, an exception
inside a span, a span left open, a second thread) through both tracers
gives the same span tree, events, snapshots and Prometheus text; each
package's `validate_chrome_trace` accepts the other's trace file; each
package parses and merges the other's run logs to equal results, and
`cli.trace merge` prints the same summary line in both; the flight
recorder dumps equal bundles.  Times, wall clocks and ids are removed
before comparing; the compile-watch counter compares under the port's
name (`kernel.builds_and_loads` for `jax.retraces`).

Fits against the JAX side (telemetry_jax_side.py, one subprocess per
module, and the shared stream and sweep modes of game_jax_side.py and
sweep_jax_side.py): four traced fits (checkpointed, poisoned, streamed
under an HBM budget, a candidate-lane sweep) compare their span trees,
events and counters exactly (`checkpoint.coalesced` and the host-blocked
gauges' values depend on timing and are left out), and cli.train with
--trace-out/--run-log/--event-listener gives a summary whose telemetry
keys are the JAX CLI's.  Port alone: the disarmed fit equals the armed
one bit for bit, the compile watch reports kernel builds and loads, the
event vocabulary covers every fault site and flight trigger, and counters
and spans lose nothing under thread contention.
"""
import contextlib
import io
import json
import logging
import threading

import pytest
import torch

import game_jax_side as side
import sweep_jax_side as sweep_side
import telemetry_jax_side as tj
from photon_ml_tpu import telemetry as jax_telemetry
from photon_ml_tpu.cli import trace as jax_trace_cli
from photon_ml_tpu.telemetry import distributed as jax_distributed
from photon_ml_tpu.telemetry import export as jax_export
from photon_ml_tpu.telemetry import flight as jax_flight
from photon_ml_tpu.telemetry import metrics as jax_metrics
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.cli import trace as trace_cli
from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
from photon_ml_tpu_torch.data.synthetic_bench import pipeline_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.game.quarantine import coefficient_arrays
from photon_ml_tpu_torch.hyperparameter import SweepEvaluator
from photon_ml_tpu_torch.ops import _build
from photon_ml_tpu_torch.telemetry import distributed, export, flight, metrics
from photon_ml_tpu_torch.utils import faults

PACKAGES = {"jax": (jax_telemetry, jax_metrics, jax_export, jax_flight,
                    jax_distributed, "photon_ml_tpu"),
            "port": (telemetry, metrics, export, flight, distributed,
                     "photon_ml_tpu_torch")}
DEV = {"device": "cpu", "dtype": torch.float64}


@contextlib.contextmanager
def fresh_registries():
    """Both packages' default registries start empty, and are restored
    after: the script's counts are its own."""
    saved = (jax_metrics._DEFAULT, metrics._DEFAULT)
    jax_metrics._DEFAULT = metrics._DEFAULT = None
    try:
        yield
    finally:
        jax_metrics._DEFAULT, metrics._DEFAULT = saved


def renamed(snapshot: dict) -> dict:
    return {kind: {tj.RENAMED.get(k, k): v for k, v in inst.items()}
            for kind, inst in snapshot.items()}


# -- the span script ----------------------------------------------------------

def span_script(tel, registry, run_log=None):
    """The same calls through either package's telemetry; -> the tracer."""
    with tel.enabled(run_log=run_log, watch_compiles=False, registry=registry,
                     proc="script") as tracer:
        with tel.span("outer", iteration=3):
            tel.event("mark", k=1, items=[1, 2])
            visit = tel.push("visit", coordinate="fixed")
            tel.push("abandoned")
            tel.pop(visit)                           # heals "abandoned" too
            with pytest.raises(ValueError):
                with tel.span("raises", where="inside"):
                    tel.event("before_raise")
                    raise ValueError("inside a span")

            def work():
                with tel.span("stage", chunk=0, rows=256):
                    tel.event("in_thread", chunk=0)
            t = threading.Thread(target=work, name="script-worker")
            t.start()
            t.join()
        tel.event("orphan")
        tel.push("left_open")                        # closed by finish()
        registry.counter("c").inc(2)
        registry.gauge("g").set(1.5)
        h = registry.histogram("h", reservoir=4)
        for v in range(7):
            h.observe(v)
        registry.labeled_counter("lc", ("replica", "outcome")).inc(replica="r0",
                                                                    outcome="ok")
    return tracer


def script_record(tracer) -> dict:
    threads = {s.tid: s.thread_name for s in tracer.spans}
    rec = tj.fit_record(tracer, tracer.registry.snapshot())
    rec["span_threads"] = sorted([tj.span_paths(tracer)[s.span_id], s.thread_name]
                                 for s in tracer.spans)
    rec["event_threads"] = sorted([e["name"], threads.get(e["tid"])]
                                  for e in tracer.events)
    rec["registry"] = renamed(tracer.registry.snapshot())
    rec["stats"] = {k: v for k, v in tracer.stats().items()
                    if k not in ("run_log", "wall0_unix_s")}
    return rec


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """-> {package: (tracer, run log path, chrome trace path)}."""
    root = tmp_path_factory.mktemp("script")
    out = {}
    for who, (tel, met, exp, *_rest) in PACKAGES.items():
        log = root / f"{who}.jsonl"
        tracer = span_script(tel, met.MetricsRegistry(), str(log))
        trace = root / f"{who}-trace.json"
        exp.write_chrome_trace(tracer, str(trace))
        out[who] = (tracer, log, trace)
    return out


def test_span_script_matches_jax(scripts):
    port, jax = (script_record(scripts[who][0]) for who in ("port", "jax"))
    assert port == jax
    assert ["outer/visit/abandoned", {}] in port["spans"]
    assert ["stage", "script-worker"] in port["span_threads"]   # its own root
    assert port["stats"]["open_spans"] == 0


def test_chrome_traces_validate_across_packages(scripts):
    """Each package's validator accepts the other's file, and the trace
    events are equal apart from times and thread ids (the worker threads
    are two threads)."""
    payloads = {who: json.loads(scripts[who][2].read_text()) for who in scripts}
    for a, b in (("jax", "port"), ("port", "jax")):
        validate = PACKAGES[a][2].validate_chrome_trace
        assert validate(payloads[b]) == []
    strip = lambda evs: sorted((json.dumps({k: v for k, v in e.items()
                                            if k not in ("ts", "dur", "tid")},
                                           sort_keys=True)
                                for e in evs))
    assert strip(payloads["port"]["traceEvents"]) == strip(payloads["jax"]["traceEvents"])


def test_prometheus_text_is_byte_equal():
    texts = []
    for tel, met, exp, *_rest in PACKAGES.values():
        r = met.MetricsRegistry()
        r.counter("serving.requests").inc(7)
        r.counter("train.quarantine.rolled_back").inc()
        r.gauge("train.host_blocked_frac").set(0.25)
        h = r.histogram("serving.latency_s", reservoir=16)
        for v in (0.01, 0.02, 0.5):
            h.observe(v)
        r.labeled_counter("front.requests", ("replica", "outcome")).inc(
            replica="http://r0:1?a=b", outcome='o"k')
        r.labeled_counter("front.idle", ("replica",))
        texts.append(exp.prometheus_text(r, extra_info={"model_version": "v3"},
                                         labels={"instance": "i0"}))
    assert texts[0] == texts[1]
    assert 'photon_serving_latency_s{instance="i0",quantile="0.99"} 0.5' in texts[1]


def test_run_logs_parse_and_merge_alike(scripts, cli_runs):
    """Both packages parse every run log to the same records, and merge
    the logs of two processes (the JAX and the port CLI) and the scripts'
    to the same report; the merged trace names its producer."""
    root = cli_runs[0]
    logs = [str(root / "jax_out" / "run.jsonl"), str(root / "port_out" / "run.jsonl")]
    for log in logs + [str(scripts[w][1]) for w in scripts]:
        assert distributed.parse_run_log(log) == jax_distributed.parse_run_log(log)
    for paths in (logs, logs[::-1], [str(scripts[w][1]) for w in scripts]):
        a, b = (mod.merge_run_logs(paths) for mod in (distributed, jax_distributed))
        assert a["trace"]["otherData"].pop("producer") == \
            "photon_ml_tpu_torch.telemetry.distributed"
        b["trace"]["otherData"].pop("producer")
        assert a == b and a["problems"] == []
    assert len({p["pid"] for p in a["processes"]}) == 1


def test_trace_merge_cli_matches_jax(cli_runs, tmp_path):
    root = cli_runs[0]
    argv = ["merge", str(root / "jax_out" / "run.jsonl"), str(root / "port_out"),
            "--out", str(tmp_path / "fleet.json")]
    lines = []
    for main in (jax_trace_cli.main, trace_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        lines.append((rc, buf.getvalue().strip().splitlines()[-1]))
    assert lines[0] == lines[1] and lines[1][0] == 0
    summary = json.loads(lines[1][1])
    assert len(summary["processes"]) == 2 and summary["problems"] == []


# -- the flight recorder ------------------------------------------------------

def flight_bundle(who: str, dump_dir) -> dict:
    tel, _met, _exp, fl, _dist, logger_name = PACKAGES[who]
    with fresh_registries(), fl.enabled(str(dump_dir), proc="script"):
        with tel.enabled(watch_compiles=False):
            with tel.span("visit", coordinate="fixed"):
                tel.event("fault", site="solve.poison", action="poison")
            tel.counter("faults.fired").inc()
            logging.getLogger(logger_name).warning("health gate near its bound")
            with pytest.raises(ValueError, match="unknown flight trigger"):
                fl.trigger("no.such.trigger")
            path = fl.trigger("health.gate_trip", trigger_id="trip-1", gate="auc")
    with open(path) as f:
        return json.load(f)


def _timeless(value):
    """A bundle without wall clocks, perf-counter times, the run log's
    path and the logger's (package) name."""
    if isinstance(value, dict):
        return {k: _timeless(v) for k, v in value.items()
                if k not in ("wall_s", "t0_s", "dur_s", "t_s", "dumped_at_unix_s",
                             "window_s", "wall0_unix_s", "logger")}
    if isinstance(value, list):
        return [_timeless(v) for v in value]
    return value


def test_flight_bundles_match_jax(tmp_path):
    jax, port = (flight_bundle(who, tmp_path / who) for who in ("jax", "port"))
    jax["metrics"]["metrics"] = renamed(jax["metrics"]["metrics"])
    assert _timeless(port) == _timeless(jax)
    assert [r["kind"] for r in port["records"]] == ["event", "span", "log", "event",
                                                    "event"]
    assert port["metrics"]["metrics"]["counters"]["faults.fired"] == 1


def test_event_vocabulary_covers_sites_and_triggers():
    """Every fault site and flight trigger has its event name (the JAX
    package checks this with its linter), and the vocabulary is JAX's."""
    from photon_ml_tpu.telemetry import events as jax_events
    from photon_ml_tpu_torch.telemetry import events
    assert set(events.EVENTS) == set(faults.SITES) | set(flight.TRIGGERS)
    assert events.EVENTS == jax_events.EVENTS
    assert flight.TRIGGERS == jax_flight.TRIGGERS


# -- the compile watch --------------------------------------------------------

class _Lib:
    def __getattr__(self, name):
        return type("Fn", (), {})()


def test_kernel_builds_and_loads_are_the_compile_watch(monkeypatch):
    """ops/_build.py reports each nvcc build (build_all) and each library
    load (load_library, with whether nvcc ran for it) to LOADS always and,
    while a tracer is armed, as `compile` events under the current span
    and increments of the counter retrace_count() reads."""
    monkeypatch.setattr(_build, "_build_stale",
                        lambda names: {n: 0.25 for n in names if n == "ell_sparse"})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    loads0 = len(_build.LOADS)
    _build.build_all(("ell_sparse",))                   # disarmed: LOADS only
    before = telemetry.retrace_count()
    with telemetry.enabled() as tracer:
        with telemetry.span("coordinate_visit", coordinate="fixed"):
            _build.load_library.__wrapped__("ell_sparse")
            _build.load_library.__wrapped__("fused_value_and_gradient")
    with telemetry.enabled(watch_compiles=False) as quiet:
        _build.build_all(("ell_sparse",))
    assert [(n, nvcc) for n, nvcc, _ in _build.LOADS[loads0:]] == [
        ("ell_sparse", True), ("ell_sparse", True), ("fused_value_and_gradient", False),
        ("ell_sparse", True)]
    assert telemetry.retrace_count() == before + 2
    compiles = [e for e in tracer.events if e["name"] == "compile"]
    assert [(e["attrs"]["library"], e["attrs"]["nvcc"], e["attrs"]["signature"])
            for e in compiles] == [("ell_sparse", True, "ell_sparse nvcc=True"),
                                   ("fused_value_and_gradient", False,
                                    "fused_value_and_gradient nvcc=False")]
    assert {e["span"] for e in compiles} == {tracer.spans[0].span_id}
    assert quiet.events == []


# -- fits against the JAX package ---------------------------------------------

def _pipeline():
    return pipeline_dataset(side.RES_N, side.RES_DG, side.RES_USERS, side.RES_DU,
                            side.RES_SEED)


PORT = {"telemetry": telemetry, "faults": faults, "GameEstimator": GameEstimator,
        "GameTrainingConfig": GameTrainingConfig, "build_game_dataset": build_game_dataset,
        "SweepEvaluator": SweepEvaluator, "pipeline_dataset": _pipeline}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """-> (root, the JAX side's fit records and CLI run, the streamed
    fit's budget).  The streamed fit and the sweep come from the stream
    and sweep modes' results, which other modules of the process share."""
    root = tmp_path_factory.mktemp("telemetry")
    tj.write_inputs(root, build_game_dataset, save_game_dataset)
    results = tj.run_jax_side(root)
    stream = side.stream_results(root / "stream.npz")
    results["streamed"] = json.loads(str(stream[tj.STREAMED_KEY]))
    results["sweep"] = json.loads(str(sweep_side.sweep_results(root / "sweep.npz")
                                      [tj.SWEEP_KEY]))
    return root, results, int(stream["res/budget"])


@pytest.mark.parametrize("name", tj.FITS + ("streamed", "sweep"))
def test_traced_fits_match_jax(jax_side, name):
    root, jax, budget = jax_side
    with fresh_registries():
        tracer = tj.run_fit(name, PORT, root / "port_out", budget, **DEV)
        port = tj.fit_record(tracer, metrics.default_registry().snapshot())
    assert port == jax[name]
    counters = port["counters"]
    assert counters["kernel.builds_and_loads"] == 0
    if name == "checkpointed":
        assert counters["checkpoint.written"] == 2
        assert ["checkpoint_write", {"iteration": 1}] in port["spans"]
    elif name == "poisoned":
        assert counters["faults.fired"] == 1 and counters["train.quarantine.retry_ok"] == 1
    elif name == "streamed":
        assert counters["stream.chunks_staged"] > 0 and "store.fetches" in counters
        assert any(path == "stage" for path, _ in port["spans"])
    else:
        assert counters["sweep.candidates"] == len(sweep_side.vmap_weights())
        assert counters["sweep.dispatches"] > 0


def test_disarmed_fit_equals_armed_fit():
    """Telemetry changes no number: the disarmed fit's histories and
    coefficients equal the armed fit's bit for bit; a disarmed visit's
    `retraces` is None, an armed one's 0 (no kernel loads on the CPU)."""
    train, val = side.containment_glmix(build_game_dataset)
    cfg = GameTrainingConfig.from_dict(side.containment_config_dict(2))
    fits = []
    for armed in (False, True):
        with telemetry.enabled(watch_compiles=True) if armed else contextlib.nullcontext():
            fits.append(GameEstimator(cfg, **DEV).fit(train, val, ["AUC"]))
    off, on = fits
    assert off.objective_history == on.objective_history
    assert off.descent.validation_history == on.descent.validation_history
    for name in off.model.coordinates:
        a, b = (coefficient_arrays(r.model.coordinates[name]) for r in (off, on))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    assert {t.retraces for t in off.descent.trackers.values()} == {None}
    assert {t.retraces for t in on.descent.trackers.values()} == {0}
    assert all(d["retraces"] == 0 for d in on.descent.solver_diagnostics().values())


# -- cli.train with the four flags --------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(jax_side):
    """The port's cli.train over the JAX side's files with all four flags;
    -> (root, the port's summary, the JAX CLI's summary)."""
    root, jax, _ = jax_side
    tj.RecordingListener.seen.clear()
    tj.RecordingListener.closed = False
    buf = io.StringIO()
    with fresh_registries(), contextlib.redirect_stdout(buf):
        rc = train_cli.main(tj.cli_argv(root, root / "port_out") + [
            "--device", "cpu", "--profile",
            "--event-listener", "telemetry_jax_side.RecordingListener"])
    assert rc == 0 and jax["cli"]["rc"] == 0
    return root, json.loads(buf.getvalue().strip().splitlines()[-1]), jax["cli"]["summary"]


def test_train_cli_telemetry_flags(cli_runs):
    root, port, jax = cli_runs
    out = root / "port_out"
    trace = json.loads((out / "trace.json").read_text())
    assert export.validate_chrome_trace(trace) == []
    log = distributed.parse_run_log(str(out / "run.jsonl"))
    assert log["meta"]["proc"] == "train"
    assert {s["span"] for s in log["spans"]} == \
        {e["args"]["span"] for e in trace["traceEvents"] if e["ph"] == "X"}
    names = {e["name"] for e in log["events"]}
    assert {"emitted.TrainingStartEvent", "emitted.OptimizationLogEvent",
            "emitted.TrainingFinishEvent"} <= names
    assert tj.RecordingListener.seen == ["SetupEvent", "TrainingStartEvent",
                                         "OptimizationLogEvent", "TrainingFinishEvent"]
    assert tj.RecordingListener.closed
    assert (out / "cli" / "profile" / "trace.json").stat().st_size > 0
    assert port["trace_out"] == str(out / "trace.json")
    assert port["compile_count"] == 0 and port["compile_s"] == 0.0
    assert port["final_objective"] == pytest.approx(jax["final_objective"], rel=1e-10)
    # the summary's telemetry surface is the JAX CLI's
    assert sorted(port["telemetry"]) == sorted(jax["telemetry"])
    for kind in ("counters", "gauges", "histograms", "labeled"):
        assert sorted(port["telemetry"]["metrics"][kind]) == \
            sorted(renamed(jax["telemetry"]["metrics"])[kind]), kind
    assert sorted(port["telemetry"]["tracer"]) == sorted(jax["telemetry"]["tracer"])
    for key in ("spans", "events", "open_spans", "dropped", "proc"):
        assert port["telemetry"]["tracer"][key] == jax["telemetry"]["tracer"][key], key


def test_counters_and_spans_under_thread_contention():
    """More threads than cores increment one counter and histogram and
    open spans under a short switch interval: no increment, observation
    or span is lost, and span ids stay unique (the instruments' and the
    tracer's locks)."""
    import os
    import sys
    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 400
    registry = metrics.MetricsRegistry()

    def work():
        counter, hist = registry.counter("hits"), registry.histogram("h", reservoir=8)
        for i in range(per):
            counter.inc()
            hist.observe(i)
            if i % 100 == 0:
                with telemetry.span("tick", i=i):
                    telemetry.event("tock")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.enabled(watch_compiles=False, registry=registry) as tracer:
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert registry.counter("hits").value == registry.histogram("h").count == n_threads * per
    assert len(tracer.spans) == len(tracer.events) == n_threads * per // 100
    assert len({s.span_id for s in tracer.spans}) == len(tracer.spans)
    assert all(s.parent_id is None for s in tracer.spans)
