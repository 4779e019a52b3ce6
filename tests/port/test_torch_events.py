"""The port's utils/events.py behaves as the JAX package's
(tests/test_telemetry.py's emitter cases): a listener that raises is
isolated from the listeners after it, emitted events land in the run log
under the active span's id, an emitter without a tracer stays silent,
close hooks run outside the emitter's lock, and listener paths that do
not resolve fail with the JAX package's messages.  GameEstimator sends
the training events of every fit, fit_grid's sub-estimators included.
"""
import json
import logging

import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.utils import events as jax_events
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.utils import events
from photon_ml_tpu_torch.utils.events import (
    EventEmitter, EventListener, ScoringBatchEvent, TrainingStartEvent,
)


class _Sink(EventListener):
    def __init__(self):
        self.got = []

    def handle(self, event):
        self.got.append(event)


class _Boom(EventListener):
    def handle(self, event):
        raise RuntimeError("listener bug")


def test_listener_exception_is_isolated_from_remaining_listeners(caplog):
    emitter = EventEmitter()
    first, last = _Sink(), _Sink()
    for listener in (first, _Boom(), last):
        emitter.register_listener(listener)
    with caplog.at_level(logging.ERROR, "photon_ml_tpu_torch.utils.events"):
        emitter.send_event(TrainingStartEvent(time=1.0))
    assert len(first.got) == 1 and len(last.got) == 1
    assert any("event listener failed" in r.message for r in caplog.records)


def test_emitted_events_route_into_run_log_with_span_id(tmp_path):
    log_path = tmp_path / "run.jsonl"
    emitter = EventEmitter()
    emitter.register_listener(_Sink())
    with telemetry.enabled(run_log=str(log_path), watch_compiles=False):
        with telemetry.span("serve_batch") as batch_span:
            emitter.send_event(ScoringBatchEvent(
                time=1.0, num_requests=3, num_rows=7, bucket_size=8,
                queue_wait_s=0.001, score_s=0.002, model_version="v1"))
            emitter.send_event(events.OptimizationLogEvent(
                regularization_weights={"fixed": 1.0}, objective_history=[3.0, 2.0],
                final_metrics={}))
    records = [json.loads(line) for line in log_path.read_text().splitlines()]
    ev = next(r for r in records if r["name"] == "emitted.ScoringBatchEvent")
    assert ev["span"] == batch_span.span_id
    assert ev["attrs"]["num_rows"] == 7 and ev["attrs"]["model_version"] == "v1"
    log = next(r for r in records if r["name"] == "emitted.OptimizationLogEvent")
    assert log["attrs"] == {"regularization_weights_len": 1,
                            "objective_history_len": 2, "final_metrics_len": 0}


def test_emitter_without_tracer_stays_silent():
    emitter = EventEmitter()
    sink = _Sink()
    emitter.register_listener(sink)
    assert not telemetry.armed()
    emitter.send_event(TrainingStartEvent(time=2.0))
    assert len(sink.got) == 1


def test_clear_listeners_close_hooks_run_outside_the_lock():
    """A close() that re-enters the emitter must not deadlock: the list is
    swapped under the lock and closed outside it."""
    emitter = EventEmitter()
    closed = []

    class Reentrant(EventListener):
        def handle(self, event):
            pass

        def close(self):
            closed.append(True)
            emitter.register_listener(_Sink())

    emitter.register_listener(Reentrant())
    emitter.clear_listeners()
    assert closed == [True]
    emitter.send_event(TrainingStartEvent(time=3.0))


@pytest.mark.parametrize("path", ["NoDots", "no_such_module_xyz.Listener",
                                  "photon_ml_tpu_torch.utils.events.NoSuchListener"])
def test_bad_listener_paths_fail_as_in_jax(path):
    errors = []
    for emitter in (EventEmitter(), jax_events.EventEmitter()):
        with pytest.raises(ValueError) as e:
            emitter.register_listener_class(path)
        errors.append(str(e.value).replace("photon_ml_tpu_torch", "photon_ml_tpu"))
    assert errors[0].split(":")[0] == errors[1].split(":")[0]


def test_listener_class_registers_by_path():
    emitter = EventEmitter()
    emitter.register_listener_class("photon_ml_tpu_torch.utils.events.LoggingEventListener")
    assert isinstance(emitter._listeners[0], events.LoggingEventListener)


def test_estimator_sends_training_events():
    """fit sends TrainingStart, OptimizationLog (the coordinates' weights,
    the objective history) and TrainingFinish; fit_grid's sub-estimators
    share the emitter, so a two-combo grid sends two sets."""
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu_torch.game.config import GLMOptimizationConfig
    train, val = side.containment_glmix(build_game_dataset)
    cfg = GameTrainingConfig.from_dict(side.containment_config_dict(1))
    emitter, sink = EventEmitter(), _Sink()
    emitter.register_listener(sink)
    est = GameEstimator(cfg, device="cpu", dtype=torch.float64, emitter=emitter)
    result = est.fit(train, val, ["AUC"])
    assert [type(e).__name__ for e in sink.got] == [
        "TrainingStartEvent", "OptimizationLogEvent", "TrainingFinishEvent"]
    log = sink.got[1]
    assert log.objective_history == result.objective_history
    assert log.regularization_weights == {
        n: c.optimization.regularization_weight for n, c in cfg.coordinates.items()}
    assert log.final_metrics == result.validation
    base = cfg.coordinates["fixed"].optimization
    grid = {"fixed": [GLMOptimizationConfig(base.optimizer, base.regularization, w)
                      for w in (10.0, 1.0)]}
    sink.got.clear()
    est.fit_grid(train, grid, val, ["AUC"])
    assert [type(e).__name__ for e in sink.got].count("OptimizationLogEvent") == 2
    assert [e.regularization_weights["fixed"] for e in sink.got
            if isinstance(e, events.OptimizationLogEvent)] == [10.0, 1.0]
