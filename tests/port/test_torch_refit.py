"""Parity of the port's refit loop (refit/*, cli.refit) with the JAX
package's, on the CPU in float64.

One feedback lane (fleet_jax_side.write_lane, written here through the
port's FeedbackLog) is compacted by both packages: the chunk stores are
byte-equal, and each package resumes the other's partial store to the same
bytes.  `cli.refit` runs on the lane in both packages (the JAX side in
fleet_jax_side.py refit, one subprocess per module): the result lines
agree (objective history and holdout metrics within HISTORY_RTOL, every
other field equal), and each package's candidate directory loads in the
other with equal table hashes.  The refit from the log repeats the refit
from the same rows in memory bit for bit; a `refit.compact` fault in
mid-store converges on resume; the validate/swap fault sites, the trigger's
state machine and the compacted store's chunk reads run on the port alone,
as tests/test_refit.py runs them on the JAX package.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import fleet_jax_side as fj
import online_jax_side as oj
from test_torch_online import PKG as ONLINE_PKG
from photon_ml_tpu_torch.cli import refit as refit_cli
from photon_ml_tpu_torch.fleet import FeedbackLog, feedback_from_record
from photon_ml_tpu_torch.models.io import save_game_model
from photon_ml_tpu_torch.refit import (CompactedDataset, CompactionError,
                                       CompactorConfig, LogCompactor,
                                       RefitConfig, RefitDriver, RefitError,
                                       RefitTrigger, TriggerConfig)
from photon_ml_tpu_torch.refit.driver import RefitResult
from photon_ml_tpu_torch.serving import (CompiledScorer, ScoringService,
                                         ServingConfig)
from photon_ml_tpu_torch.utils import faults

HISTORY_RTOL = 1e-8
F64 = torch.float64
PKG = {**ONLINE_PKG, "LogCompactor": LogCompactor,
       "CompactorConfig": CompactorConfig, "CompactedDataset": CompactedDataset}
PORT_FLAGS = ["--device", "cpu", "--x64"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The model, the lane, the port's partial store and its cli.refit run
    (which the JAX side reads), then the JAX side."""
    root = tmp_path_factory.mktemp("refit")
    save_game_model(oj.build_model(PKG, oj.model_arrays()), str(root / "model"))
    fj.write_lane(PKG, root / "lane")
    fj.compact(PKG, root / "lane", root / "port_prefix", upto=fj.PREFIX_SEQS)
    port_cli = fj.run_cli_refit(refit_cli, fj.refit_argv(root, "port") + PORT_FLAGS)
    jax = fj.run_jax_side("refit", root)
    return {"root": root, "port_cli": port_cli, "jax": jax}


def test_compacted_store_is_byte_equal_to_jax(root, tmp_path):
    manifest = fj.compact(PKG, root["root"] / "lane", tmp_path / "full")
    assert manifest["sealed_rows"] == 128 and len(manifest["chunks"]) == 4
    assert fj.store_bytes(tmp_path / "full") == root["jax"]["full"]


@pytest.mark.parametrize("who", ["port_resumes_jax", "jax_resumes_port"])
def test_each_package_resumes_the_others_store(root, tmp_path, who):
    if who == "jax_resumes_port":
        assert root["jax"]["prefix_resumed"] == root["jax"]["full"]
        return
    shutil.copytree(root["root"] / "jax_prefix", tmp_path / "store")
    before = json.loads((tmp_path / "store" / "manifest.json").read_text())
    assert 0 < before["sealed_rows"] < 128
    fj.compact(PKG, root["root"] / "lane", tmp_path / "store")
    assert fj.store_bytes(tmp_path / "store") == root["jax"]["full"]


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= HISTORY_RTOL * np.maximum(np.abs(b), 1.0)))


def test_cli_refit_result_line_matches_jax(root):
    (prc, pline), (jrc, jline) = root["port_cli"], root["jax"]["cli"]
    assert prc == jrc == 0
    port, jax = json.loads(pline), json.loads(jline)
    assert port.keys() == jax.keys()
    assert port["swapped"] is True and port["version"] == fj.REFIT_VERSION
    for k in port:
        if k in ("objective_history", "candidate", "incumbent"):
            continue
        assert port[k] == jax[k], k
    assert _close(port["objective_history"], jax["objective_history"])
    for side in ("candidate", "incumbent"):
        assert port[side].keys() == jax[side].keys()
        for m, v in port[side].items():
            assert _close(v, jax[side][m]), (side, m)


def test_candidate_directories_load_across_packages(root):
    for who in ("jax", "port"):
        scorer = CompiledScorer.from_model_dir(
            str(root["root"] / f"{who}_models" / fj.REFIT_VERSION),
            device="cpu", dtype=F64)
        assert scorer.table_hashes() == root["jax"]["candidate_hashes"][who], who


def _driver(root, tmp_path, lane=None, chunk_rows=fj.CHUNK_ROWS, **cfg):
    svc = ScoringService(model_dir=str(root["root"] / "model"), start_updater=False,
                         config=ServingConfig(device="cpu", dtype=F64))
    log = FeedbackLog(str(lane or root["root"] / "lane"))
    comp = LogCompactor(log, str(tmp_path / "chunks"),
                        CompactorConfig(chunk_rows=chunk_rows))
    drv = RefitDriver(svc.registry, comp, str(tmp_path / "models"),
                      RefitConfig(**cfg), metrics=svc.metrics)
    return svc, log, drv


def test_refit_from_log_equals_refit_in_memory(root, tmp_path):
    """driver.py's contract: the fit from the compacted chunks and the
    unsealed tail repeats the fit from the same rows in memory bit for
    bit."""
    svc, log, drv = _driver(root, tmp_path)
    try:
        drv.compactor.compact()
        live = svc.registry.scorer.table_hashes()
        from_log = drv.fit_candidate(drv.gather_rows())
        # the fit reads the live tables and never writes them
        assert svc.registry.scorer.table_hashes() == live
        batches = [feedback_from_record(e["record"]) for e in log.read(0)]
        rows = {
            "features": {s: np.concatenate([b["features"][s] for b in batches])
                         for s in batches[0]["features"]},
            "ids": {t: np.asarray([str(v) for b in batches for v in b["ids"][t]],
                                  dtype=object) for t in batches[0]["ids"]},
            "labels": np.concatenate([b["labels"] for b in batches]),
            "weights": np.concatenate([b["weights"] for b in batches]),
            "offsets": np.concatenate([b["offsets"] for b in batches]),
            "wall": np.concatenate([np.full(len(b["labels"]), b["wall_s"])
                                    for b in batches])}
        in_memory = drv.fit_candidate(rows)
        assert from_log.objective_history == in_memory.objective_history
        assert from_log.fe_passes == in_memory.fe_passes and all(from_log.fe_passes)
        for name, m in from_log.model.coordinates.items():
            other = in_memory.model.coordinates[name]
            a = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
            b = other.glm.coefficients.means if hasattr(other, "glm") \
                else other.coefficients
            assert torch.equal(a, b), name
    finally:
        svc.close()


def test_compact_fault_mid_store_converges_on_resume(root, tmp_path):
    log = FeedbackLog(str(root["root"] / "lane"))
    comp = LogCompactor(log, str(tmp_path / "store"),
                        CompactorConfig(chunk_rows=fj.CHUNK_ROWS))
    plan = faults.FaultPlan([{"site": "refit.compact", "action": "fatal",
                              "hits": [3]}])
    with faults.injected(plan):
        with pytest.raises(CompactionError, match="chunk-000002"):
            comp.compact()
    assert comp.manifest()["sealed_rows"] == 2 * fj.CHUNK_ROWS
    comp.compact()
    assert fj.store_bytes(tmp_path / "store") == root["jax"]["full"]


def test_fetch_pads_a_chunk_with_zero_weights(root, tmp_path):
    """CompactedDataset.fetch pads past the sealed rows with zeros (the
    JAX package's fetch omits pad_rows_host's fill and raises)."""
    fj.compact(PKG, root["root"] / "lane", tmp_path / "store")
    ds = CompactedDataset(str(tmp_path / "store"))
    plan = ds.plan(row_multiple=48)
    rows = ds.load_rows()
    spec = plan.chunks[-1]
    got = ds.fetch(spec)
    n = spec.stop - spec.start
    assert got["labels"].shape[0] == spec.padded_rows > n
    np.testing.assert_array_equal(got["labels"][:n], rows["labels"][spec.start:spec.stop])
    np.testing.assert_array_equal(got["features.global"][:n],
                                  rows["features"]["global"][spec.start:spec.stop])
    assert not got["weights"][n:].any() and not got["features.global"][n:].any()


def test_validate_fatal_fault_raises_and_keeps_incumbent(root, tmp_path):
    svc, _log, drv = _driver(root, tmp_path)
    try:
        before = svc.registry.version
        plan = faults.FaultPlan([{"site": "refit.validate", "action": "fatal",
                                  "hits": [1]}])
        with faults.injected(plan):
            with pytest.raises(RefitError, match="validation"):
                drv.run_once()
        assert svc.registry.version == before
        snap = svc.metrics_snapshot()["refit"]
        assert snap["runs"] == 1 and snap["failures"] == 1
    finally:
        svc.close()


def test_swap_transient_fault_retried_to_success(root, tmp_path):
    svc, _log, drv = _driver(root, tmp_path, backoff_s=0.001)
    try:
        plan = faults.FaultPlan([{"site": "refit.swap", "action": "transient",
                                  "hits": [1]}])
        with faults.injected(plan):
            result = drv.run_once()
        assert plan.report()["total_fired"] == 1
        assert result.swapped and svc.registry.version == result.version
        assert os.path.isdir(tmp_path / "models" / result.version)
        snap = svc.metrics_snapshot()["refit"]
        assert snap["swaps"] == 1 and snap["failures"] == 0
    finally:
        svc.close()


@pytest.mark.parametrize("case", ["losing", "tail_only", "empty_lane"])
def test_cycle_outcomes(root, tmp_path, case):
    """A candidate that cannot win the margin keeps the incumbent and
    writes nothing; a lane shorter than a chunk trains on its unsealed
    tail; an empty lane is a clean no-op."""
    kw = {"losing": dict(min_loss_improvement=1e6),
          "tail_only": dict(chunk_rows=256),
          "empty_lane": dict(lane=tmp_path / "empty")}[case]
    svc, _log, drv = _driver(root, tmp_path, **kw)
    try:
        before = svc.registry.version
        result = drv.run_once()
        snap = svc.metrics_snapshot()["refit"]
        assert snap["runs"] == 1 and snap["failures"] == 0
        if case == "tail_only":
            assert drv.compactor.manifest()["sealed_rows"] == 0
            assert (result.sealed_rows, result.tail_rows) == (0, 144)
            assert result.swapped and svc.registry.version == result.version
            return
        assert not result.swapped and svc.registry.version == before
        assert not (tmp_path / "models").exists() or not os.listdir(tmp_path / "models")
        if case == "losing":
            assert "incumbent" in result.reason
        else:
            assert "not enough" in result.reason
    finally:
        svc.close()


def test_lane_retention_clamped_by_the_compactor_checkpoint(tmp_path):
    from photon_ml_tpu_torch.fleet import record_for_feedback
    rng = np.random.default_rng(12)
    log = FeedbackLog(str(tmp_path / "fb"), segment_records=1)
    for k in range(6):
        log.append(record_for_feedback({"global": rng.normal(size=(4, oj.D_G))},
                                       {"userId": np.asarray(["u1"] * 4, dtype=object)},
                                       np.ones(4), wall_s=float(k)))
    comp = LogCompactor(log, str(tmp_path / "chunks"), CompactorConfig(chunk_rows=8))
    log.register_consumer("refit-compactor", comp.checkpoint_seq)
    assert log.compact(6) is None or log.compact(6)["upto_seq"] == 0
    assert [int(e["log_seq"]) for e in log.read(0)] == list(range(1, 7))
    comp.compact()
    ckpt = comp.checkpoint_seq()
    assert ckpt >= 4
    before = log.live_records()
    snap = log.compact(10_000)
    assert snap is not None and snap["upto_seq"] == ckpt
    assert log.live_records() < before
    assert all(int(e["log_seq"]) > ckpt for e in log.read(ckpt))


def test_refit_runs_where_the_incumbent_lives(root, tmp_path):
    """A float32 registry refits in float32: the candidate's tables keep
    the incumbent's dtype and device."""
    svc = ScoringService(model_dir=str(root["root"] / "model"), start_updater=False,
                         config=ServingConfig(device="cpu", dtype=torch.float32))
    try:
        comp = LogCompactor(FeedbackLog(str(root["root"] / "lane")),
                            str(tmp_path / "chunks"),
                            CompactorConfig(chunk_rows=fj.CHUNK_ROWS))
        drv = RefitDriver(svc.registry, comp, str(tmp_path / "models"))
        fit = drv.fit_candidate(drv.gather_rows())
        for m in fit.model.coordinates.values():
            t = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
            assert t.dtype == torch.float32 and t.device.type == "cpu"
    finally:
        svc.close()


# -- the trigger's state machine (host only) ----------------------------------

class _FakeDriver:
    def __init__(self, fail=False):
        self.calls = 0
        self.fail = fail

    def run_once(self, version=None):
        self.calls += 1
        if self.fail:
            raise ValueError("boom")
        return RefitResult(swapped=True, version=f"v{self.calls}", reason="ok",
                           train_rows=1, holdout_rows=1, sealed_rows=0,
                           tail_rows=2, checkpoint_seq=0, objective_history=[],
                           candidate={}, incumbent={})


class _FakeHealth:
    degraded = False


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_trigger_manual_and_interval():
    drv = _FakeDriver()
    trig = RefitTrigger(drv, config=TriggerConfig(mode="manual"))
    assert trig.poll() is None and drv.calls == 0
    assert trig.run_once().swapped and trig.state()["swaps"] == 1
    drv, clock = _FakeDriver(), _Clock()
    trig = RefitTrigger(drv, config=TriggerConfig(mode="interval", interval_s=100.0),
                        clock=clock)
    assert trig.poll() is not None
    clock.t = 50.0
    assert trig.poll() is None
    clock.t = 100.0
    assert trig.poll() is not None and drv.calls == 2
    assert trig.state()["last_reason"] == "interval"


def test_trigger_on_trip_debounces_and_cools_off():
    drv, clock, health = _FakeDriver(), _Clock(), _FakeHealth()
    trig = RefitTrigger(drv, health=health,
                        config=TriggerConfig(mode="on_trip", trip_polls=2,
                                             cooloff_s=60.0), clock=clock)
    assert trig.poll() is None
    health.degraded = True
    assert trig.poll() is None
    assert trig.poll() is not None
    assert trig.state()["last_reason"] == "health_trip"
    assert trig.poll() is None and trig.poll() is None
    clock.t = 60.0
    assert trig.poll() is not None
    health.degraded = False
    trig.poll()
    assert trig.state()["degraded_polls"] == 0 and drv.calls == 2


def test_trigger_on_trip_debounce_resets_on_a_healthy_poll():
    drv, health = _FakeDriver(), _FakeHealth()
    trig = RefitTrigger(drv, health=health,
                        config=TriggerConfig(mode="on_trip", trip_polls=2,
                                             cooloff_s=0.0), clock=_Clock())
    health.degraded = True
    assert trig.poll() is None
    health.degraded = False
    assert trig.poll() is None
    health.degraded = True
    assert trig.poll() is None and drv.calls == 0


def test_trigger_records_cycle_errors_and_validates_its_config():
    drv = _FakeDriver(fail=True)
    trig = RefitTrigger(drv, config=TriggerConfig(mode="interval", interval_s=1.0),
                        clock=_Clock())
    assert trig.poll() is None and drv.calls == 1
    assert "boom" in trig.state()["last_error"]
    with pytest.raises(ValueError, match="health"):
        RefitTrigger(_FakeDriver(), config=TriggerConfig(mode="on_trip"))
    with pytest.raises(ValueError, match="mode"):
        TriggerConfig(mode="cron")


def test_trigger_on_trip_polls_the_service_health_monitor(root, tmp_path):
    """on_trip reads HealthMonitor.degraded: a tripped calibration gate on
    a real service fires one cycle."""
    from photon_ml_tpu_torch.health import HealthConfig
    from photon_ml_tpu_torch.online import OnlineUpdateConfig
    svc = ScoringService(model_dir=str(root["root"] / "model"), start_updater=False,
                         config=ServingConfig(device="cpu", dtype=F64),
                         updates=OnlineUpdateConfig(micro_batch=8),
                         health=HealthConfig(**{**fj.HEALTH, "sustain_windows": 1}))
    try:
        drv = _FakeDriver()
        trig = RefitTrigger(drv, health=svc.health,
                            config=TriggerConfig(mode="on_trip", trip_polls=1,
                                                 cooloff_s=0.0), clock=_Clock())
        assert trig.poll() is None
        feats, ids, rng = fj._rows(5, fj.HEALTH["window_labels"])
        svc.feedback(feats, ids, fj._labels_from(svc, feats, ids, rng, flip=True))
        assert svc.health.degraded and trig.poll() is not None and drv.calls == 1
    finally:
        svc.close()


def test_cli_refit_needs_cuda_unless_told_otherwise(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        refit_cli.main([str(a) for a in fj.refit_argv(root["root"], "nocuda")])
