"""Parity of the port's health monitor (health/*, ScoringService(health=...))
with the JAX package's, on the CPU in float64.

The JAX side (fleet_jax_side.py health, one subprocess per module) runs
the streaming calibration and drift detector on seeded streams (held equal
here within 1e-12) and fleet_jax_side.health_walk: a service with the
online updater and the monitor armed walks through a clean baseline,
calibrated feedback published as deltas, a shifted feature stream, flipped
labels and clean traffic.  The port runs the same walk: the same gates
trip and recover in the same steps, the updater pauses and resumes there,
the one delta-aware rollback returns the tables to the JAX package's
hashes, and the gate values agree within WALK_RTOL (the deltas agree to
1e-8, see test_torch_online.AT_OPTIMUM_RTOL).  The batch Hosmer-Lemeshow
oracle, config validation, the swap reset and the fault site run on the
port alone, as tests/test_health.py runs them on the JAX package, and so
does a gate's trip beside scoring threads with the lock tracker armed,
held to the port's static lock-order graph (the port's linter).
"""
import threading

import numpy as np
import pytest
import torch

import fleet_jax_side as fj
import online_jax_side as oj
from test_torch_lint import port_lock_edges
from test_torch_online import PKG as ONLINE_PKG
from test_torch_online import host
from photon_ml_tpu_torch.diagnostics.hl import hosmer_lemeshow
from photon_ml_tpu_torch.health import (DriftDetector, HealthConfig,
                                        HealthMonitor, StreamingCalibration)
from photon_ml_tpu_torch.online import OnlineUpdateConfig
from photon_ml_tpu_torch.serving import (CompiledScorer, ScoringService,
                                         ServingConfig)
from photon_ml_tpu_torch.utils import faults, locktrace

STATS_RTOL = 1e-12
WALK_RTOL = 1e-8
F64 = torch.float64
PKG = {**ONLINE_PKG, "HealthConfig": HealthConfig,
       "StreamingCalibration": StreamingCalibration,
       "DriftDetector": DriftDetector}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return fj.run_jax_side("health", tmp_path_factory.mktemp("health_jax"))


@pytest.fixture(scope="module")
def port_walk():
    return fj.health_walk(PKG, host)


def close(a, b, rtol):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)))


def test_streaming_statistics_match_jax(jax_side):
    port, jax = fj.health_stats(PKG), jax_side["stats"]
    assert len(port["calibration"]) == len(jax["calibration"])
    for p, j in zip(port["calibration"] + [port["calibration_taken"]],
                    jax["calibration"] + [jax["calibration_taken"]]):
        assert p.keys() == j.keys()
        assert p["count"] == j["count"]
        assert p["degrees_of_freedom"] == j["degrees_of_freedom"]
        for k in ("chi_squared", "prob_at_chi_square", "p_value",
                  "expected_pos", "observed_neg"):
            if k in p:
                assert close(p[k], j[k], STATS_RTOL), k
    assert [w is None for w in port["drift"]] == [w is None for w in jax["drift"]]
    for p, j in zip(port["drift"], jax["drift"]):
        if p is not None:
            assert p["count"] == j["count"]
            for k in ("psi", "ks", "fractions"):
                assert close(p[k], j[k], STATS_RTOL), k


def test_health_walk_matches_jax(jax_side, port_walk):
    """Same steps, same gate trips/recoveries, pauses and rollbacks; the
    tables return to the JAX package's hashes after the rollback."""
    port, jax = port_walk, jax_side["walk"]
    assert port["hashes0"] == jax["hashes0"]
    assert port["metrics"] == jax["metrics"]
    assert [s["step"] for s in port["steps"]] == [s["step"] for s in jax["steps"]]
    for p, j in zip(port["steps"], jax["steps"]):
        for k in ("status", "tripped", "trips", "windows", "rollbacks",
                  "paused_by_health", "updater_paused", "pending_deltas",
                  "healthz_status"):
            assert p[k] == j[k], (p["step"], k)
        for gate, v in p["values"].items():
            assert close(v, j["values"][gate], WALK_RTOL), (p["step"], gate)
        if p["pending_deltas"] == 0:
            assert p["hashes"] == j["hashes"], p["step"]


def test_health_walk_trips_pauses_rolls_back_and_recovers(port_walk):
    steps = {s["step"]: s for s in port_walk["steps"]}
    assert steps["baseline"]["status"] == "ok"
    assert steps["calibrated_feedback"]["pending_deltas"] > 0
    shifted = steps["shifted_scores"]
    assert shifted["status"] == "degraded" and "drift_psi" in shifted["tripped"]
    assert shifted["updater_paused"] and shifted["paused_by_health"]
    flipped = steps["flipped_labels"]
    assert "calibration" in flipped["tripped"] and flipped["rollbacks"] == 1
    assert flipped["pending_deltas"] == 0
    assert flipped["hashes"] == port_walk["hashes0"]
    assert flipped["healthz_status"] == "degraded"
    last = steps["clean_feedback"]
    assert last["status"] == "ok" and last["tripped"] == []
    assert not last["updater_paused"] and not last["paused_by_health"]
    assert port_walk["metrics"]["recoveries"] >= 2


def test_health_lifecycle_lock_orders_match_the_static_graph():
    """Calibrated feedback published as deltas, then flipped labels that
    trip the calibration gate (pause + rollback), beside two scoring
    threads, with the lock tracker ARMED (as the JAX package's
    tests/test_health.py arms it): every observed acquisition order is an
    edge of the port's static lock-order graph, and the monitor's lock was
    taken."""
    with locktrace.enabled() as tracker:
        svc = ScoringService(
            model=oj.build_model(PKG, oj.model_arrays()),
            config=PKG["serving_config"](max_batch=64, min_bucket=64),
            updates=OnlineUpdateConfig(**fj.UPDATES), start_updater=False,
            health=HealthConfig(**fj.HEALTH))
        errors, stop = [], threading.Event()

        def scorer_loop(seed):
            k = 0
            while not stop.is_set():
                feats, ids, _ = fj._rows(seed + k % 5, 8)
                k += 1
                try:
                    svc.score(feats, ids)
                except Exception as e:  # pragma: no cover
                    errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=scorer_loop, args=(s,), daemon=True)
                   for s in (11, 13)]
        for t in threads:
            t.start()
        try:
            for flip in (False, True, True):
                for k in range(2):
                    feats, ids, rng = fj._rows(70 + k, 32)
                    svc.feedback(feats, ids,
                                 fj._labels_from(svc, feats, ids, rng, flip))
                svc.updater.flush()
            assert svc.health.verdict()["gates"]["calibration"]["trips"] >= 1
            assert svc.healthz()["status"] in ("ok", "degraded")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            svc.close()
    assert errors == []
    tracker.assert_consistent(port_lock_edges())
    acq = tracker.acquisitions()
    for lock in ("HealthMonitor._lock", "ModelRegistry._lock"):
        assert acq.get(lock, 0) > 0, lock


def test_streaming_hl_matches_batch_oracle():
    """The streaming accumulator against the port's diagnostics/hl.py on
    the same traffic, ragged chunks, in float64."""
    rng = np.random.default_rng(7)
    n, bins = 2000, 10
    p = rng.uniform(size=n)
    y = (rng.uniform(size=n) < p).astype(float)
    report = hosmer_lemeshow(p, y, num_dimensions=bins - 2)
    assert report.degrees_of_freedom == bins - 2
    cal = StreamingCalibration(bins)
    for lo in range(0, n, 137):
        cal.update(p[lo:lo + 137], y[lo:lo + 137])
    win = cal.report()
    assert win.count == n
    assert win.chi_squared == pytest.approx(report.chi_squared, rel=1e-12)
    assert win.p_value == pytest.approx(report.p_value, rel=1e-9, abs=1e-15)
    for b in range(bins):
        assert win.expected_pos[b] == pytest.approx(report.bins[b].expected_pos,
                                                    rel=1e-12, abs=1e-12)
        assert win.observed_neg[b] == report.bins[b].observed_neg


def test_streaming_hl_chunking_invariant_and_flip_collapse():
    """Any chunking of one stream gives the same verdict; take() resets;
    flipped labels collapse the p-value."""
    rng = np.random.default_rng(8)
    n = 1500
    p = rng.uniform(size=n)
    y = (rng.uniform(size=n) < p).astype(float)
    outs = []
    for step in (1500, 251, 17):
        cal = StreamingCalibration(10)
        for lo in range(0, n, step):
            cal.update(p[lo:lo + step], y[lo:lo + step])
        outs.append(cal.take())
    assert outs[0].chi_squared == pytest.approx(outs[1].chi_squared, rel=1e-12)
    assert outs[1].chi_squared == pytest.approx(outs[2].chi_squared, rel=1e-12)
    cal.update(p[:10], y[:10])
    assert cal.count == 10
    good, bad = StreamingCalibration(10), StreamingCalibration(10)
    good.update(p, y)
    bad.update(p, 1.0 - y)
    assert good.report().p_value > 1e-6 and bad.report().p_value < 1e-12


@pytest.mark.parametrize("case", ["stationary", "shifted", "baseline_filling"])
def test_drift_detector(case):
    """Stationary traffic stays under the gates over 30 windows, a shifted
    and widened stream breaches both, and rows that fill the baseline
    count toward no window."""
    rng = np.random.default_rng(9)
    if case == "baseline_filling":
        det = DriftDetector(bins=10, baseline_size=256)
        det.observe(rng.normal(size=100))
        assert not det.baseline_ready and det.take() is None
        det.observe(rng.normal(size=200))
        assert det.baseline_ready and det.window_count == 44
        return
    det = DriftDetector(bins=10, baseline_size=2048)
    det.observe(rng.normal(size=2048))
    assert det.baseline_ready
    if case == "shifted":
        det.observe(1.5 + 1.2 * rng.normal(size=2048))
        win = det.take()
        assert win.psi > 0.25 and win.ks > 0.2
        return
    wins = []
    for _ in range(30):
        det.observe(rng.normal(size=2048))
        wins.append(det.take())
    assert max(w.psi for w in wins) < 0.25 and max(w.ks for w in wins) < 0.2


def test_healthz_carries_the_updater_vitals_and_every_gate():
    svc = _service()
    bare = ScoringService(model=oj.build_model(PKG, oj.model_arrays()),
                          config=ServingConfig(device="cpu", dtype=F64))
    try:
        feats, ids, rng = fj._rows(40, 16)
        svc.feedback(feats, ids, fj._labels_from(svc, feats, ids, rng, flip=False))
        svc.updater.flush()
        hz = svc.healthz()
        assert hz["status"] == "ok" and hz["updates_enabled"] and hz["health_enabled"]
        assert hz["updater"]["alive"] is False and hz["updater"]["pending_rows"] == 0
        assert set(hz["health"]["gates"]) == {"calibration", "drift_psi", "drift_ks",
                                              "auc", "loss", "delta_l2", "freeze_rate"}
        for g in hz["health"]["gates"].values():
            assert {"threshold", "value", "breaches", "tripped", "windows",
                    "trips"} <= set(g)
        hz = bare.healthz()
        assert hz["status"] == "ok" and "updater" not in hz and "health" not in hz
    finally:
        svc.close()
        bare.close()


def test_health_config_roundtrip_and_validation():
    cfg = HealthConfig(window_labels=64, rollback_on=("calibration",),
                       psi_max=0.3)
    assert HealthConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="unknown key"):
        HealthConfig.from_dict({"psi_threshold": 0.3})
    with pytest.raises(ValueError, match="unknown gate"):
        HealthConfig(rollback_on=("nonsense",))
    with pytest.raises(ValueError, match="must be >= 1"):
        HealthConfig(window_labels=0)


def _service(**health):
    return ScoringService(
        model=oj.build_model(PKG, oj.model_arrays()),
        config=ServingConfig(max_batch=64, min_bucket=4, device="cpu", dtype=F64),
        updates=OnlineUpdateConfig(micro_batch=8), start_updater=False,
        health=HealthConfig(**{**fj.HEALTH, **health}))


def _flipped(svc, seed):
    """One label window of flipped labels."""
    feats, ids, rng = fj._rows(seed, fj.HEALTH["window_labels"])
    return feats, ids, fj._labels_from(svc, feats, ids, rng, flip=True)


def test_baseline_resets_on_swap_and_releases_the_pause():
    svc = _service(sustain_windows=1)
    try:
        for k in range(4):
            svc.score(*fj._rows(10 + k, 64)[:2])
        assert svc.health.verdict()["baseline_ready"]
        svc.feedback(*_flipped(svc, 20))
        assert svc.healthz()["status"] == "degraded" and svc.updater.paused
        scorer2 = CompiledScorer(oj.build_model(PKG, oj.model_arrays(seed=4)),
                                 max_batch=64, min_bucket=4, device="cpu")
        svc.registry.install(scorer2, "v2")
        v = svc.health.verdict()
        assert v["status"] == "ok" and v["model_version"] == "v2"
        assert not v["baseline_ready"] and not svc.updater.paused
    finally:
        svc.close()


def test_health_evaluate_transient_fault_skips_window():
    svc = _service(sustain_windows=1)
    try:
        plan = faults.FaultPlan([{"site": "health.evaluate",
                                  "action": "transient", "hits": [1]}])
        with faults.injected(plan):
            svc.feedback(*_flipped(svc, 30))
        assert plan.report()["total_fired"] == 1
        v = svc.health.verdict()
        assert v["windows_skipped"] == 1 and v["status"] == "ok"
        assert svc.metrics_snapshot()["health"]["evaluate_skipped"] == 1
        svc.feedback(*_flipped(svc, 31))
        assert svc.healthz()["status"] == "degraded"
    finally:
        svc.close()


def test_health_takes_a_health_config_only():
    with pytest.raises(TypeError, match="health.HealthConfig"):
        ScoringService(model=oj.build_model(PKG, oj.model_arrays()),
                       config=ServingConfig(device="cpu", dtype=F64),
                       health={"psi_max": 0.3})


def test_standalone_monitor_reads_host_scores_only():
    """The monitor consumes the scorer's host numpy scores: a window
    closes without any tensor reaching it."""
    mon = HealthMonitor(HealthConfig(window_scores=16, baseline_scores=16))
    mon.observe_scores(np.random.default_rng(1).normal(size=40))
    v = mon.verdict()
    assert v["windows_evaluated"] == 1 and v["baseline_ready"]
