"""Parity of the port's online tier (game/anchored.py, online/feedback.py,
online/updater.py, models/io.py's deltas, ScoringService(updates=...) and
cli.serve's POST /feedback) with the JAX package's, on the CPU in float64.

The JAX side (online_jax_side.py online, one subprocess per module) runs
the scenario runners of online_jax_side.py; here the port runs the same
runners: the anchored solve (within 1e-9 of JAX, at scipy's optimum),
sub-dataset extraction (equal row ids), the updater against JAX and an
offline refit (drained order, delta rows, prior rows and counters equal,
values within 1e-9), intake accounting, a stale delta requeued and the
`online.solve` / `online.publish` faults (values within 1e-8, see
AT_OPTIMUM_RTOL), and delta directories written by either package loading
in the other with equal table hashes.  The
buffer's backpressure/dedup/window cases, feedback without updates, the
background loop and the HTTP /feedback 202 and 429 run on the port alone,
as tests/test_online.py runs them on the JAX package.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

import online_jax_side as oj
from photon_ml_tpu_torch import fleet
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.game.anchored import (anchored_objective_np,
                                               entity_rows,
                                               offline_anchored_refit,
                                               solve_anchored,
                                               sub_dataset_for_entities)
from photon_ml_tpu_torch.models import game
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.models.io import load_model_delta, save_model_delta
from photon_ml_tpu_torch.online import (FeedbackBuffer, Observation,
                                        OnlineUpdateConfig)
from photon_ml_tpu_torch.online import delta as delta_mod
from photon_ml_tpu_torch.ops import TASK_LOSSES
from photon_ml_tpu_torch.optim import OptimizerConfig
from photon_ml_tpu_torch.parallel.random_effect import EntityBlocks
from photon_ml_tpu_torch.serving import (Overloaded, ScoringService,
                                         ServingConfig, StaleDeltaError)
from photon_ml_tpu_torch.utils import faults

RTOL = 1e-9
# the intake, stale and fault scenarios compare their rows one decade
# looser: with tolerance 1e-12 a lane whose objective has stopped moving
# may stop on FUNCTION_VALUES_CONVERGED a few iterations before the other
# package's lane stops on its gradient (the last bits of the objective
# decide), a few 1e-9 away from it at the same optimum
AT_OPTIMUM_RTOL = 1e-8
F64 = torch.float64
PKG = {"asarray": lambda a: torch.tensor(a, dtype=F64),
       "Coefficients": Coefficients, "model_for_task": model_for_task,
       "GameModel": game.GameModel, "FixedEffectModel": game.FixedEffectModel,
       "RandomEffectModel": game.RandomEffectModel,
       "ScoringService": ScoringService,
       "serving_config": lambda **kw: ServingConfig(device="cpu", dtype=F64,
                                                    **kw),
       "OnlineUpdateConfig": OnlineUpdateConfig,
       "OptimizerConfig": OptimizerConfig, "StaleDeltaError": StaleDeltaError,
       "faults": faults, "build_game_dataset": build_game_dataset,
       "offline_anchored_refit": lambda *a, **kw: offline_anchored_refit(
           *a, device="cpu", **kw),
       "loss": TASK_LOSSES[oj.TASK], "load_model_delta": load_model_delta,
       **{k: getattr(fleet, k) for k in (
           "ReplicationLog", "FeedbackLog", "encode_array",
           "record_for_shard_map", "record_for_feedback", "ShardSpec")}}


def host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_jax")
    save_model_delta(oj.seeded_delta(delta_mod, 6, 92), str(root / "port_delta"))
    out = oj.run_jax_side("online", root)
    out["root"] = root
    return out


def check_deltas(port, jax, rtol=AT_OPTIMUM_RTOL):
    """Same deltas in the same order: seq, rows (the drained order) and
    prior rows equal, values within `rtol`."""
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert p.keys() == j.keys()
        for k in p:
            if k.endswith("/values"):
                assert rel(p[k], j[k]) <= rtol, k
            elif isinstance(p[k], np.ndarray):
                assert np.array_equal(p[k], j[k]), k
            else:
                assert p[k] == j[k], k


def test_anchored_solve_matches_jax_and_scipy(jax_side):
    a = oj.anchored_inputs()
    T = lambda v: torch.tensor(v, dtype=F64)
    blocks = EntityBlocks(x=T(a["x"]), labels=T(a["labels"]), mask=T(a["mask"]),
                          weights=T(a["mask"]), offsets=T(a["offsets"]))
    new_rows, res = solve_anchored(
        blocks, T(a["prior"]), TASK_LOSSES[oj.TASK],
        OptimizerConfig(max_iterations=200, tolerance=1e-12), a["lam"])
    new_rows = host(new_rows)
    assert rel(new_rows, jax_side["anchored"]) <= RTOL
    for e in range(new_rows.shape[0]):
        keep = a["mask"][e] > 0
        f = lambda c: anchored_objective_np(
            a["x"][e][keep], a["labels"][e][keep], None, a["offsets"][e][keep],
            c, a["prior"][e], oj.TASK, a["lam"])
        ref = minimize(f, a["prior"][e], method="L-BFGS-B", tol=1e-14)
        # at scipy's optimum: the objective no worse than scipy's, the row
        # within scipy's own precision
        assert f(new_rows[e]) <= ref.fun * (1 + RTOL)
        assert rel(new_rows[e], ref.x) <= 1e-5


def test_entity_sub_dataset_extraction(jax_side):
    feats, ids, labels = oj.feedback(12, 40)
    ds = build_game_dataset(labels, feats, entity_ids=ids)
    wanted = ["u1", "u3"]
    rows = entity_rows(ds, "userId", wanted)
    assert np.array_equal(rows, jax_side["extract"])
    assert set(ids["userId"][rows].tolist()) <= set(wanted)
    n_expected = int(np.isin(ids["userId"].astype(str), wanted).sum())
    assert len(rows) == n_expected
    assert sub_dataset_for_entities(ds, "userId", wanted).num_rows == n_expected


def test_updater_matches_jax_and_the_offline_refit(jax_side):
    port, jax = oj.run_parity(PKG, host), jax_side["parity"]
    assert np.array_equal(port["table0"], jax["table0"])
    for key in ("intake", "flush", "counters", "rows"):
        assert port[key] == jax[key], key
    assert port["flush"]["deltas"] == 2      # micro_batch 4 < 7 entities
    check_deltas(port["deltas"], jax["deltas"], RTOL)
    assert rel(port["table1"], jax["table1"]) <= RTOL
    for u, row in port["rows"].items():
        assert rel(port["offline"][u], jax["offline"][u]) <= RTOL, u
        # the online path and the training-side refit land together
        assert rel(port["table1"][row], port["offline"][u]) <= 1e-6, u
        assert not np.array_equal(port["table1"][row], port["table0"][row])
    untouched = sorted(set(range(oj.N_ENT)) - set(port["rows"].values()))
    assert np.array_equal(port["table1"][untouched], port["table0"][untouched])


def test_intake_accounting_matches_jax(jax_side):
    port, jax = oj.run_intake(PKG, host), jax_side["intake"]
    for key in ("unseen", "events", "retry", "window", "pending", "flush",
                "counters"):
        assert port[key] == jax[key], key
    assert port["unseen"]["dropped_unseen"] == 2
    assert port["retry"]["accepted"] == 0 and port["retry"]["deduped"] == 6
    assert port["window"]["coalesced"] >= 3
    check_deltas(port["deltas"], jax["deltas"])


def test_stale_delta_requeued_matches_jax(jax_side):
    port, jax = oj.run_stale(PKG, host), jax_side["stale"]
    for key in ("first", "pending", "flush", "counters"):
        assert port[key] == jax[key], key
    assert port["first"]["deltas"] == 0 and port["pending"] > 0
    assert port["flush"]["deltas"] >= 1
    assert port["counters"]["stale_deltas"] == 1
    check_deltas(port["deltas"], jax["deltas"])


@pytest.mark.parametrize("case", list(oj.FAULTS))
def test_fault_containment_matches_jax(jax_side, case):
    port, jax = oj.run_fault(PKG, host, case), jax_side[f"fault/{case}"]
    keys = ["flush", "fired", "table_untouched", "frozen", "counters"]
    keys += ["after", "after_flush"] if case == "poison" else []
    for key in keys:
        assert port[key] == jax[key], key
    assert port["fired"] == 1
    if case.startswith("transient"):
        assert port["flush"]["deltas"] >= 1          # the retry absorbed it
    else:
        # poison freezes the entities, fatal drops the batch: neither
        # reaches the live table
        assert port["flush"]["deltas"] == 0 and port["table_untouched"]
    if case == "poison":
        assert port["frozen"] == ["u3", "u4"]
        assert port["after"]["dropped_frozen"] == 1
        assert port["after_flush"]["deltas"] == 1
    if port["deltas"]:
        check_deltas(port["deltas"], jax["deltas"])
    else:
        assert port["hashes"] == jax["hashes"]


def test_delta_dirs_load_in_either_package(jax_side):
    root = jax_side["root"]
    port_reads_jax = oj.apply_delta_dir(PKG, root / "jax_delta")
    assert port_reads_jax == jax_side["delta/jax"]
    assert oj.apply_delta_dir(PKG, root / "port_delta") == jax_side["delta/port"]
    assert jax_side["delta/port"]["version_vector"]["delta_seq"] == 6


def test_delta_durability_roundtrip_and_verification(tmp_path):
    delta = oj.seeded_delta(delta_mod, 3, 5)
    ddir = tmp_path / "delta"
    save_model_delta(delta, str(ddir))
    assert (ddir / "manifest.json").exists() and (ddir / "delta.npz").exists()
    assert not list(ddir.glob("*.tmp*"))
    loaded = load_model_delta(str(ddir))
    assert (loaded.base_version, loaded.seq) == ("inline@1", 3)
    cd, lcd = delta.coordinates["perUser"], loaded.coordinates["perUser"]
    for k in ("rows", "values", "prior"):
        assert np.array_equal(getattr(cd, k), getattr(lcd, k))
    (ddir / "delta.npz").write_bytes(b"corrupt")
    with pytest.raises(ValueError, match="manifest"):
        load_model_delta(str(ddir))
    with pytest.raises(FileNotFoundError):
        load_model_delta(str(tmp_path / "nowhere"))


def _obs(rng, entity="u0", event_id=None, t=0.0):
    return Observation(
        features={"global": rng.normal(size=oj.D_G),
                  "per_user": rng.normal(size=oj.D_U)},
        ids={"userId": entity}, label=1.0, weight=1.0, offset=0.0,
        enqueued_at=t, event_id=event_id)


def test_buffer_backpressure_overloaded():
    rng = np.random.default_rng(1)
    buf = FeedbackBuffer(max_rows=8, entity_window=8)
    buf.offer_batch([("perUser", f"u{i}", i, _obs(rng, f"u{i}")) for i in range(8)])
    with pytest.raises(Overloaded):
        buf.offer_batch([("perUser", "u9", 9, _obs(rng, "u9"))])
    assert buf.stats()["shed"] == 1
    assert buf.pending_rows == 8          # all-or-nothing rejection
    buf.drain("perUser", 8)
    assert buf.offer_batch([("perUser", "u9", 9, _obs(rng, "u9"))])["accepted"] == 1


def test_buffer_event_dedup_entity_window_and_requeue():
    rng = np.random.default_rng(2)
    buf = FeedbackBuffer(max_rows=100, entity_window=3, dedup_window=10)
    assert buf.offer_batch([("perUser", "u0", 0, _obs(rng, "u0", "ev-1"))])[
        "accepted"] == 1
    out = buf.offer_batch([("perUser", "u0", 0, _obs(rng, "u0", "ev-1"))])
    assert out["accepted"] == 0 and out["deduped"] == 1
    b = _obs(rng, "u1", event_id="ev-2")  # one event on two lanes: no dup
    out = buf.offer_batch([("perUser", "u1", 1, b), ("perItem", "i1", 0, b)])
    assert out["accepted"] == 2 and out["deduped"] == 0
    buf.offer_batch([("perUser", "u0", 0, _obs(rng, "u0", t=float(i)))
                     for i in range(6)])
    drained = buf.drain("perUser", 10)
    u0 = next(ef for ef in drained if ef.entity_id == "u0")
    assert [o.enqueued_at for o in u0.observations] == [3.0, 4.0, 5.0]
    # a requeue puts the entities back first, original times kept
    buf.offer_batch([("perUser", "u7", 7, _obs(rng, "u7", t=9.0))])
    buf.requeue("perUser", drained)
    again = buf.drain("perUser", 10)
    assert [ef.entity_id for ef in again][-1] == "u7"
    assert next(ef for ef in again if ef.entity_id == "u0").first_enqueued_at == 3.0
    assert buf.drop_entity("perUser", "nobody") == 0


def _service(**kw):
    return oj._service(PKG, **kw)


def test_update_config_validation_and_window_clamp():
    with pytest.raises(ValueError, match="micro_batch"):
        OnlineUpdateConfig(micro_batch=0)
    with pytest.raises(ValueError, match="micro_batch"):
        OnlineUpdateConfig(max_rows_per_entity=0)
    cfg = OnlineUpdateConfig(micro_batch=12, max_rows_per_entity=8,
                             entity_window=128)
    assert cfg.entity_window == 8 and cfg.lanes_pow2 == 16
    with pytest.raises(ValueError, match="max_rows and entity_window"):
        FeedbackBuffer(max_rows=0)


def test_pause_holds_feedback_and_resume_publishes():
    svc = _service(micro_batch=8, interval_s=0.01)
    try:
        u = svc.updater
        # before any drain the Retry-After hint is the poll-interval floor
        assert u.retry_after_s() == 0.05 and u.last_cycle_age_s() is None
        u.pause("operator")
        u.pause("again")                           # idempotent
        assert u.paused and u.pause_reason == "operator"
        svc.feedback(*oj.feedback(5, 6))
        assert u.run_once() == {"entities": 0, "rows": 0, "deltas": 0}
        assert u.flush()["deltas"] == 0 and u.buffer.pending_rows == 6
        assert svc.healthz()["updater"]["paused"] is True
        u.resume()
        out = u.flush()
        assert out["deltas"] >= 1 and u.buffer.pending_rows == 0
        assert u.retry_after_s() >= 0.05 and u.last_cycle_age_s() >= 0.0
    finally:
        svc.close()


def test_stats_probe_and_metrics_snapshot():
    svc = _service(micro_batch=4)
    try:
        svc.feedback(*oj.feedback(6, 8))
        svc.updater.flush()
        stats = svc.updater.stats()
        assert stats["deltas_published"] == svc.version_vector()["delta_seq"] >= 1
        assert stats["buffer"]["accepted"] == 8 and stats["last_error"] is None
        probe = svc.updater.probe()
        assert probe["alive"] is False and probe["frozen"] == 0
        online = svc.metrics_snapshot()["online"]
        assert online["pending_rows"] == 0 and online["frozen"] == 0
        assert online["pending_deltas"] == svc.registry.pending_deltas() >= 1
    finally:
        svc.close()


def test_updater_start_close_race_spawns_one_thread():
    """Racing start() calls launch ONE loop thread, and close() joins it
    outside the state lock the loop takes; the updater restarts after."""
    svc = _service(micro_batch=8)
    try:
        before = {t.ident for t in threading.enumerate()}
        barrier = threading.Barrier(8)

        def racer():
            barrier.wait(timeout=5)
            svc.updater.start()

        racers = [threading.Thread(target=racer) for _ in range(8)]
        for t in racers:
            t.start()
        for t in racers:
            t.join(timeout=5)
        spawned = [t for t in threading.enumerate()
                   if t.ident not in before and t.name == "photon-online-updater"]
        assert len(spawned) == 1
        svc.updater.close(timeout=5)
        assert not spawned[0].is_alive()
        svc.updater.start()
        svc.updater.close(timeout=5)
        assert not svc.updater.alive()
    finally:
        svc.close()


def test_feedback_refused_without_updates():
    svc = _service()
    try:
        with pytest.raises(RuntimeError, match="--enable-updates"):
            svc.feedback(*oj.feedback(3, 2))
        assert svc.healthz()["updates_enabled"] is False
    finally:
        svc.close()
    with pytest.raises(ValueError, match="requires updates"):
        ScoringService(model=oj.build_model(PKG, oj.model_arrays()),
                       config=PKG["serving_config"](), feedback_log_dir="x")


def test_background_updater_publishes_and_reports_vitals():
    svc = ScoringService(model=oj.build_model(PKG, oj.model_arrays()),
                         config=PKG["serving_config"](max_batch=64, min_bucket=4),
                         updates=OnlineUpdateConfig(micro_batch=8, interval_s=0.01))
    try:
        svc.feedback(*oj.feedback(4, 12))
        deadline = time.time() + 60
        while time.time() < deadline:
            if svc.metrics_snapshot()["online"]["deltas_published"] >= 1 \
                    and svc.updater.buffer.pending_rows == 0:
                break
            time.sleep(0.02)
        assert svc.updater.warmed and svc.updater.warmup_s > 0
        snap = svc.metrics_snapshot()
        assert snap["online"]["deltas_published"] >= 1
        assert snap["online"]["entities_updated"] >= 1
        f2p = snap["online"]["feedback_to_publish_ms"]
        assert f2p is not None and f2p["p99"] >= f2p["p50"] >= 0.0
        vitals = svc.healthz()["updater"]
        assert vitals["alive"] is True and vitals["frozen"] == 0
        text = svc.prometheus_metrics()
        assert "photon_online_deltas_published_total" in text
    finally:
        svc.close()
    assert not svc.updater.alive()


def test_http_feedback_202_and_429():
    """cli.serve's POST /feedback: 202 with the intake accounting, a retry
    of the same event ids deduplicated, a batch past --feedback-max-pending
    429 with Retry-After, and the updater's vitals in /healthz."""
    from photon_ml_tpu_torch.cli.serve import _make_http_server
    svc = ScoringService(
        model=oj.build_model(PKG, oj.model_arrays()),
        config=PKG["serving_config"](max_batch=64, min_bucket=4),
        updates=OnlineUpdateConfig(micro_batch=8, max_pending_rows=8),
        start_updater=False)
    httpd = _make_http_server(svc, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, dict(resp.headers), json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    def body(n, seed):
        feats, ids, labels = oj.feedback(seed, n)
        return {"features": {s: x.tolist() for s, x in feats.items()},
                "ids": {k: v.tolist() for k, v in ids.items()},
                "labels": labels.tolist(),
                "event_ids": [f"ev{seed}-{i}" for i in range(n)]}

    try:
        status, _, out = post("/feedback", body(6, 1))
        assert status == 202 and out["accepted"] == 6
        assert out["version_vector"]["delta_seq"] == 0
        status, _, out = post("/feedback", body(6, 1))
        assert status == 202 and out["accepted"] == 0 and out["deduped"] == 6
        status, headers, out = post("/feedback", body(6, 2))
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert out["retry_after_s"] > 0
        status, _, out = post("/feedback", {"features": {}, "ids": {}})
        assert status == 400
        svc.updater.flush()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as resp:
            health = json.loads(resp.read())
        assert health["updates_enabled"] is True
        assert health["version_vector"]["delta_seq"] >= 1
        assert health["updater"]["pending_rows"] == 0
        assert svc.metrics_snapshot()["online"]["feedback_rejected"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
        svc.close()


def test_online_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService(model=oj.build_model(PKG, oj.model_arrays()),
                       updates=OnlineUpdateConfig())
    feats, ids, labels = oj.feedback(12, 8)
    ds = build_game_dataset(labels, feats, offsets=np.zeros(8), entity_ids=ids)
    prior = {u: np.zeros(oj.D_U) for u in set(ids["userId"].tolist())}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline_anchored_refit(ds, "userId", "per_user", prior,
                               TASK_LOSSES[oj.TASK])
