"""Parity of the port's serving stack (photon_ml_tpu_torch/serving/,
online/delta.py, cli/serve.py) with the JAX package's, on the CPU in
float64.

The JAX side (serving_jax_side.py serving, one subprocess per module)
scores the same seeded requests through its CompiledScorer and walks its
ModelRegistry through a delta warmup, two deltas, a delta-aware rollback, a
replay of that rollback's published row state, a background swap
(load_async) and a full rollback, resident and through the tiered store.  Here the port does
the same: scores within 1e-12 relative for every bucket (unseen ids, FE +
RE + projected RE + factored RE + MF), table hashes bit-equal at every
stage, the tiered store's counters equal.  Then the ServingMetrics surface
(SNAPSHOT_PATHS three ways, and equal to the JAX package's), the
micro-batcher, a hot swap under a burst, cli.serve in burst mode against
cli.score, and one cli.serve HTTP child (--device cpu) answering /score and
draining on SIGTERM.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import serving_jax_side as sj
from photon_ml_tpu_torch.models import game
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.models.io import (save_game_model,
                                           save_game_model_reference_layout)
from photon_ml_tpu_torch.online import delta as delta_mod
from photon_ml_tpu_torch.serving import (BatcherConfig, CompiledScorer,
                                         DeadlineExceeded, MicroBatcher,
                                         ModelRegistry, Overloaded,
                                         ScoringService, ServingConfig)
from photon_ml_tpu_torch.serving.metrics import SNAPSHOT_PATHS, ServingMetrics
from photon_ml_tpu_torch.store import StoreConfig
from photon_ml_tpu_torch.utils.events import (EventEmitter, EventListener,
                                              ModelSwapEvent)

ROOT = Path(__file__).resolve().parents[2]
PKG = {"asarray": lambda a: torch.tensor(a, dtype=torch.float64),
       "Coefficients": Coefficients, "model_for_task": model_for_task,
       **{k: getattr(game, k) for k in (
           "GameModel", "FixedEffectModel", "RandomEffectModel",
           "FactoredRandomEffectModel", "MatrixFactorizationModel")}}
RTOL = 1e-12


def host(t):
    return t.detach().cpu().numpy()


def model(scale=1.0, keep=None):
    m = sj.build_model(PKG, sj.model_arrays(scale=scale))
    if keep is not None:
        m = game.GameModel({k: m.coordinates[k] for k in keep}, m.task_type)
    return m


def scorer(scale=1.0, **kw):
    return CompiledScorer(model(scale), max_batch=sj.MAX_BATCH,
                          min_bucket=sj.MIN_BUCKET, device="cpu", **kw)


def close(port, jax):
    """Within RTOL of max(1, |jax|), elementwise."""
    port, jax = np.asarray(port, np.float64), np.asarray(jax, np.float64)
    assert port.shape == jax.shape
    err = np.abs(port - jax) / np.maximum(1.0, np.abs(jax))
    assert err.max(initial=0.0) <= RTOL, err.max()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return sj.run_jax_side("serving", tmp_path_factory.mktemp("serving_jax"))


@pytest.fixture(scope="module")
def warm_scorer():
    s = scorer()
    s.warmup()
    return s


@pytest.mark.parametrize("i", range(len(sj.REQUEST_ROWS)),
                         ids=[f"rows{n}" for n in sj.REQUEST_ROWS])
def test_scores_match_jax(jax_side, warm_scorer, i):
    feats, ids = sj.requests()[i]
    res = warm_scorer.score(feats, ids)
    close(res.scores, jax_side[f"scores/{i}"])
    assert res.buckets == jax_side[f"buckets/{i}"].tolist()
    assert [res.entity_hits, res.entity_lookups] == jax_side[f"hits/{i}"].tolist()
    assert res.new_compiles == 0      # warmup saw every bucket
    margins = warm_scorer.score_margins(feats, ids)
    assert list(margins) == [m["name"] for m in warm_scorer.coordinate_meta()]
    for name, z in margins.items():
        close(z, jax_side[f"margins/{i}/{name}"])


def test_bucket_compiles_count_first_seen_buckets():
    s = scorer()
    assert s.bucket_sizes() == [4, 8, 16, 32]
    feats, ids = sj.requests()[4]           # 8 rows
    assert s.score(feats, ids).new_compiles == 1
    assert s.score(feats, ids).new_compiles == 0
    s.warmup()
    assert s.bucket_compiles == 4


def test_mean_prediction_matches_jax(jax_side, warm_scorer):
    close(warm_scorer.mean_prediction(jax_side["scores/0"]), jax_side["predict"])


@pytest.fixture(scope="module")
def registry_walks(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_walks")
    out = {}
    for walk in ("resident", "tiered"):
        kw = lambda scale: {} if walk == "resident" else {
            "store": StoreConfig(**sj.STORE_CONFIG),
            "store_dir": str(root / str(scale))}
        first = scorer(**kw(1.0))
        first.warmup()
        res = sj.run_registry(ModelRegistry, first,
                              lambda: scorer(0.5, **kw(0.5)), delta_mod, host)
        res["totals"] = np.asarray(sorted(first.store_totals().items()),
                                   dtype=object)
        out[walk] = res
    return out


@pytest.mark.parametrize("walk", ["resident", "tiered"])
def test_registry_walk_matches_jax(jax_side, registry_walks, walk):
    """Table hashes and pending deltas equal to the JAX package's after
    load, a delta warmup, two deltas, the delta-aware rollback, a replay of
    its published row state, a load_async swap and a full rollback; scores
    within RTOL at every stage; the publish and swap hooks fire in the same
    order; the tiered store's counters equal."""
    port = registry_walks[walk]
    hashes = {}
    for stage in sj.STAGES:
        mine = dict(port[f"hashes/{stage}"].tolist())
        theirs = dict(jax_side[f"{walk}/hashes/{stage}"].tolist())
        assert mine.keys() == theirs.keys()
        for lane in sj.EXACT_LANES:
            assert mine[lane] == theirs[lane], (stage, lane)
        hashes[stage] = mine
        for i in range(len(sj.REQUEST_ROWS)):
            close(port[f"scores/{stage}/{i}"],
                  jax_side[f"{walk}/scores/{stage}/{i}"])
        assert port[f"pending/{stage}"] == jax_side[f"{walk}/pending/{stage}"]
    for stage in ("warmup_delta", "rollback", "replay", "rollback_full"):
        assert hashes[stage] == hashes["load"], stage
    assert hashes["redelta"] == hashes["delta1"]
    assert hashes["swap"] != hashes["load"]
    assert [port[f"pending/{s}"] for s in sj.STAGES] == [0, 0, 1, 2, 0, 1, 0, 0, 0]
    for events in ("publish", "swap"):
        assert (port[f"events/{events}"].tolist()
                == jax_side[f"{walk}/events/{events}"].tolist()), events
    assert [e[1] for e in port["events/publish"].tolist()] == [
        "swap", "delta", "delta", "delta_rollback", "delta", "swap", "rollback"]
    assert port["events/swap"].tolist() == [
        ["v1", "swap"], ["v2", "swap"], ["v1", "rollback"]]
    assert port["events/built_on"].tolist() == ["photon-serving-swap"]
    assert hashes["delta1"]["perUser"] != hashes["load"]["perUser"]
    assert hashes["delta2"]["perUser"] != hashes["delta1"]["perUser"]
    assert hashes["delta2"]["perItem"] == hashes["delta1"]["perItem"]
    assert port["totals"].tolist() == jax_side[f"{walk}/totals"].tolist()


def test_tiered_walk_equals_resident_bit_for_bit(registry_walks):
    res, tier = registry_walks["resident"], registry_walks["tiered"]
    for key, value in res.items():
        if key.startswith(("scores/", "hashes/", "pending/")):
            assert np.array_equal(tier[key], value), key
    assert dict(tier["totals"].tolist())["hot_hits"] > 0


def _flatten_paths(d, prefix=()):
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _flatten_paths(v, prefix + (k,))
    return out


def _series(prom: str) -> set:
    return set(re.findall(r"^photon_[a-zA-Z0-9_]+", prom, flags=re.M))


def _observe(m) -> None:
    m.observe_request(0.004, 3)
    m.observe_batch(rows=3, bucket_rows=4, num_requests=2, entity_hits=2,
                    entity_lookups=3, new_compiles=0, queue_wait_s=0.001,
                    score_s=0.002)
    m.observe_swap()
    m.observe_delta(rows=5, publish_s=0.01)
    m.observe_shed()


def test_snapshot_paths_three_ways_match_jax():
    """Every instrument has a JSON path, every path resolves, every
    instrument renders in the Prometheus text; the contract, the JSON
    keys and the series equal the JAX package's."""
    from photon_ml_tpu.serving.metrics import SNAPSHOT_PATHS as JAX_PATHS
    from photon_ml_tpu.serving.metrics import ServingMetrics as JaxMetrics
    assert SNAPSHOT_PATHS == JAX_PATHS
    m, j = ServingMetrics(), JaxMetrics()
    for x in (m, j):
        _observe(x)
    assert set(m.registry.names()) == set(SNAPSHOT_PATHS)
    snap = m.snapshot()
    paths = _flatten_paths(snap)
    for name, path in SNAPSHOT_PATHS.items():
        assert path in paths, (name, path)
    assert paths == _flatten_paths(j.snapshot())
    reg = m.registry.snapshot()
    series = _series(m.prometheus())
    clean = lambda n: "photon_" + re.sub(r"[^a-zA-Z0-9_]", "_", n)
    for name in reg["counters"]:
        assert clean(name) + "_total" in series, name
    for name in list(reg["gauges"]) + list(reg["histograms"]):
        assert clean(name) in series, name
    assert series == _series(j.prometheus())
    assert snap["requests"] == 1 and snap["batch_occupancy"] == 0.75


class _FakeResult:
    def __init__(self, scores):
        self.scores = scores


def test_microbatcher_coalesces_concurrent_requests():
    calls = []

    def score_fn(feats, ids, *, num_requests, queue_wait_s):
        calls.append(num_requests)
        return _FakeResult(np.asarray(feats["x"]).sum(axis=1))

    b = MicroBatcher(score_fn, BatcherConfig(max_wait_s=0.01, max_batch=256,
                                             max_queue=512))
    try:
        def one(i):
            n = 1 + i % 4
            out = b.score({"x": np.full((n, 2), float(i))}, {}, n)
            np.testing.assert_array_equal(out, np.full(n, 2.0 * i))
            return len(out)

        with ThreadPoolExecutor(max_workers=16) as pool:
            sizes = list(pool.map(one, range(80)))
        assert sum(sizes) == sum(1 + i % 4 for i in range(80))
        assert sum(calls) == 80 and len(calls) < 80
    finally:
        b.close()


def test_microbatcher_sheds_expires_and_isolates_errors():
    release = threading.Event()

    def slow_fn(feats, ids, *, num_requests, queue_wait_s):
        release.wait(5.0)
        if np.asarray(feats["x"]).sum() < 0:
            raise RuntimeError("scorer exploded")
        return _FakeResult(np.zeros(len(feats["x"])))

    b = MicroBatcher(slow_fn, BatcherConfig(max_wait_s=0.0, max_batch=4,
                                            max_queue=2))
    results = {}

    def bg(name, x=0.0, timeout=None):
        def run():
            try:
                results[name] = b.score({"x": np.full((1, 1), x)}, {}, 1,
                                        timeout=timeout)
            except Exception as e:
                results[name] = e
        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    try:
        t1 = bg("first")
        time.sleep(0.15)
        t2 = bg("expired", timeout=0.01)
        time.sleep(0.05)
        t3 = bg("ok")
        time.sleep(0.05)
        with pytest.raises(Overloaded):
            b.score({"x": np.zeros((1, 1))}, {}, 1)
        release.set()
        for t in (t1, t2, t3):
            t.join(timeout=10.0)
            assert not t.is_alive()
        assert isinstance(results["expired"], DeadlineExceeded)
        assert isinstance(results["first"], np.ndarray)
        assert isinstance(results["ok"], np.ndarray)
        with pytest.raises(RuntimeError, match="scorer exploded"):
            b.score({"x": -np.ones((1, 1))}, {}, 1)
        assert b.score({"x": np.ones((1, 1))}, {}, 1).shape == (1,)
    finally:
        release.set()
        b.close()


class _Recorder(EventListener):
    def __init__(self):
        self.events = []

    def handle(self, event):
        self.events.append(event)


def test_hot_swap_mid_burst_drops_nothing(tmp_path, warm_scorer):
    """A burst of single requests from 12 threads while the model swaps:
    every request answers with one model's score (bit for bit), none
    fails, and no bucket is seen for the first time after warmup."""
    dir_a, dir_b = tmp_path / "v1", tmp_path / "v2"
    save_game_model(model(), str(dir_a))
    save_game_model(model(0.5), str(dir_b))
    feats, ids = sj.requests()[7]                         # 17 rows
    want = {v: CompiledScorer(model(s), max_batch=sj.MAX_BATCH,
                              min_bucket=sj.MIN_BUCKET, device="cpu")
            for v, s in (("a", 1.0), ("b", 0.5))}
    rows = [({k: x[i:i + 1] for k, x in feats.items()},
             {k: c[i:i + 1] for k, c in ids.items()}) for i in range(17)]
    expect = {v: s.score(feats, ids).scores for v, s in want.items()}
    emitter, rec = EventEmitter(), _Recorder()
    emitter.register_listener(rec)
    cfg = ServingConfig(max_batch=sj.MAX_BATCH, min_bucket=sj.MIN_BUCKET,
                        device="cpu", dtype=torch.float64)
    with ScoringService(model_dir=str(dir_a), config=cfg,
                        emitter=emitter) as svc:
        failures, matched = [], []

        def one(k):
            f, i = rows[k % 17]
            try:
                s = svc.score(f, i)[0]
            except Exception as e:
                failures.append(e)
                return
            hit = [v for v, e in expect.items() if s == e[k % 17]]
            (matched if hit else failures).append(hit or s)

        t = threading.Thread(target=lambda: (time.sleep(0.01),
                                             svc.swap(str(dir_b))))
        t.start()
        with ThreadPoolExecutor(max_workers=12) as pool:
            list(pool.map(one, range(120)))
        t.join(timeout=60)
        assert not failures, failures[:5]
        assert len(matched) == 120
        assert "v2" in svc.model_version
        np.testing.assert_array_equal(svc.score(feats, ids), expect["b"])
        svc.rollback()
        np.testing.assert_array_equal(svc.score(feats, ids), expect["a"])
        snap = svc.metrics_snapshot()
    assert snap["bucket_compiles"] == 0 and snap["errors"] == 0
    assert snap["requests"] == 122
    swaps = [e.action for e in rec.events if isinstance(e, ModelSwapEvent)]
    assert swaps[-2:] == ["swap", "rollback"]


def _run_main(module, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main([str(a) for a in argv])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A saved model (npz and reference layouts; string ids) and a request
    dataset over its entities."""
    from photon_ml_tpu_torch.data.game_data import (build_game_dataset,
                                                    save_game_dataset)
    root = tmp_path_factory.mktemp("served")
    m = model(keep=("fixed", "perUser", "perUserLatent"))
    save_game_model(m, str(root / "model"))
    save_game_model_reference_layout(m, str(root / "reference"))
    rng = np.random.default_rng(4)
    n = 48
    users = np.asarray([f"u{rng.integers(sj.N_USERS)}" if rng.uniform() > 0.25
                        else "ghost" for _ in range(n)], dtype=object)
    ds = build_game_dataset(rng.normal(size=n),
                            {"global": rng.normal(size=(n, sj.D_G)),
                             "per_user": rng.normal(size=(n, sj.D_U))},
                            entity_ids={"userId": users})
    save_game_dataset(ds, str(root / "requests.npz"))
    return root, m


@pytest.mark.parametrize("layout", ["model", "reference"])
def test_cli_serve_burst_matches_cli_score(served, layout):
    from photon_ml_tpu_torch.cli import score as score_cli
    from photon_ml_tpu_torch.cli import serve as serve_cli
    root, _ = served
    out = root / f"burst_{layout}.npz"
    rc, result = _run_main(serve_cli, [
        "--model-dir", root / layout, "--burst", root / "requests.npz",
        "--request-rows", 3, "--threads", 6, "--max-batch", 32,
        "--min-bucket", 4, "--output", out, "--device", "cpu", "--x64"])
    assert rc == 0 and result["failed_requests"] == 0
    assert result["rows"] == 48 and result["requests"] == 16
    m = result["metrics"]
    assert m["requests"] == 16 and m["bucket_compiles"] == 0
    assert 0 < m["batch_occupancy"] <= 1 and 0 < m["entity_hit_rate"] < 1
    assert m["latency_ms"]["p99"] >= m["latency_ms"]["p50"] >= 0
    rc, _ = _run_main(score_cli, [
        "--model-dir", root / layout, "--data", root / "requests.npz",
        "--output", root / f"score_{layout}.npz", "--device", "cpu", "--x64"])
    assert rc == 0
    close(np.load(out)["scores"], np.load(root / f"score_{layout}.npz")["scores"])


def test_cli_serve_http_child_scores_swaps_and_drains(served):
    """cli.serve --device cpu as a child: /score and /predict equal an
    in-process scorer bit for bit, /metrics parses, /feedback answers 400
    (the child runs without --enable-updates),
    /swap to the reference layout of the same model scores the same bits,
    /rollback, and SIGTERM drains with exit 0 and the drained line."""
    root, m = served
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve",
         "--model-dir", str(root / "model"), "--port", "0", "--max-batch",
         "32", "--min-bucket", "4", "--device", "cpu", "--x64"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        startup = json.loads(proc.stdout.readline())
        base = startup["serving"]
        assert startup["buckets"] == [4, 8, 16, 32]
        assert startup["device"] == "cpu"

        def call(path, payload=None):
            data = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(base + path, data=data)
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, resp.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        assert json.loads(call("/healthz")[1])["status"] == "ok"
        feats, ids = sj.requests()[2]
        body = {"features": {k: feats[k].tolist() for k in ("global", "per_user")},
                "ids": {"userId": ids["userId"].tolist()}}
        expected = CompiledScorer(m, max_batch=32, min_bucket=4, device="cpu")
        want = expected.score({k: np.asarray(v) for k, v in body["features"].items()},
                              {"userId": ids["userId"]}).scores
        scores = json.loads(call("/score", body)[1])["scores"]
        assert scores == want.tolist()
        pred = json.loads(call("/predict", body)[1])["predictions"]
        assert pred == expected.mean_prediction(want).tolist()
        code, prom = call("/metrics")
        assert code == 200 and "photon_serving_requests_total 2" in prom
        for line in prom.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        code, text = call("/feedback", dict(body, labels=[1, 0, 1, 0]))
        assert code == 400 and "--enable-updates" in text
        version = json.loads(call("/swap", {"model_dir": str(root / "reference")})[1])
        assert "reference" in version["version"]
        assert json.loads(call("/score", body)[1])["scores"] == want.tolist()
        assert "model" in json.loads(call("/rollback", {})[1])["version"]
        audit = json.loads(call("/fleet/audit")[1])
        assert audit["table_hashes"] == expected.table_hashes()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        last = json.loads(out.strip().splitlines()[-1])
        assert last["drained"] is True and last["aborted"] is False
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# the health and fleet flags, each in a mode the JAX CLI refuses (the
# refusal and its message are the JAX CLI's); --health-config arms the
# monitor in a burst instead
FLEET_MODE_CHECKS = {
    "--replica": ["--replica"],
    "--publish": ["--publish", "--shard=0/2"],
    "--front": ["--front"],
    "--shard=0/2": ["--shard=0/2", "--enable-updates"],
    "--shard-count=2": ["--shard-count=2"],
}


@pytest.mark.parametrize("flag", ["--health-config={}",
                                  "--replica", "--publish", "--front",
                                  "--shard=0/2", "--shard-count=2"])
def test_cli_serve_unported_flags_exit_naming_item_22(served, flag):
    """The flags that exited before their slice was ported: they now
    behave as the JAX CLI's do."""
    from photon_ml_tpu.cli import serve as jax_serve_cli
    from photon_ml_tpu_torch.cli import serve as serve_cli
    root, _ = served
    if flag == "--health-config={}":
        rc, result = _run_main(serve_cli, [
            "--model-dir", root / "model", "--burst", root / "requests.npz",
            "--health-config", json.dumps({"baseline_scores": 16,
                                           "window_scores": 16}),
            "--request-rows", 4, "--device", "cpu", "--x64"])
        assert rc == 0 and result["failed_requests"] == 0
        assert result["metrics"]["health"]["score_windows"] >= 1
        assert result["metrics"]["health"]["baseline_ready"] == 1
        return
    argv = ["--model-dir", str(root / "model"), *FLEET_MODE_CHECKS[flag]]
    with pytest.raises(SystemExit) as jax_exit:
        jax_serve_cli.main(argv)
    with pytest.raises(SystemExit) as port_exit:
        serve_cli.main(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(jax_exit.value) != ""


@pytest.mark.parametrize("case", ["health"])
def test_unported_branches_raise_naming_item_22(case):
    """health= takes a health.HealthConfig and nothing else, as the JAX
    package's does."""
    cfg = ServingConfig(device="cpu", dtype=torch.float64)
    make = {
        "health": lambda: ScoringService(model=model(), config=cfg, health={}),
    }[case]
    with pytest.raises(TypeError, match="health.HealthConfig"):
        make()


def test_a_cuda_scorer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledScorer(model())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService(model=model())
