"""The port's multi-process runtime (parallel/multihost.py, the mesh's
collective wrapper, utils/durable.py's primary-process guard) and
cli.train's multi-rank runs, on the CPU with gloo.

In process: bring-up (idempotent, a mismatched re-init raises, a rank
that cannot reach its coordinator times out naming the address and its
process id), identity from the environment, the durable-write guard,
row ranges, the NCCL one-card check, the watchdog's sweeps, and the
collective wrapper's refusal of anything but all_reduce and broadcast.

Subprocesses, started together once per module (bench.py's
multihost_bench legs): two `cli.train --coordinator ... --dist-backend
gloo` ranks against `cli.train --mesh 2x1` (which starts its two ranks
itself), bit for bit; a pair whose rank 1 is SIGKILLed mid-run, whose
rank 0 must exit 75 with its JSON line, and relaunches that resume process
0's checkpoint and end as the same run uninterrupted ends (one rank within
1e-10; `--mesh 2x1`, the pair's mesh, bit for bit); `cli.train --mesh
2x1 --hbm-budget` streaming each rank's rows against the streamed fit in
this process and the pair, within 1e-10; and the two packages'
checkpoints across
each other: the JAX package's two-process pair (mesh_jax_side.py
multihost) resumed by one port rank, the port pair's resumed by one JAX
process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mesh_jax_side as mj
from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
from photon_ml_tpu_torch.parallel import make_mesh, multihost
from photon_ml_tpu_torch.parallel.mesh import Mesh
from photon_ml_tpu_torch.utils import durable, faults

ROOT = Path(__file__).resolve().parents[2]
HEARTBEAT = {"PHOTON_HEARTBEAT_INTERVAL": "0.2", "PHOTON_HEARTBEAT_TIMEOUT": "2",
             "PHOTON_HEARTBEAT_ESCALATE": "5"}
MH_KILL = 150     # outer iterations of the pair whose rank 1 is killed
# a per-device budget that streams the fixed effect on 2 x 1 (its resident
# block per device, 256 x 6 x 8 / 2 bytes, busts half of it)
MH_STREAM_BUDGET = 10_000


# -- in process ---------------------------------------------------------------

@pytest.fixture
def identity():
    """Leave the process's multihost identity as it was found."""
    multihost.shutdown()
    yield
    multihost.shutdown()


def test_initialize_is_idempotent_and_refuses_a_mismatch(identity):
    addr = f"127.0.0.1:{multihost.free_port()}"
    multihost.initialize(addr, 1, 0, device="cpu", timeout_s=30)
    assert multihost.group_started() and torch.distributed.is_initialized()
    multihost.initialize(addr, 1, 0, device="cpu", backend="gloo")  # no-op
    with pytest.raises(multihost.MultihostInitError, match="refusing re-init"):
        multihost.initialize(addr, 2, 1, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "feature": 1} and mesh.backend == "gloo"
    t = torch.arange(3.0)
    assert torch.equal(mesh.all_reduce(t, "data"), torch.arange(3.0))
    multihost.shutdown()
    assert not torch.distributed.is_initialized() and not multihost.group_started()


def test_initialize_multihost_returns_the_world_mesh(identity):
    from photon_ml_tpu_torch.parallel import initialize_multihost
    addr = f"127.0.0.1:{multihost.free_port()}"
    mesh = initialize_multihost(addr, 1, 0, device="cpu", timeout_s=30)
    assert mesh.shape == {"data": 1, "feature": 1} and mesh.backend == "gloo"
    assert mesh.ranks == (0,) and mesh.groups is not None
    again = initialize_multihost(addr, 1, 0, device="cpu")   # joins once
    assert again.shape == mesh.shape and multihost.process_count() == 1
    with pytest.raises(ValueError, match="does not tile"):
        initialize_multihost(addr, 1, 0, num_feature=2, device="cpu")


def test_unreachable_coordinator_times_out_naming_address_and_process(identity):
    addr = f"127.0.0.1:{multihost.free_port()}"
    t0 = time.time()
    with pytest.raises(multihost.MultihostInitError) as e:
        multihost.initialize(addr, 2, 1, device="cpu", timeout_s=1)
    assert addr in str(e.value) and "process 1/2" in str(e.value)
    assert time.time() - t0 < 30


@pytest.mark.parametrize("case", ["no_coordinator", "process_out_of_range",
                                  "nccl_on_cpu", "bad_address"])
def test_bringup_errors(identity, case):
    kw = {"no_coordinator": dict(num_processes=2, process_id=0),
          "process_out_of_range": dict(coordinator_address="127.0.0.1:1",
                                       num_processes=2, process_id=2),
          "nccl_on_cpu": dict(coordinator_address="127.0.0.1:1",
                              num_processes=2, process_id=0, backend="nccl"),
          "bad_address": dict(coordinator_address="nohost", num_processes=2,
                              process_id=0)}[case]
    match = {"no_coordinator": "requires a coordinator",
             "process_out_of_range": "out of range",
             "nccl_on_cpu": "NCCL|nccl",
             "bad_address": "HOST:PORT"}[case]
    with pytest.raises(multihost.MultihostInitError, match=match):
        multihost.initialize(device="cpu", timeout_s=1, **kw)


def test_identity_from_environment_and_the_durable_guard(identity, monkeypatch, tmp_path):
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "3")
    monkeypatch.setenv(multihost.ENV_PROCESS_ID, "2")
    assert (multihost.process_count(), multihost.process_index()) == (3, 2)
    assert multihost.active() and not multihost.is_primary()
    # a non-primary process writes nothing durable unless asked to
    durable.atomic_write_json(str(tmp_path / "state.json"), {"a": 1})
    durable.write_marker(str(tmp_path / "_SUCCESS"))
    assert not list(tmp_path.iterdir())
    durable.atomic_write_json(str(tmp_path / "beat.json"), {"a": 1}, all_process=True)
    assert json.loads((tmp_path / "beat.json").read_text()) == {"a": 1}
    # the JAX package's guard agrees on the same environment
    from photon_ml_tpu.parallel import multihost as jmh
    assert (jmh.process_count(), jmh.process_index()) == (3, 2)


@pytest.mark.parametrize("n", [0, 1, 7, 10, 1000])
def test_process_row_ranges_match_jax(n):
    from photon_ml_tpu.parallel import multihost as jmh
    for p in (1, 2, 3, 4):
        got = [multihost.process_row_range(n, count=p, index=i) for i in range(p)]
        assert got == [jmh.process_row_range(n, count=p, index=i) for i in range(p)]
        assert sum(len(r) for r in got) == n


def test_nccl_card_check():
    assert multihost.duplicate_cards(["h/a", "h/b", "g/a"]) is None
    assert multihost.duplicate_cards(["h/a", "h/b", "h/a"]) == (0, 2, "h/a")


@pytest.mark.parametrize("cards", [("h/0", "h/0"), ("h/0", "h/1")], ids=["one", "two"])
def test_nccl_card_check_through_the_store(monkeypatch, cards):
    """Both ranks publish their card through the coordinator's store and
    read the other's before either decides: on one card both refuse
    (process 0 stays until rank 1 has read), on two both go on."""
    import datetime
    import threading
    monkeypatch.setattr(multihost, "_card_id", lambda device: cards[device])
    port = multihost.free_port()
    timeout = datetime.timedelta(seconds=20)
    stores = [torch.distributed.TCPStore("127.0.0.1", port, 2, r == 0, timeout=timeout,
                                         wait_for_workers=False) for r in (0, 1)]
    outcome = {}

    def rank(r):
        try:
            multihost._check_distinct_cards(stores[r], r, 2, r, 20.0)
            outcome[r] = "ok"
        except multihost.MultihostInitError as e:
            outcome[r] = str(e)
    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    if cards[0] == cards[1]:
        assert all("NCCL cannot run two ranks on one card" in outcome[r] for r in (0, 1))
    else:
        assert outcome == {0: "ok", 1: "ok"}


def test_collective_wrapper_takes_only_all_reduce_and_broadcast():
    mesh = make_mesh(1, 1, device="cpu")
    t = torch.ones(4)
    mesh.broadcast(t)
    mesh.all_reduce(t, "feature")
    for op in ("all_gather", "reduce_scatter", "all_to_all", "reduce"):
        with pytest.raises(ValueError, match="refused"):
            mesh.collective(op, t, "data")
    with pytest.raises(ValueError, match="axis"):
        mesh.all_reduce(t, "rows")
    assert mesh.stats.snapshot() == {
        "broadcast.world.calls": 1, "broadcast.world.elements": 4,
        "all_reduce.feature.calls": 1, "all_reduce.feature.elements": 4}


def test_mesh_shapes_and_blocks():
    with pytest.raises(ValueError, match="does not tile"):
        make_mesh(2, 1, device="cpu")
    m = Mesh(num_data=3, num_feature=2, rank=5, device=torch.device("cpu"))
    assert (m.data_index, m.feature_index) == (2, 1)
    assert m.block(10) == (8, 12, 12) and m.block(5, "feature") == (3, 6, 6)
    assert m.assemble(torch.ones(4), 10).tolist() == [0.0] * 8 + [1.0] * 2


def test_coordinate_residency_keys_are_never_reused():
    """A coordinate's staged mesh blocks outlive it in the residency
    registry, keyed by its residency key: a later coordinate must never
    take that key (an id() is reused once its object is freed, on some
    ranks and not on others; those ranks would find the earlier blocks,
    the ADMM lane's Gram eigendecomposition among them, and skip the
    collectives the other ranks make)."""
    from photon_ml_tpu_torch.game.config import (
        FixedEffectCoordinateConfig, RandomEffectCoordinateConfig)
    from photon_ml_tpu_torch.game.coordinates import (
        FixedEffectCoordinate, RandomEffectCoordinate)
    rng = np.random.default_rng(0)
    ds = build_game_dataset(rng.uniform(size=64).round(), {"g": rng.normal(size=(64, 3))},
                            entity_ids={"u": np.arange(64) % 4})
    seen = set()
    for _ in range(8):
        for kind, cfg in ((FixedEffectCoordinate, FixedEffectCoordinateConfig("g")),
                          (RandomEffectCoordinate, RandomEffectCoordinateConfig("u", "g"))):
            key = kind("c", ds, cfg, "logistic_regression", device="cpu")._mesh_key()
            assert key not in seen
            seen.add(key)


def test_pad_and_shard_rows_stages_the_design_once():
    from photon_ml_tpu_torch.parallel.mesh import concat_rows_safe, pad_and_shard_rows
    from photon_ml_tpu_torch.parallel.mesh_residency import MeshResidency
    m = Mesh(num_data=3, num_feature=1, rank=2, device=torch.device("cpu"))
    res = MeshResidency()
    x, o = np.arange(20.0).reshape(10, 2), np.arange(10.0)
    for visit in (1, 2):
        n, (xb, ob) = pad_and_shard_rows(m, x, o, residency_key=("t",),
                                         dtype=torch.float64, residency=res)
        assert n == 10 and xb.tolist() == [[16, 17], [18, 19], [0, 0], [0, 0]]
        assert ob.tolist() == [8, 9, 0, 0]
        snap = res.stats.snapshot()
        assert (snap["cold_stages"], snap["warm_stages"]) == (1, visit)
    parts = [torch.arange(3.0), torch.arange(2.0)]
    assert concat_rows_safe(m, parts).tolist() == [0, 1, 2, 0, 1]
    one = concat_rows_safe(m, parts[:1])
    assert torch.equal(one, parts[0]) and one.data_ptr() != parts[0].data_ptr()


def test_watchdog_sweeps_and_confirms_a_silent_peer(tmp_path):
    wd = multihost.WorkerWatchdog(str(tmp_path), num_processes=3, process_id=0,
                                  timeout_s=1.0)
    wd._started_at = time.time()
    os.makedirs(wd.directory)
    now = time.time()
    for pid, beat in ((1, {"time": now, "done": False}),
                      (2, {"time": now - 5.0, "done": False})):
        (Path(wd.directory) / f"proc-{pid}.json").write_text(json.dumps(beat))
    lost = wd.check_peers(now)
    assert isinstance(lost, multihost.WorkerLost) and lost.process_id == 2
    for pid in (1, 2):  # a peer that finished is never lost
        (Path(wd.directory) / f"proc-{pid}.json").write_text(
            json.dumps({"time": 0, "done": True}))
    assert wd.check_peers(now) is None
    (Path(wd.directory) / "proc-2.json").unlink()  # never beat again
    assert wd.confirm_lost(wait_s=3.0) == 2


def test_watchdog_escalates_a_wedged_process_to_exit_75(tmp_path):
    """A peer that never beats: the watchdog requests preemption, and a
    main thread that never reaches a boundary (blocked as in a dead
    collective) is hard-exited with the resumable status."""
    code = (
        "import time\n"
        "from photon_ml_tpu_torch.parallel import multihost\n"
        f"multihost.WorkerWatchdog({str(tmp_path)!r}, num_processes=2, process_id=0,"
        " interval_s=0.1, timeout_s=0.5, escalate_s=0.5).start()\n"
        "time.sleep(30)\n")
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=60,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == faults.EXIT_PREEMPTED == 75
    assert time.time() - t0 < 20


# -- the command line, as subprocesses ----------------------------------------

def _env():
    env = multihost.child_env(dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                                   **HEARTBEAT))
    env.pop("PHOTON_FAULT_PLAN", None)
    return env


def _train(root, config, out, *extra, stdout=None):
    cmd = [sys.executable, "-m", "photon_ml_tpu_torch.cli.train",
           "--train-data", str(root / "data.npz"), "--config", str(config),
           "--device", "cpu", "--x64", "--checkpoint-dir", str(out / "ckpt"),
           "--output-dir", str(out), *extra]
    out.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(), stderr=subprocess.DEVNULL,
                            stdout=open(stdout or out / "stdout.txt", "w"))


def _pair(root, config, out, extra=()):
    port = multihost.free_port()
    return [_train(root, config, out, "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(pid),
                   "--dist-backend", "gloo", *extra,
                   stdout=out / f"stdout{pid}.txt") for pid in (0, 1)]


def _wait(procs, timeout=240):
    return [p.wait(timeout=timeout) for p in procs]


def _last_json(path):
    return json.loads(Path(path).read_text().strip().splitlines()[-1])


def _model_bytes(out):
    best = out / "best"
    return {str(p.relative_to(best)): p.read_bytes() for p in sorted(best.rglob("*"))
            if p.is_file() and p.name != "model-metadata.json"}


def _state(out):
    return json.loads((out / "ckpt" / "state.json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    data, config = mj.mh_write_inputs(root, build_game_dataset, save_game_dataset)
    _, short = mj.mh_write_inputs(root, build_game_dataset, save_game_dataset, mj.MH_SHORT)
    _, kill_cfg = mj.mh_write_inputs(root, build_game_dataset, save_game_dataset, MH_KILL)
    r = {"root": root}
    short_pair = _pair(root, short, root / "port_pair")
    pair = _pair(root, config, root / "pair")
    spawn = [_train(root, config, root / "spawn", "--mesh", "2x1", "--dist-backend", "gloo")]
    stream = [_train(root, config, root / "stream", "--mesh", "2x1", "--dist-backend", "gloo",
                     "--hbm-budget", str(MH_STREAM_BUDGET))]
    kill = _pair(root, kill_cfg, root / "kill")
    fresh = [_train(root, config, root / "fresh")]
    # the killed run uninterrupted, on the pair's mesh
    kill_ref = [_train(root, kill_cfg, root / "kill_mesh", "--mesh", "2x1",
                       "--dist-backend", "gloo")]
    r["short_codes"] = _wait(short_pair)
    jax_procs = mj.run_jax_side("multihost", root)
    # rank 1 dies once process 0 has sealed a record
    state = root / "kill" / "ckpt" / "state.json"
    deadline = time.time() + 120
    while not state.exists() and time.time() < deadline and kill[0].poll() is None:
        time.sleep(0.05)
    os.kill(kill[1].pid, signal.SIGKILL)
    t_kill = time.time()
    r["survivor_code"] = kill[0].wait(timeout=120)
    r["survivor_s"] = time.time() - t_kill
    kill[1].wait()
    shutil.copytree(root / "kill", root / "kill_copy")
    relaunch = [_train(root, kill_cfg, root / "kill"),
                _train(root, kill_cfg, root / "kill_copy", "--mesh", "2x1",
                       "--dist-backend", "gloo")]
    r["pair_codes"], r["spawn_codes"] = _wait(pair), _wait(spawn)
    r["stream_codes"] = _wait(stream)
    r["fresh_codes"], r["relaunch_codes"] = _wait(fresh), _wait(relaunch)
    r["kill_ref_codes"] = _wait(kill_ref)
    r["jax"] = mj.read_results(jax_procs, "multihost", root)
    if r["jax"]["jax_pair_codes"] == [0, 0]:
        shutil.copytree(root / "jax_pair", root / "from_jax")
        r["from_jax_codes"] = _wait([_train(root, config, root / "from_jax")])
    return r


def test_coordinator_pair_equals_spawned_mesh_bit_for_bit(runs):
    root = runs["root"]
    assert runs["pair_codes"] == [0, 0] and runs["spawn_codes"] == [0]
    assert _state(root / "pair")["objective_history"] == \
        _state(root / "spawn")["objective_history"]
    assert _model_bytes(root / "pair") == _model_bytes(root / "spawn")
    # rank 0 owns the outputs; both ranks report the same fit
    s0, s1 = (_last_json(root / "pair" / f"stdout{p}.txt") for p in (0, 1))
    assert s0["objective_history"] == s1["objective_history"]
    assert s0["multihost"] == {"num_processes": 2, "process_id": 0}
    assert s0["mesh"] == {"data": 2, "feature": 1}


def test_each_rank_stages_its_own_rows(runs):
    root = runs["root"]
    s = [_last_json(root / "pair" / f"stdout{p}.txt")["mesh_transfer"] for p in (0, 1)]
    cold = [t["cold_bytes"] for t in s]
    assert min(cold) > 0 and max(cold) / min(cold) <= 1.5
    # per outer iteration: offsets of the rank's rows and the coefficients
    warm_bound = 8 * (mj.MH_N // 2 + mj.MH_D) * 8
    assert all(t["warm_bytes"] / mj.MH_OUTER <= warm_bound for t in s)


def test_mesh_streamed_cli_matches_the_streamed_fit(runs):
    """`--mesh 2x1 --hbm-budget` streams each rank's row block of the fixed
    effect (the chunk plan built with row multiple 2): the same fit as the
    streamed fit in this process (one rank, no mesh) and as the resident
    pair, within 1e-10; process 0 writes the model, and its summary's
    stream counters are its own rows'."""
    from photon_ml_tpu_torch.data.game_data import load_game_dataset
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    root = runs["root"]
    assert runs["stream_codes"] == [0]
    line = _last_json(root / "stream" / "stdout.txt")
    rank1 = _last_json(root / "stream" / "training.proc1.out")
    config = GameTrainingConfig.from_json((root / f"game-{mj.MH_OUTER}.json").read_text())
    config = dataclasses.replace(config, hbm_budget_bytes=MH_STREAM_BUDGET)
    here = GameEstimator(config, device="cpu", dtype=torch.float64).fit(
        load_game_dataset(str(root / "data.npz")))
    np.testing.assert_allclose(line["objective_history"], here.objective_history,
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(line["objective_history"],
                               _state(root / "pair")["objective_history"], rtol=1e-10, atol=0)
    assert rank1["objective_history"] == line["objective_history"]
    assert (root / "stream" / "best").is_dir()
    assert line["mesh"] == {"data": 2, "feature": 1}
    for summary in (line, rank1):
        acct = summary["hbm_residency"]
        assert acct["per_device"] is True and acct["data_devices"] == 2
        assert acct["streamed_chunk_bytes"] == {"fixed": 2 * 256 * (mj.MH_D + 4) * 8 // 2}
        assert summary["kernel_launches"]["fused"] == 0   # the CPU runs the plain version
    # each process staged its own 128 of every chunk's 256 rows
    stream = line["hbm_residency"]["stream"]["fixed"]
    assert stream["examples_processed"] == 128 * stream["passes"]
    assert here.residency["stream"]["fixed"]["examples_processed"] == (
        256 * here.residency["stream"]["fixed"]["passes"])


def test_pair_matches_one_rank(runs):
    root = runs["root"]
    assert runs["fresh_codes"] == [0]
    np.testing.assert_allclose(_state(root / "pair")["objective_history"],
                               _state(root / "fresh")["objective_history"],
                               rtol=1e-10, atol=0)


def test_killed_rank_survivor_exits_75_then_one_rank_resumes(runs):
    root = runs["root"]
    assert runs["survivor_code"] == faults.EXIT_PREEMPTED
    line = _last_json(root / "kill" / "stdout0.txt")
    assert line["preempted"] and line["exit_status"] == 75 and line["lost_worker"] == 1
    # within the watchdog's timeout plus its confirmation slack
    assert runs["survivor_s"] < float(HEARTBEAT["PHOTON_HEARTBEAT_TIMEOUT"]) + 10
    assert runs["relaunch_codes"] == [0, 0] and runs["kill_ref_codes"] == [0]
    uninterrupted = _state(root / "kill_mesh")["objective_history"]
    # one rank resumes process 0's record and ends where the run ends
    # uninterrupted (up to the order of the two ranks' sums)
    resumed = _last_json(root / "kill" / "stdout.txt")
    assert resumed["checkpoint_recovery"]["resumed_from_iteration"] is not None
    np.testing.assert_allclose(resumed["objective_history"], uninterrupted,
                               rtol=1e-10, atol=0)
    # on the pair's mesh the resume is the uninterrupted run bit for bit
    on_mesh = _last_json(root / "kill_copy" / "stdout.txt")
    assert on_mesh["checkpoint_recovery"]["resumed_from_iteration"] is not None
    assert on_mesh["objective_history"] == uninterrupted
    assert _model_bytes(root / "kill_copy") == _model_bytes(root / "kill_mesh")


def test_jax_pair_checkpoint_resumes_in_one_port_rank(runs):
    root, jax = runs["root"], runs["jax"]
    assert jax["jax_pair_codes"] == [0, 0] and runs["from_jax_codes"] == [0]
    state = _state(root / "from_jax")
    assert state["completed_iterations"] == mj.MH_OUTER
    hist = state["objective_history"]
    np.testing.assert_allclose(hist[:mj.MH_SHORT],
                               jax["jax_pair_state"]["objective_history"], rtol=1e-10)
    np.testing.assert_allclose(hist, _state(root / "fresh")["objective_history"],
                               rtol=1e-10, atol=0)


def test_port_pair_checkpoint_resumes_in_jax(runs):
    root, jax = runs["root"], runs["jax"]
    assert runs["short_codes"] == [0, 0] and jax["jax_resume_code"] == 0, \
        jax["jax_resume_state"]
    hist = jax["jax_resume_state"]["objective_history"]
    assert jax["jax_resume_state"]["completed_iterations"] == mj.MH_OUTER
    np.testing.assert_allclose(hist, _state(root / "pair")["objective_history"],
                               rtol=1e-10, atol=0)
