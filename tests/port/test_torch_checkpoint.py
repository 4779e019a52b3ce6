"""Port checkpoints: crash-safe records, verified fallback, pruning, resume
and graceful preemption, as the JAX package's tests/test_faults.py and
tests/test_inexact.py hold them.

Float64 on the CPU at tests/test_faults.py's GLMix shape (900 rows, 30
users, d = 8 and 4, LBFGS(15), L2 lambda 1).  Checked: every iter-*
directory carries a verifying manifest and a self-contained record.json;
a corrupt newest record falls back to the retained one and is pruned;
stale *.tmp files and unverified orphan directories are pruned; the
fallback refuses another configuration's fingerprint; a failed fit-end
record surfaces with its cause; a preemption leaves a durable record whose
resume reproduces the uninterrupted history (atol 1e-9), as does a
scheduled fit interrupted mid-schedule; a resumed factored fit is not
warm-started again; fit_grid checkpoints per combo; and a child process
killed with SIGKILL at `checkpoint.fsync` (cli.train, `--device cpu
--x64`) leaves state.json.tmp, which the resume prunes before it lands on
the uninterrupted history."""
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig, GLMOptimizationConfig
from photon_ml_tpu_torch.game.coordinate_descent import (
    AsyncCheckpointer, read_checkpoint, run_coordinate_descent, verify_checkpoint_dir,
)
from photon_ml_tpu_torch.optim.config import OptimizerConfig
from photon_ml_tpu_torch.optim.schedule import SolverSchedule
from photon_ml_tpu_torch.utils import durable, faults

ROOT = Path(__file__).resolve().parents[2]
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.install_plan(None)
    faults.clear_preemption()
    yield
    faults.install_plan(None)
    faults.clear_preemption()


@pytest.fixture(scope="module")
def data():
    return side.containment_glmix(build_game_dataset)


def _estimator(outer=3, coords=("fixed", "perUser"), schedule=None, factored=False):
    d = side.containment_config_dict(outer, schedule, factored)
    if coords == ("fixed",):
        d["coordinates"] = {"fixed": d["coordinates"]["fixed"]}
        d["updating_sequence"] = ["fixed"]
    return GameEstimator(GameTrainingConfig.from_dict(d), **F64)


def test_checkpoint_dirs_carry_verifying_manifests(data, tmp_path):
    train, val = data
    ckpt = str(tmp_path / "ckpt")
    _estimator(2).fit(train, val, ["AUC"], checkpoint_dir=ckpt)
    iter_dirs = sorted(p for p in os.listdir(ckpt) if p.startswith("iter-"))
    assert iter_dirs == ["iter-0000", "iter-0001"]
    assert any(p.startswith("best-") for p in os.listdir(ckpt))
    for d in iter_dirs:
        ok, reason = verify_checkpoint_dir(os.path.join(ckpt, d))
        assert ok is True, reason
        record = json.load(open(os.path.join(ckpt, d, "record.json")))
        assert record["model_dir"] == d  # self-contained, relative
    state = json.load(open(os.path.join(ckpt, "state.json")))
    assert state["completed_iterations"] == 2
    assert state["previous"]["completed_iterations"] == 1
    assert state["config_fingerprint"] == _estimator(2)._config_fingerprint(["AUC"])
    # a tampered file no longer verifies; a directory without a manifest
    # is "unknown"
    npz = glob.glob(os.path.join(ckpt, "iter-0001", "**", "*.npz"), recursive=True)[0]
    with open(npz, "ab") as f:
        f.write(b"x")
    assert verify_checkpoint_dir(os.path.join(ckpt, "iter-0001"))[0] is False
    os.makedirs(tmp_path / "bare")
    assert verify_checkpoint_dir(str(tmp_path / "bare")) == (None, "no manifest")


def test_corrupt_primary_falls_back_to_verified_record(data, tmp_path):
    train, _ = data
    ckpt = str(tmp_path / "ckpt")
    _estimator(3, ("fixed",)).fit(train, checkpoint_dir=ckpt)
    newest = sorted(glob.glob(os.path.join(ckpt, "iter-*")))[-1]
    npz = glob.glob(os.path.join(newest, "**", "*.npz"), recursive=True)[0]
    with open(npz, "wb") as f:
        f.write(b"torn write")
    state = read_checkpoint(ckpt, device="cpu", dtype=torch.float64)
    assert state is not None and state.recovery["fallback"] is True
    # the retained record: iteration 1's, or iteration 0's when the
    # background writer coalesced iteration 1's snapshot away
    assert state.completed_iterations in (1, 2)
    assert not os.path.exists(newest)  # the corrupt record was pruned
    resumed = _estimator(3, ("fixed",)).fit(train, checkpoint_dir=ckpt)
    straight = _estimator(3, ("fixed",)).fit(train)
    np.testing.assert_allclose(resumed.objective_history, straight.objective_history,
                               rtol=0, atol=1e-9)


def test_stale_tmp_and_orphan_partials_pruned(data, tmp_path):
    train, _ = data
    ckpt = tmp_path / "ckpt"
    _estimator(2, ("fixed",)).fit(train, checkpoint_dir=str(ckpt))
    (ckpt / "state.json.tmp").write_text("partial")
    orphan = ckpt / "iter-0099"
    orphan.mkdir()
    (orphan / "half.npz").write_bytes(b"partial write")
    state = read_checkpoint(str(ckpt), device="cpu", dtype=torch.float64)
    assert state is not None and state.recovery["fallback"] is False
    assert not (ckpt / "state.json.tmp").exists() and not orphan.exists()
    assert sorted(os.path.basename(p) for p in state.recovery["pruned"]) == \
        ["iter-0099", "state.json.tmp"]


def test_fallback_record_respects_fingerprint(data, tmp_path):
    train, _ = data
    ckpt = str(tmp_path / "ckpt")
    est = _estimator(2, ("fixed",))
    est.fit(train, checkpoint_dir=ckpt)
    os.remove(os.path.join(ckpt, "state.json"))  # force the fallback path
    assert read_checkpoint(ckpt, fingerprint="different", device="cpu") is None
    good = read_checkpoint(ckpt, fingerprint=est._config_fingerprint(None), device="cpu",
                           dtype=torch.float64)
    assert good is not None and good.recovery["fallback"] is True
    assert good.completed_iterations == 2
    # a fit under another configuration starts fresh instead of resuming
    other = GameEstimator(GameTrainingConfig.from_dict(
        dict(side.containment_config_dict(2), seed=99)), **F64)
    assert other._config_fingerprint(None) != est._config_fingerprint(None)


@pytest.mark.parametrize("mode", ["pipelined", "strict"])
def test_failed_fit_end_record_surfaces(data, tmp_path, mode):
    train, _ = data
    plan = faults.FaultPlan([{"site": "model.save", "action": "fatal", "hits": [1]}])
    with faults.injected(plan):
        if mode == "pipelined":
            with pytest.raises(RuntimeError, match="final fit-end record") as err:
                _estimator(1).fit(train, checkpoint_dir=str(tmp_path / "ckpt"),
                                  timing_mode=mode)
            assert isinstance(err.value.__cause__, faults.FatalFault)
        else:
            with pytest.raises(faults.FatalFault):
                _estimator(1).fit(train, checkpoint_dir=str(tmp_path / "ckpt"),
                                  timing_mode=mode)


def test_async_checkpointer_coalesces_and_drains(tmp_path, monkeypatch):
    """Submissions superseded before their write starts are dropped; the
    last one always lands; submit after shutdown raises."""
    import threading
    import time

    from photon_ml_tpu_torch.game import coordinate_descent as cd
    from photon_ml_tpu_torch.models.game import GameModel
    train, _ = side.containment_glmix(build_game_dataset)
    model = GameModel({"fixed": _estimator(1).fit(train).model.coordinates["fixed"]},
                      "logistic_regression")
    written, started = [], threading.Event()
    real_write = cd._write_checkpoint

    def slow_write(directory, iteration, *rest):
        started.set()
        if not written:
            time.sleep(0.2)  # later submissions land while this one writes
        written.append(iteration)
        real_write(directory, iteration, *rest)

    monkeypatch.setattr(cd, "_write_checkpoint", slow_write)
    cp = AsyncCheckpointer(str(tmp_path))
    cp.submit(0, model, [1.0], {}, model, None, None)
    started.wait(5)
    for it in range(1, 5):
        cp.submit(it, model, [1.0] * (it + 1), {}, model, None, None)
    cp.shutdown()
    assert written == [0, 4]
    state = json.load(open(tmp_path / "state.json"))
    assert state["completed_iterations"] == 5
    with pytest.raises(RuntimeError, match="already shut down"):
        cp.submit(5, model, [], {}, model, None, None)
    cp.shutdown()  # idempotent


@pytest.mark.parametrize("mode", ["pipelined", "strict"])
def test_best_record_holds_the_best_model(data, tmp_path, mode):
    """The fit-end record's best model is the fit's best model, coefficient
    for coefficient, and its metric the best of the validation history."""
    from photon_ml_tpu_torch.game import quarantine
    train, val = data
    ckpt = str(tmp_path / "ckpt")
    fit = _estimator(4).fit(train, val, ["AUC"], checkpoint_dir=ckpt, timing_mode=mode)
    state = read_checkpoint(ckpt, device="cpu", dtype=torch.float64)
    assert state.completed_iterations == 4
    assert state.best_metric == max(fit.descent.validation_history["AUC"])
    best = fit.descent.best_model.coordinates
    assert sorted(state.best_models) == sorted(best)
    for name, model in best.items():
        for a, b in zip(quarantine.coefficient_arrays(state.best_models[name]),
                        quarantine.coefficient_arrays(model)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["pipelined", "strict"])
def test_preemption_writes_durable_checkpoint_and_resumes(data, tmp_path, mode):
    train, val = data
    straight = _estimator(3, ("fixed",)).fit(train, val, ["AUC"], timing_mode=mode)
    ckpt = str(tmp_path / "ckpt")
    faults.request_preemption()
    with pytest.raises(faults.Preempted) as err:
        _estimator(3, ("fixed",)).fit(train, val, ["AUC"], checkpoint_dir=ckpt,
                                      timing_mode=mode)
    assert err.value.completed_iterations == 1 and err.value.checkpointed is True
    faults.clear_preemption()
    state = read_checkpoint(ckpt, device="cpu", dtype=torch.float64)
    assert state is not None and state.completed_iterations == 1
    resumed = _estimator(3, ("fixed",)).fit(train, val, ["AUC"], checkpoint_dir=ckpt,
                                            timing_mode=mode)
    assert resumed.checkpoint_recovery["resumed_from_iteration"] == 0
    np.testing.assert_allclose(resumed.objective_history, straight.objective_history,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(resumed.descent.validation_history["AUC"],
                               straight.descent.validation_history["AUC"], rtol=0, atol=1e-12)


def test_preemption_mid_iteration_finishes_inflight_update(data):
    train, _ = data
    faults.request_preemption()
    with pytest.raises(faults.Preempted) as err:
        _estimator(3).fit(train)
    assert err.value.completed_iterations == 0 and err.value.checkpointed is False


def test_scheduled_resume_reproduces_trajectory(data, tmp_path):
    """A scheduled fit interrupted after outer iteration 0's checkpoint and
    resumed reproduces the uninterrupted trajectory: budgets depend only on
    (outer iteration, total)."""
    train, _ = data
    est = _estimator(3, schedule={"initial_iterations": 3})
    cfg = est.config
    coords = est._build_coordinates(train)
    schedules = {n: cfg.solver_schedule for n in cfg.updating_sequence}
    assert isinstance(cfg.solver_schedule, SolverSchedule)
    run = lambda c, **kw: run_coordinate_descent(
        c, cfg.updating_sequence, 3, train, cfg.task_type, solver_schedules=schedules,
        device="cpu", dtype=torch.float64, **kw)
    straight = run(coords)

    class _Interrupt(Exception):
        pass

    class _Bomb:
        def __init__(self, inner, at):
            self._inner, self._at = inner, at

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def update(self, model, offsets, **kw):
            if kw.get("outer_iteration") == self._at:
                raise _Interrupt()
            return self._inner.update(model, offsets, **kw)

    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(_Interrupt):
        run({n: _Bomb(c, 1) for n, c in coords.items()}, checkpoint_dir=ckpt)
    state = read_checkpoint(ckpt, device="cpu", dtype=torch.float64)
    assert state is not None and state.completed_iterations == 1
    resumed = run(coords, checkpoint_dir=ckpt, resume=state)
    np.testing.assert_allclose(resumed.objective_history, straight.objective_history,
                               rtol=0, atol=1e-9)
    caps = lambda r: [t.iteration_cap for k, t in sorted(r.trackers.items())
                      if k.endswith("/fixed")]
    assert caps(resumed) == caps(straight)[1:] == [6, 15]


def test_resumed_factored_fit_is_not_warm_started_again(data, tmp_path):
    train, _ = data
    straight = _estimator(3, factored=True).fit(train)
    assert straight.descent.warm_starts == {"perUserMF": "perUser"}
    ckpt = str(tmp_path / "ckpt")
    first = _estimator(1, factored=True).fit(train, checkpoint_dir=ckpt)
    assert first.descent.warm_starts == {"perUserMF": "perUser"}
    resumed = _estimator(3, factored=True).fit(train, checkpoint_dir=ckpt)
    assert resumed.descent.warm_starts == {}
    np.testing.assert_allclose(resumed.objective_history, straight.objective_history,
                               rtol=0, atol=1e-9)


def test_fit_grid_checkpoints_each_combo(data, tmp_path):
    train, val = data
    est = _estimator(2, ("fixed",))
    grid = {"fixed": [GLMOptimizationConfig(optimizer=OptimizerConfig(max_iterations=15),
                                            regularization=est.config.coordinates["fixed"]
                                            .optimization.regularization,
                                            regularization_weight=w) for w in (10.0, 1.0)]}
    ckpt = tmp_path / "ckpt"
    first = est.fit_grid(train, grid, val, ["AUC"], checkpoint_dir=str(ckpt))
    assert sorted(os.listdir(ckpt)) == ["combo-000", "combo-001"]
    again = est.fit_grid(train, grid, val, ["AUC"], checkpoint_dir=str(ckpt))
    for a, b in zip(first, again):
        assert b.checkpoint_recovery["resumed_from_iteration"] == 1
        assert a.objective_history == b.objective_history


def test_durable_helpers(tmp_path):
    p = tmp_path / "f.bin"
    durable.atomic_write_bytes(str(p), b"abc")
    assert p.read_bytes() == b"abc" and not (tmp_path / "f.bin.tmp").exists()
    durable.append_text(str(tmp_path / "log.txt"), "a\n")
    durable.append_text(str(tmp_path / "log.txt"), "b\n")
    assert (tmp_path / "log.txt").read_text() == "a\nb\n"
    seen = []
    durable.atomic_write_json(str(tmp_path / "s.json"), {"k": 1},
                              before_replace=lambda: seen.append(
                                  (tmp_path / "s.json.tmp").exists()))
    assert seen == [True] and json.loads((tmp_path / "s.json").read_text()) == {"k": 1}
    durable.write_manifest(str(tmp_path))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert set(manifest["files"]) == {"f.bin", "log.txt", "s.json"}
    assert manifest["files"]["f.bin"] == {"bytes": 3, "sha256": durable.file_sha256(str(p))}
    assert verify_checkpoint_dir(str(tmp_path)) == (True, "ok")


# -- a child process killed during a checkpoint write ------------------------

def _run_child(root, out, ckpt=None, plan=None, expect_kill=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("PHOTON_FAULT_PLAN", None)
    if plan is not None:
        env["PHOTON_FAULT_PLAN"] = json.dumps(plan)
    cmd = [sys.executable, "-m", "photon_ml_tpu_torch.cli.train",
           "--train-data", str(root / "train.npz"), "--config", str(root / "config.json"),
           "--output-dir", str(out), "--device", "cpu", "--x64", "--timing-mode", "strict"]
    if ckpt:
        cmd += ["--checkpoint-dir", str(ckpt)]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    if expect_kill:
        assert p.returncode not in (0, 1), (p.returncode, p.stderr[-500:])
        return p.returncode
    assert p.returncode == 0, p.stderr[-800:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sigkill_during_checkpoint_then_resume_reproduces_f64(data, tmp_path):
    train, _ = data
    save_game_dataset(train, str(tmp_path / "train.npz"))
    (tmp_path / "config.json").write_text(json.dumps(side.containment_config_dict(3)))
    ref = _run_child(tmp_path, tmp_path / "ref")
    ckpt = tmp_path / "ckpt"
    plan = {"seed": 0, "faults": [{"site": "checkpoint.fsync", "action": "kill",
                                   "hits": [2]}]}
    rc = _run_child(tmp_path, tmp_path / "killed", ckpt=ckpt, plan=plan, expect_kill=True)
    assert rc == -9  # SIGKILL between the fsync and the rename
    # the torn write left a stale tmp; the sealed but unreferenced record
    # and the previous verified record are both on disk
    assert (ckpt / "state.json.tmp").exists()
    assert verify_checkpoint_dir(str(ckpt / "iter-0001"))[0] is True
    assert json.load(open(ckpt / "state.json"))["completed_iterations"] == 1
    resumed = _run_child(tmp_path, tmp_path / "resumed", ckpt=ckpt)
    recovery = resumed["checkpoint_recovery"]
    assert recovery["fallback"] is False and recovery["resumed_from_iteration"] == 0
    assert any(p.endswith("state.json.tmp") for p in recovery["pruned"])
    np.testing.assert_allclose(resumed["objective_history"], ref["objective_history"],
                               rtol=0, atol=1e-9)


def test_cli_sigterm_exits_75_then_resumes(data, tmp_path):
    """cli.train under a plan whose `sigterm` action lands at the second
    checkpoint write: exit 75 with its JSON line after a durable record;
    the same command without the plan resumes to the uninterrupted
    history."""
    import contextlib
    import io
    from photon_ml_tpu_torch.cli import train as train_cli
    train, val = data
    save_game_dataset(train, str(tmp_path / "train.npz"))
    (tmp_path / "config.json").write_text(json.dumps(side.containment_config_dict(3)))
    argv = ["--train-data", str(tmp_path / "train.npz"), "--config",
            str(tmp_path / "config.json"), "--device", "cpu", "--x64",
            "--timing-mode", "strict", "--checkpoint-dir", str(tmp_path / "ckpt")]

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv + list(extra))
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    plan = {"seed": 0, "faults": [{"site": "checkpoint.write", "action": "sigterm",
                                   "hits": [2]}]}
    rc, line = run("--output-dir", str(tmp_path / "a"), "--fault-plan", json.dumps(plan))
    assert rc == faults.EXIT_PREEMPTED == line["exit_status"] == 75
    assert line["preempted"] and line["resumable"] and line["completed_iterations"] == 2
    assert faults.active_plan() is None and not faults.preemption_requested()
    rc, resumed = run("--output-dir", str(tmp_path / "b"))
    assert rc == 0 and resumed["checkpoint_recovery"]["resumed_from_iteration"] == 1
    straight = _estimator(3).fit(train)
    assert abs(resumed["final_objective"] - straight.objective_history[-1]) <= 1e-9
