"""Port solver schedules, iteration caps, the quarantine and checkpoints ==
the JAX package's, and checkpoints cross-resume between the packages.

The JAX side (game_jax_side.py containment) runs once for the module in a
subprocess, float64 on the CPU.  Inputs: tests/test_faults.py's GLMix
shape (900 rows, 30 users, d = 8 and 4, split 90/10, LBFGS(15), L2
lambda 1) and a [300 x 8] logistic problem; the batched lanes reuse
game_jax_side.SOLVER_CASES.  Held equal:
  - capped solves (caps 3 and 0) of LBFGS, OWLQN and TRON and of the
    batched LBFGS, OWLQN, box and TRON lanes: iterations, reasons, pass
    counts, coefficients (atol 1e-9) and histories with their NaN padding
    (rtol 1e-10);
  - scheduled fits (GLMix in both timing modes, and with a factored
    coordinate) and a strict one: objective histories within 1e-10
    relative and equal iteration caps per visit;
  - a poisoned perUser solve in both timing modes and repeated poison
    (freeze): equal containment events and frozen coordinates, histories
    within 1e-10;
  - a checkpoint the JAX package wrote after 1 of 3 outer iterations,
    resumed by the port, and one the port wrote, resumed by the JAX
    package: both end within 1e-10 of the uninterrupted 3-iteration fit;
    `_config_fingerprint` is the same 16 hex digits in both packages;
  - cli.train with --checkpoint-dir and --fault-plan (a poisoned
    2-iteration run, then the same command at 3 iterations resuming from
    its checkpoint): the summaries' final objective, containment events,
    frozen coordinates, fault report, checkpoint recovery and per-solve
    caps and containment counts."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
from photon_ml_tpu.game.estimator import GameEstimator as JEstimator
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType, solve,
)
from photon_ml_tpu_torch.optim.schedule import SolveBudget
from photon_ml_tpu_torch.parallel import random_effect as tre
from photon_ml_tpu_torch.utils import faults

REL = 1e-10
F64 = dict(device="cpu", dtype=torch.float64)


def _estimator(config_dict):
    return GameEstimator(GameTrainingConfig.from_dict(config_dict), **F64)


@pytest.fixture(scope="module")
def data():
    return side.containment_glmix(build_game_dataset)


@pytest.fixture(scope="module")
def root(tmp_path_factory, data):
    """The inputs of both sides: the CLI's npz datasets and configs, and a
    checkpoint the port wrote after 1 outer iteration (port_ckpt)."""
    root = tmp_path_factory.mktemp("containment")
    train, val = data
    save_game_dataset(train, str(root / "cont_train.npz"))
    save_game_dataset(val, str(root / "cont_val.npz"))
    for outer in (2, 3):
        (root / f"cont_config{outer}.json").write_text(json.dumps(
            side.containment_config_dict(outer)))
    _estimator(side.containment_config_dict(1)).fit(
        train, val, ["AUC"], checkpoint_dir=str(root / "port_ckpt"))
    return root


@pytest.fixture(scope="module")
def jax_results(root):
    return side.run_jax_side("containment", root / "jax.npz")


@pytest.fixture(scope="module")
def port_fits(data):
    train, val = data
    out = {}
    for name, (make, mode, plan) in side.CONTAINMENT_FITS.items():
        with faults.injected(faults.FaultPlan.from_dict(plan or {"faults": []})):
            out[name] = _estimator(make()).fit(train, val, ["AUC"], timing_mode=mode)
    return out


def _diagnostics(fit) -> dict:
    return {c: {"iteration_caps": d["iteration_caps"], "containment": d["containment"],
                "iterations": d["iterations"]}
            for c, d in fit.descent.solver_diagnostics().items()}


def _assert_solve_equal(res, jax_results, key, count):
    j = lambda f: jax_results[f"{key}/{f}"]
    np.testing.assert_array_equal(np.asarray(res.iterations), j("iterations"))
    np.testing.assert_array_equal(np.asarray(res.reason), j("reason"))
    np.testing.assert_array_equal(np.asarray(getattr(res, count)), j(count))
    np.testing.assert_allclose(np.asarray(res.x), j("x"), rtol=0, atol=1e-9)
    got = np.asarray(res.loss_history)
    assert got.shape == j("loss_history").shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(j("loss_history")))
    np.testing.assert_allclose(got, j("loss_history"), rtol=REL, atol=1e-13,
                               equal_nan=True)


@pytest.mark.parametrize("cap", side.CAPS)
@pytest.mark.parametrize("kind", list(side.CAP_SINGLE))
def test_capped_single_solve_matches_jax(jax_results, kind, cap):
    p = side.cap_problem()
    opt, reg = side.CAP_SINGLE[kind]
    opt = dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs")))
    obj = GLMObjective(TL.BY_NAME["logistic"], torch.from_numpy(p["x"]),
                       torch.from_numpy(p["y"]))
    res = solve(obj, torch.zeros(p["x"].shape[1], dtype=torch.float64),
                OptimizerConfig(**opt), RegularizationContext(RegularizationType(reg)),
                1.0, budget=SolveBudget.make(cap, opt["tolerance"]))
    assert res.iterations == min(cap, opt["max_iterations"]) or res.iterations < cap
    _assert_solve_equal(res, jax_results, f"caps/{kind}/{cap}",
                        "hv_count" if kind == "tron" else "fg_count")


@pytest.mark.parametrize("cap", side.CAPS)
@pytest.mark.parametrize("case", side.CAP_BATCHED)
def test_capped_batched_lanes_match_jax(jax_results, case, cap):
    loss, reg, alpha, lam, _, opt = side.SOLVER_CASES[case]
    opt = dict(opt)
    if "optimizer" in opt:
        opt["optimizer"] = OptimizerType(opt["optimizer"])
    cfg = OptimizerConfig(**{"max_iterations": side.SOLVER_MAX_ITERATIONS,
                             "tolerance": side.SOLVER_TOLERANCE, **opt})
    p = {k: torch.from_numpy(v) for k, v in side.solver_problem(case).items()}
    blocks = tre.EntityBlocks(p["x"], p["labels"], p["mask"], p["weights"], p["offsets"])
    res = tre.fit_random_effects(
        blocks, TL.BY_NAME[loss], x0=p["x0"], config=cfg,
        reg=RegularizationContext(RegularizationType(reg), alpha), reg_weight=lam,
        budget=SolveBudget.make(cap, cfg.resolved().tolerance))
    assert int(res.iterations.max()) <= cap
    _assert_solve_equal(res, jax_results, f"caps/{case}/{cap}",
                        "hv_count" if cfg.optimizer == OptimizerType.TRON else "fg_count")


def _assert_fit_equal(fit, jax_results, name):
    j = lambda f: jax_results[f"{name}/{f}"]
    np.testing.assert_allclose(fit.objective_history, j("objective_history"), rtol=REL)
    np.testing.assert_allclose(fit.descent.validation_history["AUC"], j("auc_history"),
                               rtol=0, atol=1e-9)
    assert _diagnostics(fit) == json.loads(str(j("diagnostics")))
    assert fit.descent.frozen_coordinates == json.loads(str(j("frozen")))
    events = json.loads(str(j("events")))
    assert [{k: v for k, v in e.items() if k != "objective"}
            for e in fit.descent.containment_events] == \
        [{k: v for k, v in e.items() if k != "objective"} for e in events]
    for got, want in zip(fit.descent.containment_events, events):
        if "objective" in want:
            assert abs(got["objective"] - want["objective"]) <= REL * abs(want["objective"])


@pytest.mark.parametrize("name", ["straight", "scheduled", "scheduled_strict",
                                  "scheduled_factored"])
def test_scheduled_fit_matches_jax(jax_results, port_fits, name):
    fit = port_fits[name]
    _assert_fit_equal(fit, jax_results, name)
    caps = _diagnostics(fit)["fixed"]["iteration_caps"]
    if name == "straight":
        assert caps == [None] * 3
    else:
        outer = len(caps)
        assert caps == [min(3 * 2 ** t, side.CONT_ITERATIONS) for t in range(outer - 1)] \
            + [side.CONT_ITERATIONS]


@pytest.mark.parametrize("name", ["poison_pipelined", "poison_strict", "freeze"])
def test_poisoned_fit_matches_jax(jax_results, port_fits, name):
    fit = port_fits[name]
    _assert_fit_equal(fit, jax_results, name)
    assert np.all(np.isfinite(fit.objective_history))
    actions = [e["action"] for e in fit.descent.containment_events]
    if name == "freeze":
        assert fit.descent.frozen_coordinates == ["perUser"] and "frozen" in actions
    else:
        assert actions == ["rolled_back", "retry_ok"]


def test_port_resumes_a_jax_checkpoint(jax_results, root, data):
    train, val = data
    fit = _estimator(side.containment_config_dict(3)).fit(
        train, val, ["AUC"], checkpoint_dir=str(root / "jax_ckpt"))
    assert fit.checkpoint_recovery["fallback"] is False
    assert fit.checkpoint_recovery["resumed_from_iteration"] == 0
    np.testing.assert_allclose(fit.objective_history,
                               jax_results["straight/objective_history"], rtol=REL)


def test_jax_resumes_a_port_checkpoint(jax_results, port_fits):
    recovery = json.loads(str(jax_results["resumed_from_port/recovery"]))
    assert recovery["fallback"] is False and recovery["resumed_from_iteration"] == 0
    np.testing.assert_allclose(jax_results["resumed_from_port/objective_history"],
                               jax_results["straight/objective_history"], rtol=REL)
    np.testing.assert_allclose(jax_results["resumed_from_port/objective_history"],
                               port_fits["straight"].objective_history, rtol=REL)


FINGERPRINT_CONFIGS = {**side.ESTIMATOR_CONFIGS,
                       "containment": lambda: side.containment_config_dict(3),
                       "scheduled_factored": lambda: side.containment_config_dict(
                           3, side.CONT_SCHEDULE, True)}


@pytest.mark.parametrize("name", list(FINGERPRINT_CONFIGS))
def test_config_fingerprint_matches_jax(name):
    d = FINGERPRINT_CONFIGS[name]()
    fingerprint = lambda d, specs=None: _estimator(d)._config_fingerprint(specs)
    for specs in (None, ["AUC", "RMSE"]):
        got = fingerprint(d, specs)
        assert got == JEstimator(JConfig.from_dict(d))._config_fingerprint(specs)
        assert len(got) == 16
    # the outer iteration count is not part of it; the rest is
    assert fingerprint(dict(d, num_outer_iterations=7)) == fingerprint(d)
    assert fingerprint(dict(d, seed=d["seed"] + 1)) != fingerprint(d)


@pytest.fixture(scope="module")
def cli_runs(root, jax_results):
    out = {}
    for name, argv, plan in side.containment_cli_runs(root):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(side.containment_cli_argv(argv, plan, root / "port_out")
                                + ["--device", "cpu"])
        assert rc == 0 and int(jax_results[f"cli/{name}/rc"]) == 0
        out[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                     json.loads(str(jax_results[f"cli/{name}/json"])))
    return out


@pytest.mark.parametrize("name", ["poisoned", "resumed"])
def test_cli_checkpoint_and_fault_plan_match_jax(cli_runs, name):
    port, jax = cli_runs[name]
    assert abs(port["final_objective"] - jax["final_objective"]) <= \
        REL * abs(jax["final_objective"])
    strip = lambda events: [{k: v for k, v in e.items() if k != "objective"}
                            for e in events]
    assert strip(port["containment_events"]) == strip(jax["containment_events"])
    assert port["frozen_coordinates"] == jax["frozen_coordinates"]
    assert port["fault_report"] == jax["fault_report"]
    for coord, d in jax["solver_diagnostics"].items():
        for key in ("iteration_caps", "containment", "iterations", "solves"):
            assert port["solver_diagnostics"][coord][key] == d[key], (coord, key)
    if name == "poisoned":
        assert port["checkpoint_recovery"] is None is jax["checkpoint_recovery"]
        assert [e["action"] for e in port["containment_events"]] == ["rolled_back",
                                                                      "retry_ok"]
        assert port["fault_report"]["total_fired"] == 1
    else:
        p, j = port["checkpoint_recovery"], jax["checkpoint_recovery"]
        assert (p["fallback"], p["resumed_from_iteration"]) == \
            (j["fallback"], j["resumed_from_iteration"]) == (False, 1)
        assert p["pruned"] == j["pruned"] == []
