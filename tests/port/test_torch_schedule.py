"""Port optim/schedule.py == the JAX package's, and what the budgets do in
the port's solvers.

The schedule module is host arithmetic in both packages, so it is held
equal in this process: `plan`, `budget_for` and `stochastic_plan`/
`admm_polish` on a grid of (outer iteration, outer iterations, configured
max_iterations, tolerance), the validation errors, `to_dict`/`from_dict`,
and QuarantineRetrySchedule's plans; a schedule written into a
GameTrainingConfig by either package loads in the other.  In the port
alone, float64 on the CPU: a full budget gives the uncapped solve bit for
bit (LBFGS, OWLQN, TRON, batched lanes), a budget's tolerance is rounded to
the solve's dtype, and a scheduled GLMix fit lands within 1e-4 of the
strict fit's final objective with fewer inner iterations (the JAX
package's tests/test_inexact.py gates)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
from photon_ml_tpu.optim import OptimizerConfig as JOptimizerConfig
from photon_ml_tpu.optim import OptimizerType as JOptimizerType
from photon_ml_tpu.optim import RegularizationContext as JRegularizationContext
from photon_ml_tpu.optim import RegularizationType as JRegularizationType
from photon_ml_tpu.optim import schedule as jschedule
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim import schedule as tschedule
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType, solve,
)
from photon_ml_tpu_torch.parallel import random_effect as tre

SCHEDULES = [dict(), dict(initial_iterations=3), dict(initial_iterations=1, iteration_growth=1.5),
             dict(initial_iterations=7, iteration_growth=3.0, initial_tolerance_factor=50.0,
                  tolerance_decay=0.5),
             dict(stochastic_passes=2, stochastic_local_epochs=3, stochastic_merge="average",
                  stochastic_seed=5, stochastic_polish_iterations=2),
             dict(admm_polish_iterations=3)]
GRID = [(t, n, m, tol) for n in (1, 2, 5, 9) for t in range(n)
        for m in (0, 1, 4, 15, 100) for tol in (1e-7, 1e-5, 0.3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[str(i) for i in range(len(SCHEDULES))])
def test_plans_match_jax(kw):
    t_s, j_s = tschedule.SolverSchedule(**kw), jschedule.SolverSchedule(**kw)
    for t, n, m, tol in GRID:
        assert t_s.plan(t, n, m, tol) == j_s.plan(t, n, m, tol)
        assert t_s.admm_polish(t, n) == j_s.admm_polish(t, n)
        assert t_s.stochastic_plan(t, n) == (
            None if j_s.stochastic_plan(t, n) is None
            else tschedule.StochasticPlan(**dataclasses.asdict(j_s.stochastic_plan(t, n))))
    for opt in (dict(), dict(max_iterations=40, tolerance=1e-9),
                dict(optimizer="tron"), dict(optimizer="tron", max_iterations=7)):
        t_cfg = OptimizerConfig(**dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs"))))
        j_cfg = JOptimizerConfig(**dict(opt, optimizer=JOptimizerType(opt.get("optimizer",
                                                                              "lbfgs"))))
        for t, n in ((0, 4), (2, 4), (3, 4)):
            got, want = t_s.budget_for(t, n, t_cfg), j_s.budget_for(t, n, j_cfg)
            assert got == (int(want.iteration_cap), float(want.tolerance))
            assert isinstance(got.iteration_cap, int) and isinstance(got.tolerance, float)
    assert t_s.to_dict() == j_s.to_dict()
    assert json.dumps(t_s.to_dict()) == json.dumps(j_s.to_dict())
    assert tschedule.SolverSchedule.from_dict(j_s.to_dict()) == t_s
    assert dataclasses.asdict(jschedule.SolverSchedule.from_dict(t_s.to_dict())) == \
        dataclasses.asdict(t_s)
    assert tschedule.SolverSchedule.from_dict(None) is None


@pytest.mark.parametrize("kw", [dict(), dict(cap_divisor=3, tolerance_factor=4.0),
                                dict(cap_divisor=100)])
def test_quarantine_retry_plans_match_jax(kw):
    t_s, j_s = tschedule.QuarantineRetrySchedule(**kw), jschedule.QuarantineRetrySchedule(**kw)
    for t, n, m, tol in GRID:
        assert t_s.plan(t, n, m, tol) == j_s.plan(t, n, m, tol)
    got = t_s.budget_for(0, 3, OptimizerConfig(max_iterations=60, tolerance=1e-8))
    want = j_s.budget_for(0, 3, JOptimizerConfig(max_iterations=60, tolerance=1e-8))
    assert got == (int(want.iteration_cap), float(want.tolerance))


BAD = [(dict(initial_iterations=0), "initial_iterations"),
       (dict(iteration_growth=0.5), "iteration_growth"),
       (dict(initial_tolerance_factor=0.5), "initial_tolerance_factor"),
       (dict(tolerance_decay=0.0), "tolerance_decay"),
       (dict(tolerance_decay=1.5), "tolerance_decay"),
       (dict(stochastic_passes=-1), "stochastic_passes"),
       (dict(stochastic_local_epochs=0), "stochastic_local_epochs"),
       (dict(stochastic_merge="mean"), "stochastic_merge"),
       (dict(stochastic_polish_iterations=0), "stochastic_polish_iterations"),
       (dict(admm_polish_iterations=0), "admm_polish_iterations")]


@pytest.mark.parametrize("kw,match", BAD, ids=[b[1] + str(i) for i, b in enumerate(BAD)])
def test_validation_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as t_err:
        tschedule.SolverSchedule(**kw)
    with pytest.raises(ValueError) as j_err:
        jschedule.SolverSchedule(**kw)
    assert str(t_err.value) == str(j_err.value)


def test_stochastic_plan_validation_matches_jax():
    for kw in (dict(passes=-1), dict(local_epochs=0), dict(merge="x")):
        with pytest.raises(ValueError) as t_err:
            tschedule.StochasticPlan(**kw)
        with pytest.raises(ValueError) as j_err:
            jschedule.StochasticPlan(**kw)
        assert str(t_err.value) == str(j_err.value)


def _schedule_config_dict() -> dict:
    d = side.containment_config_dict(4, side.CONT_SCHEDULE, factored=True)
    d["coordinates"]["perUser"]["solver_schedule"] = {"initial_iterations": 2,
                                                     "iteration_growth": 1.5,
                                                     "initial_tolerance_factor": 10.0,
                                                     "tolerance_decay": 0.5}
    d["coordinates"]["fixed"]["solver_schedule"] = tschedule.SolverSchedule(
        stochastic_passes=1, admm_polish_iterations=2).to_dict()
    return d


def test_schedule_configs_load_in_either_package():
    d = _schedule_config_dict()
    t_cfg, j_cfg = GameTrainingConfig.from_dict(d), JConfig.from_dict(d)
    assert t_cfg.solver_schedule == tschedule.SolverSchedule(**side.CONT_SCHEDULE)
    assert t_cfg.coordinates["perUser"].solver_schedule.initial_iterations == 2
    assert t_cfg.coordinates["fixed"].solver_schedule.stochastic_passes == 1
    assert t_cfg.coordinates["perUserMF"].solver_schedule is None
    # each package writes the JSON the other reads, byte for byte
    assert t_cfg.to_json() == j_cfg.to_json()
    assert JConfig.from_json(t_cfg.to_json()).to_json() == t_cfg.to_json()
    assert GameTrainingConfig.from_json(j_cfg.to_json()) == t_cfg


def _cap_objective():
    p = side.cap_problem()
    return GLMObjective(TL.BY_NAME["logistic"], torch.from_numpy(p["x"]),
                        torch.from_numpy(p["y"])), p["x"].shape[1]


@pytest.mark.parametrize("kind", list(side.CAP_SINGLE))
def test_full_budget_is_the_uncapped_solve_bitwise(kind):
    obj, d = _cap_objective()
    opt, reg = side.CAP_SINGLE[kind]
    cfg = OptimizerConfig(**dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs"))))
    reg = RegularizationContext(RegularizationType(reg))
    r = cfg.resolved()
    x0 = torch.zeros(d, dtype=torch.float64)
    static = solve(obj, x0, cfg, reg, 1.0)
    budgeted = solve(obj, x0, cfg, reg, 1.0,
                     budget=tschedule.SolveBudget.make(r.max_iterations, r.tolerance))
    assert static.iterations == budgeted.iterations and static.reason == budgeted.reason
    assert torch.equal(static.x, budgeted.x)
    assert torch.equal(torch.nan_to_num(static.loss_history, nan=-1.0),
                       torch.nan_to_num(budgeted.loss_history, nan=-1.0))
    # a cap stops early and keeps the history shape; a loose tolerance
    # stops with a convergence reason
    capped = solve(obj, x0, cfg, reg, 1.0, budget=tschedule.SolveBudget.make(2, r.tolerance))
    assert capped.iterations == 2 and capped.loss_history.shape == static.loss_history.shape
    loose = solve(obj, x0, cfg, reg, 1.0, budget=tschedule.SolveBudget.make(100, 1e-2))
    assert loose.iterations < static.iterations


@pytest.mark.parametrize("case", side.CAP_BATCHED)
def test_full_budget_batched_lanes_bitwise(case):
    loss, reg, alpha, lam, _, opt = side.SOLVER_CASES[case]
    opt = dict(opt)
    if "optimizer" in opt:
        opt["optimizer"] = OptimizerType(opt["optimizer"])
    cfg = OptimizerConfig(**{"max_iterations": side.SOLVER_MAX_ITERATIONS,
                             "tolerance": side.SOLVER_TOLERANCE, **opt})
    p = {k: torch.from_numpy(v) for k, v in side.solver_problem(case).items()}
    blocks = tre.EntityBlocks(p["x"], p["labels"], p["mask"], p["weights"], p["offsets"])
    run = lambda budget: tre.fit_random_effects(
        blocks, TL.BY_NAME[loss], x0=p["x0"], config=cfg,
        reg=RegularizationContext(RegularizationType(reg), alpha), reg_weight=lam,
        budget=budget)
    static = run(None)
    r = cfg.resolved()
    budgeted = run(tschedule.SolveBudget.make(r.max_iterations, r.tolerance))
    assert torch.equal(static.iterations, budgeted.iterations)
    assert torch.equal(static.x, budgeted.x)
    assert static.rounds == budgeted.rounds


def test_budget_tolerance_is_rounded_to_the_solve_dtype():
    b = tschedule.SolveBudget.make(5, 1e-7)
    assert b.tolerance_in(torch.float64) == 1e-7
    f32 = b.tolerance_in(torch.float32)
    assert f32 != 1e-7 and f32 == float(np.float32(1e-7))


def _pipeline_glmix(rng, n=1000, d_global=6, num_users=25, d_user=3):
    """tests/test_pipeline.py's _glmix, the data of the JAX package's
    parity gate (tests/test_inexact.py), with the port's build_game_dataset."""
    xg = rng.normal(size=(n, d_global)); xg[:, -1] = 1.0
    xu = rng.normal(size=(n, d_user)); xu[:, -1] = 1.0
    users = rng.integers(0, num_users, size=n)
    z = xg @ rng.normal(size=d_global) + np.einsum(
        "nd,nd->n", xu, rng.normal(size=(num_users, d_user))[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    ds = build_game_dataset(y, {"global": xg, "per_user": xu},
                            entity_ids={"userId": np.asarray([f"u{u:03d}" for u in users])})
    rows = np.arange(n)
    return ds.subset(rows[:800]), ds.subset(rows[800:])


def _convex_config(outer, schedule=None) -> GameTrainingConfig:
    """tests/test_inexact.py's _convex_config: LBFGS at its defaults, L2
    lambda 0.1 on the fixed effect and 1 on the per-user effect."""
    from photon_ml_tpu_torch.game import (FixedEffectCoordinateConfig, GLMOptimizationConfig,
                                          RandomEffectCoordinateConfig)
    l2 = RegularizationContext(RegularizationType.L2)
    return GameTrainingConfig(
        task_type="logistic_regression",
        coordinates={
            "fixed": FixedEffectCoordinateConfig("global", GLMOptimizationConfig(
                regularization=l2, regularization_weight=0.1)),
            "perUser": RandomEffectCoordinateConfig("userId", "per_user", GLMOptimizationConfig(
                regularization=l2, regularization_weight=1.0))},
        updating_sequence=["fixed", "perUser"], num_outer_iterations=outer,
        solver_schedule=schedule)


def test_strict_vs_scheduled_final_parity_f64():
    """The scheduled fit's final objective (full budget on the last outer
    iteration) lands within the 1e-4 gate of the strict fit's, with fewer
    inner iterations, and its caps follow the schedule (the JAX package's
    test_strict_vs_scheduled_final_parity_f64)."""
    train, val = _pipeline_glmix(np.random.default_rng(7))
    kw = dict(device="cpu", dtype=torch.float64)
    strict = GameEstimator(_convex_config(5), **kw).fit(train, val)
    sched = GameEstimator(_convex_config(5, tschedule.SolverSchedule(initial_iterations=3)),
                          **kw).fit(train, val)
    a, b = strict.objective_history[-1], sched.objective_history[-1]
    assert abs(a - b) / abs(a) <= 1e-4
    assert sched.descent.total_iterations() < strict.descent.total_iterations()
    diag = sched.descent.solver_diagnostics()
    assert diag["fixed"]["iteration_caps"] == [3, 6, 12, 24, 100]
    assert diag["perUser"]["iteration_caps"] == [3, 6, 12, 24, 100]
    assert diag["fixed"]["reasons"]
    assert strict.descent.solver_diagnostics()["fixed"]["iteration_caps"] == [None] * 5


def test_coordinate_schedule_overrides_the_training_schedule():
    train, _ = side.containment_glmix(build_game_dataset)
    d = side.containment_config_dict(3, {"initial_iterations": 5})
    d["coordinates"]["perUser"]["solver_schedule"] = {"initial_iterations": 1,
                                                     "iteration_growth": 2.0}
    fit = GameEstimator(GameTrainingConfig.from_dict(d), device="cpu",
                        dtype=torch.float64).fit(train)
    diag = fit.descent.solver_diagnostics()
    assert diag["fixed"]["iteration_caps"] == [5, 10, 15]
    assert diag["perUser"]["iteration_caps"] == [1, 2, 15]


@pytest.mark.parametrize("reg", ["l2", "elastic_net"])
def test_reg_weights_split_as_the_jax_package(reg):
    """RegWeights.from_context splits a total weight as `reg.split` does and
    as the JAX package's RegWeights does, with the context's own mix and
    with a mix given."""
    alpha = 0.3 if reg == "elastic_net" else None
    ctx = RegularizationContext(RegularizationType(reg), alpha)
    j_ctx = JRegularizationContext(JRegularizationType(reg), alpha)
    weights = tschedule.RegWeights.from_context(ctx, 2.0, dtype=torch.float64)
    j_weights = jschedule.RegWeights.from_context(j_ctx, 2.0)
    assert (float(weights.l1_weight), float(weights.l2_weight)) == \
        tuple(float(w) for w in ctx.split(2.0)) == \
        (float(j_weights.l1_weight), float(j_weights.l2_weight))
    mixed = tschedule.RegWeights.from_context(ctx, 2.0, elastic_net_alpha=0.25)
    j_mixed = jschedule.RegWeights.from_context(j_ctx, 2.0, elastic_net_alpha=0.25)
    assert (float(mixed.l1_weight), float(mixed.l2_weight)) == \
        (float(j_mixed.l1_weight), float(j_mixed.l2_weight))
    made = tschedule.RegWeights.make(0.5, 1.5, dtype=torch.float64)
    assert made.l1_weight.dtype == torch.float64 and float(made.l2_weight) == 1.5
