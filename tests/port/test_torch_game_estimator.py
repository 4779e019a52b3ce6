"""Port GameEstimator.fit == the JAX package's, GLMix end to end.

BASELINE config 4's coordinates (fixed effect + per-user random effect,
LBFGS(100), L2 lambda 1, two outer iterations) on make_movielens_like("1m",
seed=11, n_rows=3000), split 95/5, in float64 on the CPU; and a variant
with a standardized fixed effect and an elastic-net random effect whose cap
bites (passive and discarded rows, Pearson selection).  The JAX side runs
once for the module in a subprocess (game_jax_side.py), so its XLA
programs never compile in the test process.  Tolerances: objective history
rtol 1e-8, validation AUC 1e-9 absolute, final coefficients atol 1e-6,
equal iteration counts per solve; the JAX model's parameters carried across
by game_model_from_numpy score the validation set to rtol 1e-12.  Both run
the pipelined timing mode (the default of either package); the port's
pipelined fit equals its strict fit bit for bit and the JAX package's
pipelined histories to rtol 1e-12."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
from photon_ml_tpu_torch.evaluation import evaluators as ev
from photon_ml_tpu_torch.game import (
    GameEstimator, GameTrainingConfig, GLMOptimizationConfig,
    run_coordinate_descent, select_best_result,
)
from photon_ml_tpu_torch.game.config import FactoredRandomEffectCoordinateConfig
from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.optim.schedule import SolverSchedule


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("estimator", tmp_path_factory.mktemp("jax") / "estimator.npz")


@pytest.fixture(scope="module")
def data():
    return side.movielens_glmix(build_game_dataset, make_movielens_like,
                                movielens_shards)


@pytest.fixture(scope="module")
def config():
    return GameTrainingConfig.from_dict(side.glmix_config_dict())


@pytest.fixture(scope="module")
def fits(data):
    """name -> the port's fit of each parity configuration."""
    train, val = data
    return {name: GameEstimator(GameTrainingConfig.from_dict(make()), device="cpu",
                                dtype=torch.float64).fit(train, val, ["AUC"])
            for name, make in side.ESTIMATOR_CONFIGS.items()}


@pytest.fixture(scope="module")
def fitted(fits):
    return fits["config4"]


CASES = list(side.ESTIMATOR_CONFIGS)


@pytest.mark.parametrize("name", CASES)
def test_objective_history_matches_jax(jax_results, fits, name):
    want = jax_results[f"{name}/objective_history"]
    got = fits[name].objective_history
    assert len(got) == len(want) == 2 * side.ESTIMATOR_OUTER
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("name", CASES)
def test_validation_auc_matches_jax(jax_results, fits, name):
    fit = fits[name]
    np.testing.assert_allclose(fit.descent.validation_history["AUC"],
                               jax_results[f"{name}/auc_history"], rtol=0, atol=1e-9)
    assert abs(fit.validation["AUC"] - float(jax_results[f"{name}/auc"])) <= 1e-9
    assert 0.5 < fit.validation["AUC"] < 1.0


@pytest.fixture(scope="module")
def strict_fits(data):
    train, val = data
    return {name: GameEstimator(GameTrainingConfig.from_dict(make()), device="cpu",
                                dtype=torch.float64).fit(train, val, ["AUC"],
                                                         timing_mode="strict")
            for name, make in side.ESTIMATOR_CONFIGS.items()}


@pytest.mark.parametrize("name", CASES)
def test_pipelined_equals_strict_bit_for_bit(fits, strict_fits, name):
    """Pipelining moves only the read-backs: the same objective and
    validation histories, trackers and final coefficients, bit for bit."""
    p, s = fits[name].descent, strict_fits[name].descent
    assert p.objective_history == s.objective_history
    assert p.validation_history == s.validation_history
    assert [(k, t.iterations, t.fg_count, t.reasons) for k, t in p.trackers.items()] == \
        [(k, t.iterations, t.fg_count, t.reasons) for k, t in s.trackers.items()]
    for name_, m in p.model.coordinates.items():
        a = getattr(m, "coefficients", None)
        a = m.glm.coefficients.means if a is None else a
        b = s.model.coordinates[name_]
        b = b.glm.coefficients.means if getattr(b, "coefficients", None) is None \
            else b.coefficients
        assert torch.equal(a, b)
    assert sum(1 for k in p.timings if k.endswith("/flush")) == side.ESTIMATOR_OUTER
    assert not any(k.endswith("/flush") for k in s.timings)


@pytest.mark.parametrize("name", CASES)
def test_pipelined_histories_match_jax_pipelined(jax_results, fits, name):
    np.testing.assert_allclose(fits[name].objective_history,
                               jax_results[f"{name}/objective_history"], rtol=1e-12)
    np.testing.assert_allclose(fits[name].descent.validation_history["AUC"],
                               jax_results[f"{name}/auc_history"], rtol=1e-12)


@pytest.mark.parametrize("name", CASES)
def test_coefficients_and_iterations_match_jax(jax_results, fits, data, name):
    fit = fits[name]
    m = fit.descent.model.coordinates
    j = lambda k: jax_results[f"{name}/{k}"]
    np.testing.assert_allclose(m["fixed"].glm.coefficients.means.numpy(),
                               j("fixed/means"), rtol=0, atol=1e-6)
    np.testing.assert_allclose(m["perUser"].coefficients.numpy(),
                               j("perUser/coefficients"), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m["perUser"].entity_ids, j("perUser/entity_ids"))
    np.testing.assert_array_equal(m["perUser"].projection, j("perUser/projection"))
    for key, t in fit.descent.trackers.items():
        assert t.iterations == int(j(f"iterations/{key}")), key
        if name == "tron":
            assert t.fg_count is None and t.hv_count >= t.iterations > 0
        else:
            assert t.fg_count > t.iterations > 0
    np.testing.assert_allclose(fit.descent.model.score_dataset(data[1]).numpy(),
                               j("val_scores"), rtol=0, atol=1e-6)


def test_the_variant_exercises_what_it_names(data):
    from photon_ml_tpu_torch.data.batching import build_random_effect_dataset
    train, _ = data
    cfg = GameTrainingConfig.from_dict(side.variant_config_dict())
    red = build_random_effect_dataset(train, cfg.coordinates["perUser"].data_config(11),
                                      device="cpu", block_dtype=torch.float64)
    assert red.num_passive > 0 and len(red.discarded_rows) > 0
    assert (red.projection >= 0).sum(1).min() < red.projection.shape[1]


def test_jax_model_scores_identically_in_the_port(jax_results, data):
    _, val = data
    j = lambda k: jax_results[f"config4/{k}"]
    model = game_model_from_numpy("logistic_regression", {
        "fixed": {"kind": "fixed_effect", "feature_shard": "global",
                  "means": j("fixed/means")},
        "perUser": {"kind": "random_effect", "random_effect_type": "userId",
                    "feature_shard": "per_user",
                    "coefficients": j("perUser/coefficients"),
                    "entity_ids": j("perUser/entity_ids"),
                    "projection": j("perUser/projection"),
                    "global_dim": j("perUser/global_dim")}}, device="cpu")
    np.testing.assert_allclose(model.score_dataset(val).numpy(),
                               j("val_scores"), rtol=1e-12, atol=1e-14)
    p = model.predict(val).numpy()
    assert p.shape == (val.num_rows,) and ((p > 0) & (p < 1)).all()
    with pytest.raises(ValueError, match="unknown kind"):
        game_model_from_numpy("logistic_regression", {"f": {"kind": "factored"}},
                              device="cpu")


def test_config_json_round_trips_across_packages(config):
    j = JConfig.from_json(config.to_json())
    assert j.to_dict() == config.to_dict()
    back = GameTrainingConfig.from_json(j.to_json())
    assert back == config and back.to_dict() == j.to_dict()
    full = json.loads(j.to_json())
    assert full == side.glmix_config_dict()


@pytest.mark.parametrize("name", CASES)
def test_each_parity_config_json_round_trips_across_packages(name):
    d = side.ESTIMATOR_CONFIGS[name]()
    port = GameTrainingConfig.from_dict(d)
    j = JConfig.from_json(port.to_json())
    assert j.to_dict() == port.to_dict() == d
    assert GameTrainingConfig.from_json(j.to_json()) == port


def test_tron_fit_reports_hessian_vector_counts(fits):
    """Under TRON the trackers count Hessian-vector products (hv_count) and
    each random-effect bucket its batched Hv rounds (hv_rounds)."""
    trackers = fits["tron"].descent.trackers
    assert {t.reasons.keys() <= {"GRADIENT_CONVERGED", "TRUST_REGION_EXHAUSTED",
                                 "MAX_ITERATIONS"} for t in trackers.values()} == {True}
    for key, t in trackers.items():
        if key.endswith("/perUser"):
            assert all(b.hv_rounds is not None and b.rounds >= 1 for b in t.buckets)
            assert max(b.hv_rounds for b in t.buckets) <= t.hv_count
        else:
            assert t.buckets is None and t.hv_count >= t.iterations
    assert all(b.hv_rounds is None for t in fits["config4"].descent.trackers.values()
               if t.buckets for b in t.buckets)


def test_fit_records_phases_and_trackers(fitted):
    t = fitted.descent.timings
    assert {"build/coordinates", "init/transfer", "init/score", "0/fixed/solve",
            "1/perUser/validation"} <= set(t)
    assert t.total() > 0 and t.host_blocked_total() > 0
    assert fitted.descent.total_iterations() == sum(
        x.iterations for x in fitted.descent.trackers.values())
    assert fitted.model is fitted.descent.best_model


def test_random_effect_update_reports_its_buckets(data, config):
    train, _ = data
    coord = RandomEffectCoordinate("perUser", train, config.coordinates["perUser"],
                                   "logistic_regression", device="cpu",
                                   dtype=torch.float64, seed=11)
    model, res = coord.update(coord.initial_model(),
                              torch.zeros(train.num_rows, dtype=torch.float64))
    assert len(coord.last_buckets) == len(coord.red.buckets) > 1
    assert sum(b.shape[0] for b in coord.last_buckets) == coord.red.num_entities
    assert sum(b.total_iterations for b in coord.last_buckets) == int(res.iterations.sum())
    assert res.x.shape == model.coefficients.shape


def test_warm_start_grid_and_selection(data, config):
    train, val = data
    est = GameEstimator(config, device="cpu", dtype=torch.float64)
    first = est.fit(train, val, ["AUC", "LOGISTIC_LOSS"])
    warm = est.fit(train, val, ["AUC"], initial_model=first.descent.model)
    # a warm start from the final model begins no worse than its objective
    assert warm.objective_history[0] <= first.objective_history[-1] * (1 + 1e-9)
    assert "LOGISTIC_LOSS" in first.validation
    opts = [GLMOptimizationConfig(optimizer=OptimizerConfig(max_iterations=20),
                                  regularization=RegularizationContext(RegularizationType.L2),
                                  regularization_weight=w) for w in (10.0, 1.0)]
    results = est.fit_grid(train, {"perUser": opts}, val, ["AUC"], warm_start=True)
    assert len(results) == 2
    best = select_best_result(results)
    assert best.validation["AUC"] == max(r.validation["AUC"] for r in results)


def test_descent_without_validation_returns_final_model(data, config):
    train, _ = data
    est = GameEstimator(config, device="cpu", dtype=torch.float64)
    coords = est._build_coordinates(train)
    res = run_coordinate_descent(coords, ["fixed", "perUser"], 1, train,
                                 "logistic_regression", device="cpu",
                                 dtype=torch.float64)
    assert res.best_model is res.model and len(res.objective_history) == 2
    assert res.validation_history == {}


def _opt(reg=RegularizationType.L2, **kw):
    return GLMOptimizationConfig(optimizer=OptimizerConfig(**kw),
                                 regularization=RegularizationContext(reg),
                                 regularization_weight=1.0)


# case -> (config change, what the error says): each breaks one of the JAX
# package's rules (ValueError); shard_features=True needs a mesh
UNPORTED = {
    "re_tron": (dict(re=dict(optimization=_opt(RegularizationType.L1,
                                               optimizer=OptimizerType.TRON))),
                "TRON supports only L2"),
    "re_box": (dict(re=dict(optimization=_opt(optimizer=OptimizerType.TRON,
                                              box_lower=(-1.0,) * 19))),
               "box constraints are an LBFGS feature"),
    "fe_shard_features": (dict(fe=dict(shard_features=True)), "shard_features=True but no mesh"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_options_raise_naming_their_item(data, config, case):
    train, val = data
    change, match = UNPORTED[case]
    coords = dict(config.coordinates)
    for key, name in (("fe", "fixed"), ("re", "perUser")):
        if key in change:
            coords[name] = dataclasses.replace(coords[name], **change[key])
    cfg = dataclasses.replace(config, coordinates=coords)
    with pytest.raises(ValueError, match=match):
        GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val)


# options that raised naming their item until that item was ported; they
# now fit (their parity with the JAX package: test_torch_factored.py,
# test_torch_samplers.py)
PORTED = {
    "re_random_projection": dict(re=dict(projector="random_projection:4")),
    "fe_downsampling": dict(fe=dict(optimization=GLMOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20), downsampling_rate=0.5))),
    "factored": dict(mf=FactoredRandomEffectCoordinateConfig(
        "userId", "per_user", latent_dim=2,
        optimization=_opt(max_iterations=10), latent_optimization=_opt(max_iterations=10))),
    "solver_schedule": dict(fe=dict(solver_schedule=SolverSchedule(initial_iterations=2))),
    # parity: test_torch_streaming.py, test_torch_residency.py
    "fe_streamed": dict(fe=dict(memory_mode="streamed")),
}


@pytest.mark.parametrize("case", list(PORTED))
def test_formerly_unported_options_now_fit(data, config, case):
    train, val = data
    change = PORTED[case]
    coords = dict(config.coordinates)
    seq = list(config.updating_sequence)
    for key, name in (("fe", "fixed"), ("re", "perUser")):
        if key in change:
            coords[name] = dataclasses.replace(coords[name], **change[key])
    if "mf" in change:
        coords["mf"] = change["mf"]
        seq.append("mf")
    cfg = dataclasses.replace(config, coordinates=coords, updating_sequence=seq,
                              num_outer_iterations=1)
    fit = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
    assert len(fit.objective_history) == len(seq)
    assert np.all(np.isfinite(fit.objective_history))
    assert 0.5 < fit.validation["AUC"] < 1.0


@pytest.mark.parametrize("what", ["admm_json"])
def test_unported_fit_modes_raise(data, config, what, tmp_path):
    """The ADMM block, refused on load until the lane was ported, loads and
    is consulted only on a mesh with a feature axis: without a mesh the
    fit is the plain one."""
    d = side.glmix_config_dict()
    d["coordinates"]["fixed"]["optimization"]["admm"] = {"rho": 1.0}
    cfg = dataclasses.replace(GameTrainingConfig.from_dict(d), num_outer_iterations=1)
    assert cfg.coordinates["fixed"].optimization.admm.rho == 1.0
    plain = dataclasses.replace(config, num_outer_iterations=1)
    train, _ = data
    fit = lambda c: GameEstimator(c, device="cpu", dtype=torch.float64).fit(train)
    assert fit(cfg).objective_history == fit(plain).objective_history


@pytest.mark.parametrize("what", ["checkpoint_dir", "config_schedule", "hbm_budget"])
def test_formerly_unported_fit_modes_now_run(data, config, what, tmp_path):
    """Fit modes that raised naming their item until it was ported (their
    parity with the JAX package: test_torch_containment.py,
    test_torch_residency.py)."""
    train, val = data
    cfg = dataclasses.replace(config, num_outer_iterations=1)
    kw = {}
    if what == "checkpoint_dir":
        kw["checkpoint_dir"] = str(tmp_path / "ckpt")
    elif what == "hbm_budget":
        # below twice the fixed effect's shard: it streams
        shard = train.feature_shards["global"]
        cfg = dataclasses.replace(cfg, hbm_budget_bytes=int(shard.size * 8 * 1.5))
    else:
        cfg = dataclasses.replace(cfg, solver_schedule=SolverSchedule())
    fit = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"], **kw)
    assert np.all(np.isfinite(fit.objective_history))
    if what == "checkpoint_dir":
        assert os.path.exists(tmp_path / "ckpt" / "state.json")
    elif what == "hbm_budget":
        assert list(fit.residency["streamed_chunk_bytes"]) == ["fixed"]
        assert fit.residency["budget_bytes"] == cfg.hbm_budget_bytes
    else:
        # one outer iteration is the final one: the full budget
        assert fit.descent.solver_diagnostics()["fixed"]["iteration_caps"] == [100]


def test_default_device_is_cuda(config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GameEstimator(config)


def test_evaluators_match_their_definitions():
    """Device AUC == host AUC (ties and weights included), the other
    device metrics == their host forms, and the parsers."""
    rng = np.random.default_rng(0)
    s = np.round(rng.normal(size=500), 1)          # many ties
    y = (rng.uniform(size=500) < 0.3).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=500)
    t = lambda a: torch.from_numpy(a)
    for ww in (None, w):
        host = ev.area_under_roc_curve(s, y, ww)
        dev = ev.device_auc(t(s), t(y), None if ww is None else t(ww)).item()
        assert abs(host - dev) <= 1e-12
        assert abs(ev.RMSE.evaluate_on_device(t(s), t(y), None if ww is None else t(ww)).item()
                   - ev.rmse(s, y, ww)) <= 1e-12
        for name in ("LOGISTIC_LOSS", "SQUARED_LOSS"):
            e = ev.parse_evaluator(name)[0]
            assert abs(e.evaluate_on_device(t(s), t(y), None if ww is None else t(ww)).item()
                       - e(s, y, ww)) <= 1e-12
    assert np.isnan(ev.device_auc(t(s), t(np.zeros(500))).item())
    group = rng.integers(0, 20, size=500)
    m, col = ev.parse_evaluator("AUC:userId")
    assert col == "userId" and m.name == "AUC:userId"
    per = [ev.area_under_roc_curve(s[group == g], y[group == g]) for g in range(20)]
    want = np.mean([v for v in per if np.isfinite(v)])
    assert abs(m.evaluate_grouped(group, s, y) - want) <= 1e-12
    p, col = ev.parse_evaluator("PRECISION@K:5:queryId")
    assert col == "queryId" and p.larger_is_better
    assert ev.precision_at_k(2, np.array([0.1, 0.9, 0.5]), np.array([1.0, 1.0, 0.0])) == 0.5
    assert ev.default_validation_evaluator_for_task("linear_regression") is ev.RMSE
    assert ev.default_evaluator_for_task("poisson_regression") is ev.POISSON_LOSS
    with pytest.raises(ValueError):
        ev.parse_evaluator("NOPE")
