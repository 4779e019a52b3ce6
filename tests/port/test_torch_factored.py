"""Factored random effects (full GAME) in the port == the JAX package's, on
the CPU in float64.

The JAX side runs once for the module in a subprocess (game_jax_side.py
factored).  Pieces: the KroneckerDesign products (matvec, rmatvec,
sq_rmatvec, pad_rows, densify; rtol 1e-12), the Gaussian projection with
and without the intercept row (bit-equal: the port's PRNG copy draws
JAX's numbers), principal_subspace_projection on a full-rank w, with
k > d (fallback rows), an all-zero w and a rank-2 w (the 1e-7 * s[0]
cut): informative rows equal up to sign (singular vectors have no sign),
fallback rows bit-equal; project_blocks (rtol 1e-12), one projection
refit with and without row weights (P and the objective rtol 1e-9, equal
iterations), and a two-round alternation.

Fits: BASELINE config 5's shape cut to make_movielens_like("1m", seed=11,
n_rows=3000), k = 3, cap 32, LBFGS(50), two outer iterations: the
factored coordinate alone ("cold": its Gaussian projection stays), config
5's full sequence ("warm": fixed + perUser + perItem + perUserMF, the
projection taken from perUser's solution at the first visit), down-sampled
("sampled": fixed effect at 0.5, latent refit at 0.7, two inner
iterations) and a random_projection:4 random effect.  Tolerances:
objective histories rtol 1e-9, global coefficients (C.P for the factored
coordinate) and validation scores atol 1e-7, equal iteration counts per
solve.  A JAX factored model's arrays carried across by
convert.game_model_from_numpy score the validation set to rtol 1e-12."""
import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.models.game import (
    FactoredRandomEffectModel, MatrixFactorizationModel, RandomEffectModel,
)
from photon_ml_tpu_torch.ops import features as F
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.parallel import factored as fac
from photon_ml_tpu_torch.parallel.random_effect import EntityBlocks

L2 = RegularizationContext(RegularizationType.L2)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("factored", tmp_path_factory.mktemp("jax") / "factored.npz")


@pytest.fixture(scope="module")
def problem():
    return {k: torch.from_numpy(np.asarray(v)) for k, v in side.kron_problem().items()}


@pytest.fixture(scope="module")
def data():
    return side.movielens_game(build_game_dataset, make_movielens_like, movielens_shards)


@pytest.fixture(scope="module")
def fits(data):
    train, val = data
    return {case: GameEstimator(GameTrainingConfig.from_dict(side.factored_config_dict(case)),
                                device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
            for case in side.FACTORED_CASES}


def _blocks(p):
    return EntityBlocks(x=p["block_x"], labels=p["block_labels"], mask=p["block_mask"],
                        weights=p["block_weights"], offsets=p["block_offsets"])


def test_kronecker_products_match_jax(jax_results, problem):
    p = problem
    kd = F.KroneckerDesign(p["x"], p["factors"])
    assert kd.shape == (50, 18) and kd.ndim == 2 and kd.dtype == torch.float64
    close = lambda got, key: np.testing.assert_allclose(got.numpy(), jax_results[key],
                                                        rtol=1e-12, atol=1e-13)
    close(F.matvec(kd, p["v"]), "kron/matvec")
    close(F.rmatvec(kd, p["u"]), "kron/rmatvec")
    close(F.sq_rmatvec(kd, p["u"]), "kron/sq_rmatvec")
    padded = F.pad_rows(kd, 3)
    close(padded.x, "kron/pad_x")
    close(padded.factors, "kron/pad_factors")
    dense = F.densify(kd)
    close(dense, "kron/densify")
    # the implicit products are the dense design's
    np.testing.assert_allclose(F.matvec(kd, p["v"]).numpy(), (dense @ p["v"]).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(F.rmatvec(kd, p["u"]).numpy(), (dense.T @ p["u"]).numpy(),
                               rtol=1e-12)
    assert F.as_feature_matrix(kd, "cpu") is not None
    assert F.pad_rows(kd, 0) is kd


def test_kronecker_design_takes_the_torch_op_path(problem, monkeypatch):
    """A KroneckerDesign never reaches the fused dense kernel, even where
    its tensors are on the card and there is no mask."""
    from photon_ml_tpu_torch.ops import aggregators, hopper_kernels
    p = problem
    kd = F.KroneckerDesign(p["x"], p["factors"])
    monkeypatch.setattr(F.KroneckerDesign, "is_cuda", property(lambda self: True))

    def refuse(*a, **k):
        raise AssertionError("the fused kernel was called")
    monkeypatch.setattr(hopper_kernels, "fused_value_and_gradient", refuse)
    y = (p["u"] > 0).to(torch.float64)
    v, g = aggregators.value_and_gradient(LOGISTIC, kd, y, p["v"])
    dense = F.densify(kd)
    monkeypatch.undo()
    v2, g2 = aggregators.value_and_gradient(LOGISTIC, dense, y, p["v"])
    np.testing.assert_allclose([v.item()], [v2.item()], rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=1e-12)


@pytest.mark.parametrize("keep", [False, True])
def test_gaussian_projection_is_bit_equal(jax_results, keep):
    for k, d, seed in ((3, 6, 7), (8, 21, 13), (5, 2, 0)):
        got = fac.gaussian_projection_matrix(k, d, keep_intercept=keep, seed=seed,
                                             dtype=torch.float64, device="cpu")
        want = jax_results[f"gauss/{keep}/{k}/{d}/{seed}"]
        assert got.shape == ((k + 1) if keep else k, d)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["full", "k_above_d", "zero", "rank2"])
def test_principal_subspace_projection(jax_results, problem, name):
    p = problem
    fallback = fac.gaussian_projection_matrix(8 if name == "k_above_d" else 3, 6,
                                              seed=2 if name == "k_above_d" else 1,
                                              dtype=torch.float64, device="cpu")
    w = {"full": p["w"], "k_above_d": p["w"], "zero": torch.zeros_like(p["w"]),
         "rank2": p["w_rank2"]}[name]
    got = fac.principal_subspace_projection(w, fallback).numpy()
    want = jax_results[f"pss/{name}"]
    s = np.linalg.svd(w.numpy(), compute_uv=False)
    informative = {"full": 3, "k_above_d": 6, "zero": 0, "rank2": 2}[name]
    for i in range(got.shape[0]):
        if i < informative:
            assert s[i] > 1e-7 * s[0]
            err = min(np.abs(got[i] - want[i]).max(), np.abs(got[i] + want[i]).max())
            assert err <= 1e-12, (i, err)
        else:
            np.testing.assert_array_equal(got[i], fallback[i].numpy())
            np.testing.assert_array_equal(got[i], want[i])


def test_project_blocks(jax_results, problem):
    got = fac.project_blocks(_blocks(problem), problem["projection"]).x.numpy()
    np.testing.assert_allclose(got, jax_results["project/x"], rtol=1e-12, atol=1e-14)
    assert (got[problem["block_mask"].numpy() == 0] == 0).all()


@pytest.mark.parametrize("rows", [False, True])
def test_refit_latent_projection(jax_results, problem, rows):
    rw = (None if not rows else torch.from_numpy(
        np.random.default_rng(9).uniform(size=problem["block_mask"].numel())))
    P, res = fac.refit_latent_projection(
        _blocks(problem), problem["latent"], problem["projection"], LOGISTIC, None,
        OptimizerConfig(max_iterations=30), L2, 1.0, row_weights=rw)
    j = lambda k: jax_results[f"refit/{rows}/{k}"]
    np.testing.assert_allclose(P.numpy(), j("P"), rtol=1e-9, atol=1e-12)
    assert res.iterations == int(j("iterations")) and res.fg_count == int(j("fg_count"))
    np.testing.assert_allclose(res.loss_history[:res.iterations + 1].numpy(),
                               j("loss_history")[:res.iterations + 1], rtol=1e-9)


def test_alternation_matches_jax(jax_results, problem):
    res = fac.fit_factored_random_effects(
        _blocks(problem), LOGISTIC, None,
        latent_coefficients=torch.zeros_like(problem["latent"]),
        projection=problem["projection"], num_inner_iterations=2,
        re_config=OptimizerConfig(max_iterations=30), re_reg=L2, re_reg_weight=1.0,
        latent_config=OptimizerConfig(max_iterations=30), latent_reg=L2,
        latent_reg_weight=1.0)
    np.testing.assert_allclose((res.latent_coefficients @ res.projection).numpy(),
                               jax_results["alternation/C"] @ jax_results["alternation/P"],
                               rtol=0, atol=1e-9)
    assert len(res.inner) == 2 and all(r["re_rounds"] >= 1 for r in res.inner)


@pytest.mark.parametrize("case", side.FACTORED_CASES)
def test_fit_matches_jax(jax_results, fits, data, case):
    fit = fits[case]
    j = lambda k: jax_results[f"{case}/{k}"]
    cfg = side.factored_config_dict(case)
    assert len(fit.objective_history) == len(cfg["updating_sequence"]) * side.ESTIMATOR_OUTER
    np.testing.assert_allclose(fit.objective_history, j("objective_history"), rtol=1e-9)
    np.testing.assert_allclose(fit.descent.validation_history["AUC"], j("auc_history"),
                               rtol=0, atol=1e-9)
    for name, m in fit.descent.model.coordinates.items():
        if isinstance(m, (FactoredRandomEffectModel, RandomEffectModel)):
            np.testing.assert_allclose(m.global_coefficients().numpy(),
                                       j(f"{name}/global_coefficients"), rtol=0, atol=1e-7)
        else:
            np.testing.assert_allclose(m.glm.coefficients.means.numpy(), j(f"{name}/means"),
                                       rtol=0, atol=1e-7)
    np.testing.assert_allclose(fit.descent.model.score_dataset(data[1]).numpy(),
                               j("val_scores"), rtol=0, atol=1e-7)
    for key, t in fit.descent.trackers.items():
        assert t.iterations == int(j(f"iterations/{key}")), key


def test_projections_are_the_jax_draws(jax_results, fits):
    """The random projector's matrix is JAX's draw (drawn in float64, as
    JAX under x64, rounded to float32 as the JAX package rounds it), and
    the cold coordinate's projection starts from JAX's Gaussian draw."""
    rp = fits["random_projection"].descent.model.coordinates["perUser"]
    np.testing.assert_array_equal(rp.projection_matrix.numpy(),
                                  jax_results["random_projection/perUser/projection_matrix"])
    assert rp.coefficients.shape[1] == 5 and rp.projection is None


def test_warm_start_takes_the_sibling_subspace(data, fits):
    """The warm fit's factored coordinate took its projection from
    perUser at its first visit; its initial objective carries the Gaussian
    projection's penalty (the cold fit's first entry is above the pure
    data term of zero scores)."""
    train, _ = data
    warm = fits["warm"]
    cfg = GameTrainingConfig.from_dict(side.factored_config_dict("warm"))
    est = GameEstimator(cfg, device="cpu", dtype=torch.float64)
    coords = est._build_coordinates(train)
    res = run_coordinate_descent(coords, cfg.updating_sequence, 1, train,
                                 cfg.task_type, device="cpu", dtype=torch.float64)
    assert coords["perUserMF"].warm_start_source == "perUser"
    assert warm.descent.warm_starts == res.warm_starts == {"perUserMF": "perUser"}
    assert fits["cold"].descent.warm_starts == {}
    assert len(warm.descent.trackers["1/perUserMF"].inner) == 1
    assert len(fits["sampled"].descent.trackers["1/perUserMF"].inner) == 2
    np.testing.assert_allclose(res.objective_history, warm.objective_history[:4], rtol=1e-12)
    mf = coords["perUserMF"]
    assert len(mf.last_buckets) == 1 and mf.last_buckets[0].shape[2] == side.FACTORED_K
    tracker = res.trackers["0/perUserMF"]
    assert tracker.inner[0]["latent_fg_count"] >= tracker.inner[0]["latent_iterations"]
    assert tracker.fg_count > tracker.iterations > 0
    cold = GameTrainingConfig.from_dict(side.factored_config_dict("cold"))
    cold_coords = GameEstimator(cold, device="cpu", dtype=torch.float64)._build_coordinates(train)
    model = cold_coords["perUserMF"].initial_model()
    penalty = float(cold_coords["perUserMF"].regularization_term(model))
    assert penalty == pytest.approx(0.5 * float((model.projection ** 2).sum()))
    assert cold_coords["perUserMF"].warm_start_latent(model, {}) is None


def _carried(jax_results, case: str) -> dict:
    """The JAX fit's final models as convert.game_model_from_numpy entries."""
    j = lambda k: jax_results[f"{case}/{k}"]
    coords = {}
    for name in side.factored_config_dict(case)["updating_sequence"]:
        if f"{case}/{name}/means" in jax_results:
            coords[name] = {"kind": "fixed_effect", "feature_shard": "global",
                            "means": j(f"{name}/means")}
            continue
        common = {"random_effect_type": "itemId" if name == "perItem" else "userId",
                  "feature_shard": "per_item" if name == "perItem" else "per_user",
                  "entity_ids": j(f"{name}/entity_ids"), "global_dim": j(f"{name}/global_dim")}
        if f"{case}/{name}/latent_coefficients" in jax_results:
            coords[name] = {"kind": "factored_random_effect", **common,
                            "latent_coefficients": j(f"{name}/latent_coefficients"),
                            "projection": j(f"{name}/projection")}
        else:
            get = lambda k: jax_results.get(f"{case}/{name}/{k}")
            coords[name] = {"kind": "random_effect", **common,
                            "coefficients": j(f"{name}/coefficients"),
                            "projection": get("projection"),
                            "projection_matrix": get("projection_matrix")}
    return coords


@pytest.mark.parametrize("case", ["warm", "random_projection"])
def test_jax_model_scores_identically_in_the_port(jax_results, data, case):
    _, val = data
    model = game_model_from_numpy("logistic_regression", _carried(jax_results, case),
                                  device="cpu")
    np.testing.assert_allclose(model.score_dataset(val).numpy(),
                               jax_results[f"{case}/val_scores"], rtol=1e-12, atol=1e-14)
    for name, m in model.coordinates.items():
        if hasattr(m, "global_coefficients"):
            np.testing.assert_allclose(m.global_coefficients().numpy(),
                                       jax_results[f"{case}/{name}/global_coefficients"],
                                       rtol=1e-12, atol=1e-14)
    if case == "warm":
        mf = model.coordinates["perUserMF"]
        np.testing.assert_allclose(mf.to_random_effect_model().score_dataset(val).numpy(),
                                   mf.score_dataset(val).numpy(), rtol=1e-12, atol=1e-14)


def test_matrix_factorization_model(data):
    """rowFactor . colFactor per row, unseen entities score 0; from a
    factored model over a one-hot shard, its scores equal the factored
    model's."""
    _, val = data
    users = np.asarray(val.entity_vocabs["userId"])
    items = np.asarray(val.entity_vocabs["itemId"])
    rng = np.random.default_rng(0)
    rf, cf = rng.normal(size=(len(users) - 3, 2)), rng.normal(size=(len(items), 2))
    mf = game_model_from_numpy("logistic_regression", {"mf": {
        "kind": "matrix_factorization", "row_effect_type": "userId",
        "col_effect_type": "itemId", "row_factors": rf, "row_ids": users[3:],
        "col_factors": cf, "col_ids": items}}, device="cpu").coordinates["mf"]
    assert mf.num_latent_factors == 2 and mf.task_type == "none"
    got = mf.score_dataset(val).numpy()
    u = np.asarray(val.entity_indices["userId"])
    i = np.asarray(val.entity_indices["itemId"])
    want = np.where(u >= 3, np.sum(rf[np.maximum(u - 3, 0)] * cf[i], axis=1), 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    f = FactoredRandomEffectModel("userId", "onehot", "logistic_regression",
                                  torch.from_numpy(rf), torch.from_numpy(cf.T),
                                  users[3:], len(items))
    back = MatrixFactorizationModel.from_factored(f, "itemId", items)
    np.testing.assert_allclose(back.score_dataset(val).numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match="one-hot"):
        MatrixFactorizationModel.from_factored(f, "itemId", items[1:])


def test_factored_config_json_round_trips_across_packages():
    from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
    for case in side.FACTORED_CASES:
        d = side.factored_config_dict(case)
        port = GameTrainingConfig.from_dict(d)
        j = JConfig.from_json(port.to_json())
        assert j.to_dict() == port.to_dict() == d
        assert GameTrainingConfig.from_json(j.to_json()) == port
        mf = port.coordinates.get("perUserMF")
        if mf is not None:
            dc = mf.data_config(11)
            assert dc.projector == "identity" and dc.active_data_upper_bound == side.FACTORED_CAP


def test_kronecker_objective_is_the_dense_objective(problem):
    """The refit's GLM objective over the implicit design, masked and
    weighted, equals the one over the materialized design."""
    p = problem
    n = p["block_mask"].numel()
    E, S, d = p["block_x"].shape
    kd = F.KroneckerDesign(p["block_x"].reshape(n, d),
                           torch.repeat_interleave(p["latent"], S, dim=0))
    kw = dict(weights=p["block_weights"].reshape(n), offsets=p["block_offsets"].reshape(n),
              mask=p["block_mask"].reshape(n), l2_weight=1.0)
    a = GLMObjective(LOGISTIC, kd, p["block_labels"].reshape(n), **kw)
    b = GLMObjective(LOGISTIC, F.densify(kd), p["block_labels"].reshape(n), **kw)
    c = p["projection"].reshape(-1)
    for x, y in zip(a.value_and_gradient(c), b.value_and_gradient(c)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12)
    np.testing.assert_allclose(a.hessian_vector(c, c).numpy(), b.hessian_vector(c, c).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(a.hessian_diagonal(c).numpy(), b.hessian_diagonal(c).numpy(),
                               rtol=1e-12)
