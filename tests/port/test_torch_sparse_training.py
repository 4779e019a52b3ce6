"""Port train_glm and GameEstimator.fit on sparse features == the JAX
package's, float64, on the CPU.

- train_glm on make_wide_sparse_logistic(3000, d=20000, nnz=16, seed=5)
  (bench config 6's generator, cut to size): LBFGS with a warm-started
  sweep and variances, on the ELL layout alone (scatter-add gradient, as
  the JAX package below CSC_MIN_COLS) and with scipy's exact column view
  (the segment-sum gradient); LBFGS with a standardization context built
  from the sparse column statistics; TRON.  Tolerances: loss trajectory
  rtol 1e-10, equal iterations and fg_count (LBFGS) or hv_count (TRON),
  coefficients atol 1e-7, variances rtol 1e-8.
- GameEstimator.fit on bench config 7's shape cut to 3,000 rows (a fixed
  effect on a 2,000-column sparse shard, per-user and per-item random
  effects): objective history rtol 1e-8, validation AUC 1e-9 absolute,
  coefficients atol 1e-6, equal iterations per solve.

The JAX side runs once for the module in a subprocess
(game_jax_side.py sparse), so no JAX program compiles in the test process.
"""
import dataclasses

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
from photon_ml_tpu_torch.data.synthetic_bench import (
    make_a1a_like, make_wide_sparse_logistic, make_yahoo_like,
)
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
from photon_ml_tpu_torch.models.training import train_glm
from photon_ml_tpu_torch.ops.features import PaddedSparse
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationType, build_normalization_context,
)
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)

TASK = "logistic_regression"


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("sparse", tmp_path_factory.mktemp("jax") / "sparse.npz")


@pytest.fixture(scope="module")
def problem():
    return side.sparse_problem(make_wide_sparse_logistic)


def _train(x, y, case):
    opt, lams, norm_name, csc, variances = side.SPARSE_CASES[case]
    xs = PaddedSparse.from_scipy(x, with_csc=True, device="cpu") if csc else x
    norm = None
    if norm_name is not None:
        s = BasicStatisticalSummary.from_sparse(x)
        norm = build_normalization_context(
            norm_name, mean=torch.from_numpy(s.mean), variance=torch.from_numpy(s.variance),
            intercept_index=side.SPARSE_D - 1)
    opt = dict(opt)
    if "optimizer" in opt:
        opt["optimizer"] = OptimizerType(opt["optimizer"])
    return train_glm(xs, y, TASK, optimizer_config=OptimizerConfig(**opt),
                     regularization=RegularizationContext(RegularizationType.L2),
                     regularization_weights=lams, normalization=norm,
                     compute_variances=variances, device="cpu")


@pytest.fixture(scope="module")
def trained(problem):
    x, y = problem
    return {case: _train(x, y, case) for case in side.SPARSE_CASES}


@pytest.mark.parametrize("case", list(side.SPARSE_CASES))
def test_train_glm_matches_jax(jax_results, trained, case):
    tron = case == "tron"
    for i, t in enumerate(trained[case]):
        j = lambda f: jax_results[f"{case}/{i}/{f}"]
        r = t.result
        assert r.iterations == int(j("iterations")) > 0
        assert int(r.reason) == int(j("reason"))
        if tron:
            assert r.fg_count is None and r.hv_count == int(j("hv_count")) > 0
        else:
            assert r.fg_count == int(j("fg_count"))
            n = r.iterations + 1
            np.testing.assert_allclose(r.loss_history[:n].numpy(), j("loss_history")[:n],
                                       rtol=1e-10)
        np.testing.assert_allclose(r.value.item(), float(j("value")), rtol=1e-10)
        np.testing.assert_allclose(t.model.coefficients.means.numpy(), j("means"),
                                   rtol=0, atol=1e-7)
        if side.SPARSE_CASES[case][4]:
            np.testing.assert_allclose(t.model.coefficients.variances.numpy(),
                                       j("variances"), rtol=1e-8)


def test_sparse_input_keeps_its_layout(problem):
    """Below CSC_MIN_COLS on the CPU, train_glm keeps the ELL layout alone
    (the JAX package's scatter-add path); a matrix with its column view
    keeps it."""
    from photon_ml_tpu_torch.ops.features import CSC_MIN_COLS, as_feature_matrix
    x, _ = problem
    assert x.shape[1] < CSC_MIN_COLS
    assert not as_feature_matrix(x, "cpu", torch.float64, with_csc=True).has_csc
    xs = PaddedSparse.from_scipy(x, with_csc=True, device="cpu")
    assert as_feature_matrix(xs, "cpu", torch.float64, with_csc=True).has_csc


def test_dense_input_as_padded_sparse_matches_the_dense_path():
    """The same problem through the dense products and through ELL (with
    and without the column view): coefficients within 1e-10, the same
    iterations."""
    x, y = make_a1a_like(1, seed=42)
    x, y = x[:2000].astype(np.float64), y[:2000].astype(np.float64)
    kw = dict(optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-9),
              regularization=RegularizationContext(RegularizationType.L2),
              regularization_weights=(1.0,), compute_variances=True, device="cpu")
    dense = train_glm(x, y, TASK, **kw)[0]
    ell = PaddedSparse.from_dense(x, device="cpu")
    for xs in (ell, ell.with_csc()):
        sparse = train_glm(xs, y, TASK, **kw)[0]
        assert sparse.result.iterations == dense.result.iterations
        np.testing.assert_allclose(sparse.model.coefficients.means.numpy(),
                                   dense.model.coefficients.means.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(sparse.model.coefficients.variances.numpy(),
                                   dense.model.coefficients.variances.numpy(), rtol=1e-10)


# --------------------------------------------------------------- GAME, config 7

@pytest.fixture(scope="module")
def yahoo_data():
    return side.yahoo_glmix(build_game_dataset, make_yahoo_like)


@pytest.fixture(scope="module")
def yahoo_fit(yahoo_data):
    train, val = yahoo_data
    cfg = GameTrainingConfig.from_dict(side.yahoo_config_dict())
    return GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])


def test_yahoo_shard_is_sparse(yahoo_data):
    train, _ = yahoo_data
    x = train.device_shard("global", "cpu", torch.float64)
    assert isinstance(x, PaddedSparse) and x.shape == (train.num_rows, side.YAHOO_D)


def test_yahoo_objective_history_matches_jax(jax_results, yahoo_fit):
    want = jax_results["yahoo/objective_history"]
    assert len(yahoo_fit.objective_history) == len(want) == 6
    np.testing.assert_allclose(yahoo_fit.objective_history, want, rtol=1e-8)


def test_yahoo_validation_auc_matches_jax(jax_results, yahoo_fit):
    np.testing.assert_allclose(yahoo_fit.descent.validation_history["AUC"],
                               jax_results["yahoo/auc_history"], rtol=0, atol=1e-9)
    assert abs(yahoo_fit.validation["AUC"] - float(jax_results["yahoo/auc"])) <= 1e-9


def test_yahoo_coefficients_and_iterations_match_jax(jax_results, yahoo_fit, yahoo_data):
    m = yahoo_fit.descent.model.coordinates
    j = lambda k: jax_results[f"yahoo/{k}"]
    np.testing.assert_allclose(m["fixed"].glm.coefficients.means.numpy(), j("fixed/means"),
                               rtol=0, atol=1e-6)
    for name in ("perUser", "perItem"):
        np.testing.assert_allclose(m[name].coefficients.numpy(), j(f"{name}/coefficients"),
                                   rtol=0, atol=1e-6)
    for key, t in yahoo_fit.descent.trackers.items():
        assert t.iterations == int(j(f"iterations/{key}")), key
    np.testing.assert_allclose(yahoo_fit.descent.model.score_dataset(yahoo_data[1]).numpy(),
                               j("val_scores"), rtol=0, atol=1e-6)


def test_sparse_fixed_effect_refuses_normalization(yahoo_data):
    """The JAX package's error, at the same point (coordinate setup)."""
    train, _ = yahoo_data
    cfg = GameTrainingConfig.from_dict(side.yahoo_config_dict())
    fe = dataclasses.replace(cfg.coordinates["fixed"],
                             normalization=NormalizationType.STANDARDIZATION)
    with pytest.raises(ValueError, match="use normalization=NONE for sparse/wide"):
        FixedEffectCoordinate("fixed", train, fe, TASK, device="cpu", dtype=torch.float64)


def test_sparse_random_effect_shard_raises(yahoo_data):
    """Random-effect shards stay dense only: the JAX package's TypeError."""
    train, val = yahoo_data
    d = side.yahoo_config_dict()
    d["coordinates"]["perUser"]["feature_shard"] = "global"
    cfg = GameTrainingConfig.from_dict(d)
    with pytest.raises(TypeError, match="must be a dense array"):
        GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
