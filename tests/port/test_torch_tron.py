"""Port TRON == the JAX package's jitted tron, and train_glm with TRON ==
the JAX package's, in float64 on the CPU.

The JAX side runs once for the module in a subprocess (game_jax_side.py
tron), so its XLA programs never compile in the test process.  Problems:
[400 x 12] per loss (logistic, squared, poisson): plain; with weights,
offsets and standardization; with weights, offsets and a row mask; scaled
without a shift; and with at most 2 CG steps; L2 0.5, TRON(15, tol 1e-8)
from zero.  And train_glm on make_a1a_like(2, task, seed=42) [3210 x 124],
logistic and poisson, raw and standardized, L2 lambdas (10, 1)
warm-started, TRON at its defaults.  Equal: iterations, reason, hv_count.
Loss history within rtol 1e-10, x within rtol 1e-9 (the same arithmetic in
float64, in another summation order)."""
import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
from photon_ml_tpu_torch.models.training import train_glm
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.normalization import build_normalization_context
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType, solve,
)
from photon_ml_tpu_torch.optim.tron import tron
from photon_ml_tpu_torch.optim.types import ConvergenceReason

TRON_CFG = OptimizerConfig(optimizer=OptimizerType.TRON)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("tron", tmp_path_factory.mktemp("jax") / "tron.npz")


def _objective(case, l2=side.TRON_L2):
    p = {k: torch.from_numpy(v) for k, v in side.tron_problem(case).items()}
    variant = case.split("_")[1]
    norm = (None if variant not in side.TRON_NORMS else build_normalization_context(
        side.TRON_NORMS[variant], mean=p["mean"], variance=p["variance"],
        intercept_index=side.TRON_D - 1))
    return GLMObjective(TL.BY_NAME[case.split("_")[0]], p["x"], p["labels"],
                        weights=p.get("weights"), offsets=p.get("offsets"),
                        mask=p.get("mask"), norm=norm, l2_weight=l2)


def _tron(obj, **kw):
    return tron(obj.value_and_gradient, obj.hessian_vector_at,
                torch.zeros(side.TRON_D, dtype=torch.float64),
                max_iterations=side.TRON_MAX_ITERATIONS,
                tolerance=side.TRON_TOLERANCE, **kw)


@pytest.mark.parametrize("case", side.TRON_CASES)
def test_trajectory_matches_jax(jax_results, case):
    j = {f: jax_results[f"{case}/{f}"] for f in
         ("x", "iterations", "hv_count", "reason", "loss_history")}
    r = _tron(_objective(case), **side.tron_solve_options(case))
    it = int(j["iterations"])
    assert r.iterations == it > 1
    assert r.reason == int(j["reason"])
    assert r.hv_count == int(j["hv_count"]) > it
    assert r.fg_count is None
    np.testing.assert_allclose(r.loss_history.numpy(), j["loss_history"],
                               rtol=1e-10, equal_nan=True)
    np.testing.assert_allclose(r.x.numpy(), j["x"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", side.TRON_CASES)
def test_hessian_vector_at_is_hessian_vector(case):
    """The closure at c gives the same products, bit for bit, as
    hessian_vector(c, v): the margins are only computed once."""
    obj = _objective(case)
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.normal(size=side.TRON_D) * 0.1)
    at = obj.hessian_vector_at(c)
    for _ in range(3):
        v = torch.from_numpy(rng.normal(size=side.TRON_D))
        assert torch.equal(at(v), obj.hessian_vector(c, v))


def test_track_coefficients_and_limits():
    obj = _objective("logistic_plain")
    r = tron(obj.value_and_gradient, obj.hessian_vector_at,
             torch.zeros(side.TRON_D, dtype=torch.float64), max_iterations=2,
             tolerance=1e-14, track_coefficients=True)
    assert r.iterations == 2 and r.reason == ConvergenceReason.MAX_ITERATIONS
    hist = r.coefficient_history.numpy()
    assert hist.shape == (3, side.TRON_D)
    np.testing.assert_array_equal(hist[2], r.x.numpy())
    np.testing.assert_array_equal(hist[0], np.zeros(side.TRON_D))
    # one CG step per outer step: every step ends on the cap or the boundary
    one = _tron(obj, max_cg_iterations=1)
    assert one.hv_count == one.iterations
    # a start at the optimum converges before any step
    again = tron(obj.value_and_gradient, obj.hessian_vector_at, _tron(obj).x)
    assert again.iterations == 0 and again.hv_count == 0
    assert again.reason == ConvergenceReason.GRADIENT_CONVERGED


def test_start_point_is_not_written():
    obj = _objective("squared_plain")
    x0 = torch.full((side.TRON_D,), 0.01, dtype=torch.float64)
    keep = x0.clone()
    tron(obj.value_and_gradient, obj.hessian_vector_at, x0)
    assert torch.equal(x0, keep)


@pytest.mark.parametrize("rule,match", [
    ("l1", "only L2"), ("elastic_net", "only L2"), ("smoothed_hinge", "twice"),
    ("box", "box constraints")])
def test_solve_refuses_what_tron_does_not_take(rule, match):
    """The JAX package's ValueError rules for TRON in solve."""
    obj = _objective("logistic_plain")
    cfg, reg = TRON_CFG, RegularizationContext(RegularizationType.L2)
    if rule == "l1":
        reg = RegularizationContext(RegularizationType.L1)
    elif rule == "elastic_net":
        reg = RegularizationContext(RegularizationType.ELASTIC_NET, 0.5)
    elif rule == "smoothed_hinge":
        obj = obj.replace(loss=TL.SMOOTHED_HINGE)
    else:
        cfg = OptimizerConfig(optimizer=OptimizerType.TRON,
                              box_lower=(-1.0,) * side.TRON_D)
    with pytest.raises(ValueError, match=match):
        solve(obj, torch.zeros(side.TRON_D, dtype=torch.float64), cfg, reg, 1.0)


def test_solve_dispatches_tron_with_its_defaults():
    """solve puts lambda into the objective's L2 term and runs tron at its
    defaults (15 iterations, tolerance 1e-5, 20 CG steps)."""
    x0 = torch.zeros(side.TRON_D, dtype=torch.float64)
    r = solve(_objective("squared_wos", l2=0.0), x0, TRON_CFG,
              RegularizationContext(RegularizationType.L2), side.TRON_L2)
    obj = _objective("squared_wos")
    want = tron(obj.value_and_gradient, obj.hessian_vector_at, x0)
    assert r.fg_count is None
    assert (r.iterations, r.hv_count, r.reason) == (
        want.iterations, want.hv_count, want.reason)
    assert torch.equal(r.x, want.x)


@pytest.mark.parametrize("task,norm", side.TRAIN_CASES,
                         ids=[f"{t}-{n}" for t, n in side.TRAIN_CASES])
def test_train_glm_with_tron_matches_jax(jax_results, task, norm):
    x, y = make_a1a_like(2, side.TRAIN_TASKS[task], seed=42)
    x = x.astype(np.float64)
    ctx = (None if norm == "raw" else build_normalization_context(
        norm, mean=torch.from_numpy(x.mean(axis=0)),
        variance=torch.from_numpy(x.var(axis=0)), intercept_index=x.shape[1] - 1))
    trained = train_glm(x, y.astype(np.float64), task, optimizer_config=TRON_CFG,
                        regularization=RegularizationContext(RegularizationType.L2),
                        regularization_weights=side.TRAIN_LAMBDAS, normalization=ctx,
                        device="cpu")
    assert [t.reg_weight for t in trained] == sorted(side.TRAIN_LAMBDAS, reverse=True)
    for i, t in enumerate(trained):
        key = f"train/{task}/{norm}/{i}"
        assert t.result.iterations == int(jax_results[f"{key}/iterations"])
        assert t.result.hv_count == int(jax_results[f"{key}/hv_count"])
        assert t.result.reason == int(jax_results[f"{key}/reason"])
        np.testing.assert_allclose(t.result.value.item(),
                                   float(jax_results[f"{key}/value"]), rtol=1e-10)
        np.testing.assert_allclose(t.model.coefficients.means.numpy(),
                                   jax_results[f"{key}/means"], rtol=1e-9, atol=1e-12)
