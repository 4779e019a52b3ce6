"""Port LBFGS/OWLQN == JAX lbfgs on the same float64 objective.

The port is host-stepped, the JAX solver one lax.while_loop; both follow the
same rules, so iterations, reason and fg_count must be equal and the loss
history must agree to 1e-9 relative (f64 rounding through the trajectory)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.optim.lbfgs import lbfgs as jlbfgs
from photon_ml_tpu.optim.lbfgs import owlqn as jowlqn
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.optim.lbfgs import lbfgs as tlbfgs
from photon_ml_tpu_torch.optim.lbfgs import owlqn as towlqn
from photon_ml_tpu_torch.optim.types import ConvergenceReason

N, D = 500, 16


def _problem(name, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    x[:, -1] = 1.0
    w_true = rng.normal(size=D)
    z = x @ w_true
    if name == "logistic":
        y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = z + rng.normal(size=N)
    j = JObjective(JL.BY_NAME[name], jnp.asarray(x), jnp.asarray(y), l2_weight=0.5)
    t = TObjective(TL.BY_NAME[name], torch.from_numpy(x), torch.from_numpy(y),
                   l2_weight=0.5)
    return j, t


def _run(case, j, t):
    kw = dict(max_iterations=100, tolerance=1e-7)
    x0 = np.zeros(D)
    if case == "plain":
        return (jlbfgs(j.value_and_gradient, jnp.asarray(x0), **kw),
                tlbfgs(t.value_and_gradient, torch.from_numpy(x0), **kw))
    if case == "owlqn":
        l1 = np.full(D, 60.0)
        l1[-1] = 0.0  # exempt the intercept
        return (jowlqn(j.value_and_gradient, jnp.asarray(x0),
                       l1_weight=jnp.asarray(l1), **kw),
                towlqn(t.value_and_gradient, torch.from_numpy(x0),
                       l1_weight=torch.from_numpy(l1), **kw))
    lo, hi = np.full(D, -0.3), np.full(D, 0.3)
    return (jlbfgs(j.value_and_gradient, jnp.asarray(x0), lower=jnp.asarray(lo),
                   upper=jnp.asarray(hi), **kw),
            tlbfgs(t.value_and_gradient, torch.from_numpy(x0),
                   lower=torch.from_numpy(lo), upper=torch.from_numpy(hi), **kw))


@pytest.mark.parametrize("case", ["plain", "owlqn", "box"])
@pytest.mark.parametrize("name", ["logistic", "squared"])
def test_trajectory_matches_jax(name, case):
    jr, tr = _run(case, *_problem(name))
    it = int(jr.iterations)
    assert tr.iterations == it > 1
    assert tr.reason == int(jr.reason)
    assert tr.fg_count == int(jr.fg_count)
    np.testing.assert_allclose(tr.loss_history.numpy()[:it + 1],
                               np.asarray(jr.loss_history)[:it + 1], rtol=1e-9)
    assert np.isnan(tr.loss_history.numpy()[it + 1:]).all()
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-6, atol=1e-8)
    if case == "owlqn":
        assert (tr.x.numpy()[:-1] == 0).any()  # L1 produced exact zeros
    if case == "box":
        assert np.all(np.abs(tr.x.numpy()) <= 0.3)


def test_track_coefficients_and_max_iterations():
    _, t = _problem("logistic")
    r = tlbfgs(t.value_and_gradient, torch.zeros(D, dtype=torch.float64),
               max_iterations=4, track_coefficients=True)
    assert r.iterations == 4 and r.reason == ConvergenceReason.MAX_ITERATIONS
    hist = r.coefficient_history.numpy()
    assert hist.shape == (5, D)
    np.testing.assert_array_equal(hist[4], r.x.numpy())
    np.testing.assert_array_equal(hist[0], np.zeros(D))
    assert "converged after 4 iterations: MAX_ITERATIONS" in r.summary()


def test_box_and_l1_are_exclusive():
    _, t = _problem("squared")
    with pytest.raises(ValueError, match="cannot be combined"):
        tlbfgs(t.value_and_gradient, torch.zeros(D, dtype=torch.float64),
               l1_weight=1.0, lower=torch.zeros(D, dtype=torch.float64))


def test_start_point_is_not_written():
    _, t = _problem("logistic")
    x0 = torch.full((D,), 0.01, dtype=torch.float64)
    keep = x0.clone()
    tlbfgs(t.value_and_gradient, x0)
    assert torch.equal(x0, keep)
