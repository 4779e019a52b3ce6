"""The port's host-numpy GP tier (hyperparameter/kernels.py,
slice_sampler.py, gp.py, search.py) == the JAX package's, bit for bit:
kernel matrices and their diagonals, the parameter round trip,
cholesky_solve, a 50-draw slice-sampler chain, GP predictions (plain and
transformed by each acquisition), expected improvement and confidence
bounds in both evaluator directions, and the candidate sequences of
RandomSearch and GaussianProcessSearch (both acquisitions) on a
deterministic quadratic, with prior observations inside and outside the
search box.  Both packages' modules are numpy only here, so they run in
this process; nothing compiles.
"""
import math

import numpy as np
import pytest

from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.hyperparameter import gp as jgp
from photon_ml_tpu.hyperparameter import kernels as jk
from photon_ml_tpu.hyperparameter import search as jsearch
from photon_ml_tpu.hyperparameter import slice_sampler as jss
from photon_ml_tpu_torch.evaluation import evaluators as tev
from photon_ml_tpu_torch.hyperparameter import gp as tgp
from photon_ml_tpu_torch.hyperparameter import kernels as tk
from photon_ml_tpu_torch.hyperparameter import search as tsearch
from photon_ml_tpu_torch.hyperparameter import slice_sampler as tss

KERNELS = ("RBF", "Matern52")
# one length scale for every dimension, and one per dimension
LENGTH_SCALES = {"scalar": np.asarray([0.7]), "per_dim": np.asarray([0.5, 2.0, 1.3])}


def _points(seed=3, m=7, p=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, p)), rng.normal(size=(5, p))


@pytest.mark.parametrize("scales", list(LENGTH_SCALES))
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matrices_and_diag_are_bit_equal(name, scales):
    x1, x2 = _points()
    ls = LENGTH_SCALES[scales]
    kj, kt = getattr(jk, name)(length_scale=ls), getattr(tk, name)(length_scale=ls)
    np.testing.assert_array_equal(kt(x1), kj(x1))
    np.testing.assert_array_equal(kt(x1, x2), kj(x1, x2))
    np.testing.assert_array_equal(kt.diag(x2), kj.diag(x2))
    np.testing.assert_array_equal(tk._pairwise_sq_dists(x1, x2),
                                  jk._pairwise_sq_dists(x1, x2))


@pytest.mark.parametrize("name", KERNELS)
def test_parameter_round_trip_is_bit_equal(name):
    kj, kt = getattr(jk, name)(), getattr(tk, name)()
    np.testing.assert_array_equal(kt.get_params(), kj.get_params())
    assert kt.get_param_bounds() == kj.get_param_bounds()
    theta = np.asarray([-0.3, 0.2, 1.1])
    np.testing.assert_array_equal(kt.expand_dimensions(kt.get_params(), 3),
                                  kj.expand_dimensions(kj.get_params(), 3))
    np.testing.assert_array_equal(kt.with_params(theta).length_scale,
                                  kj.with_params(theta).length_scale)
    x1, _ = _points()
    np.testing.assert_array_equal(kt.with_params(theta)(x1), kj.with_params(theta)(x1))
    with pytest.raises(ValueError, match="length_scale has 2 dims"):
        tk.RBF(length_scale=np.ones(2))(x1)


def test_cholesky_solve_is_bit_equal():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 6))
    a = a @ a.T + 6 * np.eye(6)
    l = np.linalg.cholesky(a)
    b = rng.normal(size=6)
    np.testing.assert_array_equal(tgp.cholesky_solve(l, b), jgp.cholesky_solve(l, b))
    np.testing.assert_allclose(a @ tgp.cholesky_solve(l, b), b, rtol=1e-12)


def _logp(x):
    """A correlated 2-D Gaussian log density, -inf outside |x| < 4."""
    if np.any(np.abs(x) > 4):
        return -math.inf
    return float(-0.5 * (x[0] ** 2 + (x[1] - 0.5 * x[0]) ** 2 / 0.3))


def test_slice_sampler_chain_is_bit_equal():
    samplers = [mod.SliceSampler(_logp, value_range=(-4.0, 4.0), step_size=0.7, seed=9)
                for mod in (jss, tss)]
    xs = [np.asarray([3.0, -2.0])] * 2
    for _ in range(50):
        xs = [s.draw(x) for s, x in zip(samplers, xs)]
        np.testing.assert_array_equal(xs[1], xs[0])
    # the chain moved, and its rng is where the JAX package's is
    assert not np.array_equal(xs[0], [3.0, -2.0])
    assert samplers[1].rng.random() == samplers[0].rng.random()


def _gp_data(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(8, 2))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] ** 2 + 0.05 * rng.normal(size=8)
    return x, y, rng.uniform(-2, 2, size=(30, 2))


@pytest.mark.parametrize("transform", ["none", "ei_auc", "ei_rmse", "cb_auc", "cb_rmse"])
def test_gp_predictions_are_bit_equal(transform):
    x, y, xq = _gp_data()
    models = []
    for gp, ev, srch in ((jgp, jev, jsearch), (tgp, tev, tsearch)):
        trans = None
        if transform != "none":
            kind, metric = transform.split("_")
            evaluator = getattr(ev, metric.upper())
            trans = (srch.ExpectedImprovement(evaluator, float(np.min(y)))
                     if kind == "ei" else srch.ConfidenceBound(evaluator, 1.5))
        kernel = (jk if gp is jgp else tk).Matern52()
        est = gp.GaussianProcessEstimator(kernel=kernel, normalize_labels=True,
                                          prediction_transformation=trans,
                                          num_burn_in_samples=30, num_samples=30, seed=4)
        models.append(est.fit(x, y))
    (mj, vj), (mt, vt) = models[0].predict(xq), models[1].predict(xq)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(models[1].predict_transformed(xq),
                                  models[0].predict_transformed(xq))
    for a, b in zip(models[1].kernels, models[0].kernels):
        np.testing.assert_array_equal(a.length_scale, b.length_scale)


@pytest.mark.parametrize("metric", ["AUC", "RMSE"])
def test_acquisitions_are_bit_equal_in_both_directions(metric):
    rng = np.random.default_rng(8)
    means, variances = rng.normal(size=20), rng.uniform(0, 2, size=20)
    variances[3] = 0.0
    ej, et = getattr(jev, metric), getattr(tev, metric)
    np.testing.assert_array_equal(
        tsearch.ExpectedImprovement(et, 0.2)(means, variances),
        jsearch.ExpectedImprovement(ej, 0.2)(means, variances))
    np.testing.assert_array_equal(tsearch.ConfidenceBound(et, 2.5)(means, variances),
                                  jsearch.ConfidenceBound(ej, 2.5)(means, variances))
    assert et.better_than(1.0, -1.0) == ej.better_than(1.0, -1.0)


def _quadratic(search_mod):
    class Quad(search_mod.EvaluationFunction):
        """sum((c - 0.3)^2): deterministic, minimized at 0.3."""

        def __init__(self):
            self.seen = []

        def __call__(self, candidate):
            v = float(np.sum((np.asarray(candidate) - 0.3) ** 2))
            self.seen.append(np.asarray(candidate, dtype=float).copy())
            return v, (self.seen[-1], v)

        def vectorize_params(self, observation):
            return observation[0]

        def get_evaluation_value(self, observation):
            return observation[1]

    return Quad()


# prior observations: two in the box, one outside it (dropped with a warning)
PRIORS = [(np.asarray([0.5, -0.5]), 0.44), (np.asarray([5.0, 0.0]), 22.0),
          (np.asarray([-1.0, 1.0]), 2.18)]


@pytest.mark.parametrize("priors", [False, True], ids=["cold", "priors"])
@pytest.mark.parametrize("kind", ["random", "confidence_bound", "expected_improvement"])
def test_search_candidate_sequences_are_bit_equal(kind, priors):
    runs = []
    for srch, ev in ((jsearch, jev), (tsearch, tev)):
        fn = _quadratic(srch)
        if kind == "random":
            search = srch.RandomSearch([(-2.0, 2.0)] * 2, fn, seed=11)
        else:
            search = srch.GaussianProcessSearch([(-2.0, 2.0)] * 2, fn, ev.RMSE,
                                                candidate_pool_size=40,
                                                acquisition=kind, seed=11)
        found = search.find(5, PRIORS if priors else ())
        runs.append((np.asarray(fn.seen), [v for _, v in found]))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    assert runs[1][1] == runs[0][1] and len(runs[0][0]) == 5


def test_search_refusals_match():
    for srch in (jsearch, tsearch):
        with pytest.raises(ValueError, match="at least one parameter range"):
            srch.RandomSearch([], _quadratic(srch))
        with pytest.raises(ValueError, match="greater than zero"):
            srch.RandomSearch([(0.0, 1.0)], _quadratic(srch)).find(0)
        with pytest.raises(ValueError, match="unknown acquisition"):
            srch.GaussianProcessSearch([(0.0, 1.0)], _quadratic(srch), None,
                                       acquisition="ucb")
