"""Port train_glm == JAX train_glm on the a1a-shaped data, float64, on CPU.

Data: make_a1a_like(4, seed=42), [6420 x 124].  Tolerances: coefficients
atol 1e-7, objective value rtol 1e-10, equal iteration counts (the same
LBFGS in f64; only summation order differs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.synthetic_bench import make_a1a_like
from photon_ml_tpu.models.glm import model_for_task as jmodel_for_task
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.training import train_glm as jtrain
from photon_ml_tpu.ops.normalization import build_normalization_context as jbuild
from photon_ml_tpu.optim import OptimizerConfig as JOC
from photon_ml_tpu.optim import RegularizationContext as JRC
from photon_ml_tpu.optim import RegularizationType as JRT
from photon_ml_tpu_torch.convert import glm_from_numpy, normalization_from_numpy
from photon_ml_tpu_torch.models.training import best_model_by_validation
from photon_ml_tpu_torch.models.training import train_glm as ttrain
from photon_ml_tpu_torch.ops.normalization import build_normalization_context as tbuild
from photon_ml_tpu_torch.optim.config import OptimizerConfig as TOC
from photon_ml_tpu_torch.optim.config import OptimizerType as TOT
from photon_ml_tpu_torch.optim.config import RegularizationContext as TRC
from photon_ml_tpu_torch.optim.config import RegularizationType as TRT

TASK = "logistic_regression"
ICPT = 123


@pytest.fixture(scope="module")
def data():
    x, y = make_a1a_like(4, seed=42)
    return x.astype(np.float64), y.astype(np.float64)


def _std_contexts(x):
    mean, var = x.mean(axis=0), x.var(axis=0)
    j = jbuild("standardization", mean=jnp.asarray(mean), variance=jnp.asarray(var),
               intercept_index=ICPT)
    t = normalization_from_numpy(np.asarray(j.factors), np.asarray(j.shifts), ICPT,
                                 device="cpu")
    built = tbuild("standardization", mean=torch.from_numpy(mean),
                   variance=torch.from_numpy(var), intercept_index=ICPT)
    np.testing.assert_allclose(built.factors.numpy(), np.asarray(j.factors), rtol=1e-15)
    np.testing.assert_allclose(built.shifts.numpy(), np.asarray(j.shifts), rtol=1e-15)
    return j, t


def _train_both(x, y, lams, norm=None, variances=False):
    cfg = dict(max_iterations=100, tolerance=1e-9)
    jn, tn = _std_contexts(x) if norm else (None, None)
    jr = jtrain(jnp.asarray(x), jnp.asarray(y), TASK, optimizer_config=JOC(**cfg),
                regularization=JRC(JRT.L2), regularization_weights=lams,
                normalization=jn, compute_variances=variances)
    tr = ttrain(x, y, TASK, optimizer_config=TOC(**cfg),
                regularization=TRC(TRT.L2), regularization_weights=lams,
                normalization=tn, compute_variances=variances, device="cpu")
    return jr, tr


def _assert_same(jr, tr):
    assert [t.reg_weight for t in tr] == [j.reg_weight for j in jr]
    for j, t in zip(jr, tr):
        assert t.result.iterations == int(j.result.iterations)
        assert t.result.fg_count == int(j.result.fg_count)
        np.testing.assert_allclose(t.result.value.item(), float(j.result.value),
                                   rtol=1e-10)
        np.testing.assert_allclose(t.model.coefficients.means.numpy(),
                                   np.asarray(j.model.coefficients.means),
                                   rtol=0, atol=1e-7)
        assert type(t.model).__name__ == type(j.model).__name__
        assert t.wall_s > 0


@pytest.mark.parametrize("lams,norm", [((1.0,), False), ((1.0, 10.0), False),
                                       ((1.0,), True)],
                         ids=["single", "warm-sweep", "standardization"])
def test_train_glm_matches_jax(data, lams, norm):
    _assert_same(*_train_both(*data, lams, norm=norm))


def test_variances_match_jax(data):
    jr, tr = _train_both(*data, (1.0,), variances=True)
    np.testing.assert_allclose(tr[0].model.coefficients.variances.numpy(),
                               np.asarray(jr[0].model.coefficients.variances),
                               rtol=1e-9)


def test_converted_model_scores_like_jax(data):
    x, y = data
    jr = jtrain(jnp.asarray(x), jnp.asarray(y), TASK,
                regularization=JRC(JRT.L2), regularization_weights=(1.0,))
    jm = jr[0].model
    tm = glm_from_numpy(TASK, np.asarray(jm.coefficients.means), device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tm.compute_score(xt).numpy(),
                               np.asarray(jm.compute_score(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.predict(xt).numpy(),
                               np.asarray(jm.predict(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_array_equal(tm.predict_class(xt).numpy(),
                                  np.asarray(jm.predict_class(jnp.asarray(x))))


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "standardization"])
def test_warm_start_from_jax_model_leaves_it_unmutated(data, norm):
    x, y = data
    _, tn = _std_contexts(x) if norm else (None, None)
    rng = np.random.default_rng(5)
    means = rng.normal(size=x.shape[1]) * 0.1
    jm = jmodel_for_task(TASK, JCoefficients(jnp.asarray(means)))
    tm = glm_from_numpy(TASK, np.asarray(jm.coefficients.means), device="cpu")
    keep = tm.coefficients.means.clone()
    tr = ttrain(x, y, TASK, regularization=TRC(TRT.L2),
                regularization_weights=(1.0, 3.0), normalization=tn,
                initial_model=tm, device="cpu")
    assert torch.equal(tm.coefficients.means, keep)
    assert all(t.result.iterations > 0 for t in tr)
    # a solve started from the JAX solution converges at once
    jr = jtrain(jnp.asarray(x), jnp.asarray(y), TASK, regularization=JRC(JRT.L2),
                regularization_weights=(1.0,),
                optimizer_config=JOC(max_iterations=100, tolerance=1e-9))
    warm = glm_from_numpy(TASK, np.asarray(jr[0].model.coefficients.means),
                          device="cpu")
    cold = ttrain(x, y, TASK, regularization=TRC(TRT.L2), regularization_weights=(1.0,),
                  optimizer_config=TOC(max_iterations=100, tolerance=1e-9),
                  device="cpu")
    hot = ttrain(x, y, TASK, regularization=TRC(TRT.L2), regularization_weights=(1.0,),
                 optimizer_config=TOC(max_iterations=100, tolerance=1e-9),
                 initial_model=warm, device="cpu")
    assert hot[0].result.iterations < cold[0].result.iterations


def test_train_glm_without_device_needs_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None trains on it")
    x, y = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain(x[:50], y[:50], TASK)


def test_unported_options_raise(data):
    x, y = data
    # TRON is ported; under L1 it breaks the JAX package's rule
    with pytest.raises(ValueError, match="TRON supports only L2"):
        ttrain(x[:50], y[:50], TASK, optimizer_config=TOC(optimizer=TOT.TRON),
               regularization=TRC(TRT.L1), regularization_weights=(1.0,),
               device="cpu")
    # named constraints are ported; without the shard's index map they
    # cannot resolve
    with pytest.raises(ValueError, match="named feature constraints require"):
        ttrain(x[:50], y[:50], TASK, device="cpu",
               optimizer_config=TOC(constraints=({"name": "a", "term": "",
                                                  "lowerBound": 0.0},)))
    # scipy.sparse input is ported (tests/port/test_torch_sparse_training.py),
    # and so are torch's sparse COO/CSR layouts (the JAX package's BCOO;
    # tests/port/test_torch_bcoo.py): ingested as a PaddedSparse, the fit
    # is the dense fit's; other sparse layouts raise TypeError
    coo = torch.from_numpy(x[:50]).to_sparse()
    sparse_fit = ttrain(coo, y[:50], TASK, device="cpu")[0]
    dense_fit = ttrain(x[:50], y[:50], TASK, device="cpu")[0]
    assert sparse_fit.result.iterations == dense_fit.result.iterations
    np.testing.assert_allclose(sparse_fit.model.coefficients.means.numpy(),
                               dense_fit.model.coefficients.means.numpy(),
                               rtol=1e-9, atol=1e-10)
    with pytest.raises(TypeError, match="sparse_coo or torch.sparse_csr"):
        ttrain(torch.from_numpy(x[:50]).to_sparse_csc(), y[:50], TASK, device="cpu")


def test_best_model_by_validation(data):
    x, y = data
    tr = ttrain(x, y, TASK, regularization=TRC(TRT.L2),
                regularization_weights=(0.1, 100.0), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    acc = lambda m: float((m.predict_class(xt) == yt).double().mean())
    best = best_model_by_validation(tr, acc)
    assert acc(best.model) == max(acc(t.model) for t in tr)
