"""Port losses == JAX losses in float64, out to margins of +-700.

Tolerance: rtol 1e-12 (both sides evaluate the same closed forms in f64)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.utils import math as tmath

MARGINS = np.array([-700.0, -20.5, -20.0, -3.0, -1.0, -1e-3, 0.0, 1e-3, 0.5,
                    0.999, 1.0, 3.0, 20.0, 20.5, 700.0])
LABELS = {  # classification labels include the already-±1 form
    "logistic": [0.0, 1.0, -1.0],
    "smoothed_hinge": [0.0, 1.0, -1.0],
    "squared": [0.0, 1.0, 2.5],
    "poisson": [0.0, 1.0, 3.0],
}
NAMES = sorted(TL.BY_NAME)


def _grid(name):
    z, y = np.meshgrid(MARGINS, np.array(LABELS[name]))
    return z.ravel(), y.ravel()


@pytest.mark.parametrize("fn", ["loss", "dz", "d2z"])
@pytest.mark.parametrize("name", NAMES)
def test_pointwise_matches_jax(name, fn):
    z, y = _grid(name)
    want = np.asarray(getattr(JL.BY_NAME[name], fn)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(TL.BY_NAME[name], fn)(torch.tensor(z), torch.tensor(y)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_mean_matches_jax(name):
    want = np.asarray(JL.BY_NAME[name].mean(jnp.asarray(MARGINS)))
    got = TL.BY_NAME[name].mean(torch.tensor(MARGINS)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_loss_tables_match_jax():
    assert sorted(TL.TASK_LOSSES) == sorted(JL.TASK_LOSSES)
    for task, loss in TL.TASK_LOSSES.items():
        jloss = JL.TASK_LOSSES[task]
        assert loss.name == jloss.name
        assert loss.twice_differentiable == jloss.twice_differentiable
        assert loss.d2z_bound == jloss.d2z_bound
    # the CUDA kernel switches on these ids (enum Loss in the source)
    assert {l.name: l.kernel_id for l in TL.BY_NAME.values()} == {
        "logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}


def test_log1p_exp_is_jax_softplus():
    x = np.concatenate([MARGINS, np.linspace(19.0, 22.0, 61)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(tmath.log1p_exp(torch.tensor(x)).numpy(), want,
                               rtol=1e-15, atol=0)


def test_math_helpers_match_jax():
    from photon_ml_tpu.utils import math as jmath
    assert tmath.EPSILON == jmath.EPSILON
    for v in (1, 2, 3, 5, 1024, 1025):
        assert tmath.ceil_pow2(v) == jmath.ceil_pow2(v)
    arr = np.array([1, 3, 9, 100])
    np.testing.assert_array_equal(tmath.ceil_pow2(arr), jmath.ceil_pow2(arr))
    num, den = np.array([1.0, 2.0, 3.0]), np.array([0.0, 4.0, 1e-13])
    np.testing.assert_array_equal(
        tmath.safe_div(torch.tensor(num), torch.tensor(den)).numpy(),
        np.asarray(jmath.safe_div(jnp.asarray(num), jnp.asarray(den))))
