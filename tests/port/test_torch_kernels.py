"""The fused value+gradient kernel's plain version == the JAX package's
Pallas kernel and XLA aggregator.

- f32 against the Pallas kernel in interpret mode, at the Pallas test's
  unaligned n=700, d=37 and its tolerances (value rtol 1e-5, gradient rtol
  and atol 1e-4: both sides sum in f32 in different orders);
- f64 against both aggregators at rtol 1e-12 (same arithmetic in f64).
The CUDA kernel itself runs only on the card (test_torch_cuda.py and
chip_smoke.py); here the wrapper must take the plain version for CPU
tensors and launch nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import aggregators as jagg
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.pallas_kernels import fused_value_and_gradient as pallas_fvg
from photon_ml_tpu_torch.ops import aggregators as tagg
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL

NAMES = sorted(TL.BY_NAME)


def _inputs(with_wo, dtype, seed=7, n=700, d=37):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    y = (rng.uniform(size=n) > 0.5).astype(dtype)
    c = (rng.normal(size=d) * 0.1).astype(dtype)
    w = rng.uniform(0.5, 2.0, size=n).astype(dtype) if with_wo else None
    o = (rng.normal(size=n) * 0.1).astype(dtype) if with_wo else None
    return x, y, c, w, o


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas_interpret_f32(name, with_wo):
    x, y, c, w, o = _inputs(with_wo, np.float32)
    v_j, g_j = pallas_fvg(JL.BY_NAME[name], _j(x), _j(y), _j(c), _j(w), _j(o), True)
    v_t, g_t = hk.fused_value_and_gradient_plain(
        TL.BY_NAME[name], _t(x), _t(y), _t(c), _t(w), _t(o))
    assert v_t.dtype == g_t.dtype == torch.float32
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_aggregators_f64(name, with_wo):
    x, y, c, w, o = _inputs(with_wo, np.float64)
    v_t, g_t = hk.fused_value_and_gradient_plain(
        TL.BY_NAME[name], _t(x), _t(y), _t(c), _t(w), _t(o))
    v_j, g_j = jagg.value_and_gradient(JL.BY_NAME[name], _j(x), _j(y), _j(c),
                                       weights=_j(w), offsets=_j(o))
    v_a, g_a = tagg.value_and_gradient(TL.BY_NAME[name], _t(x), _t(y), _t(c),
                                       weights=_t(w), offsets=_t(o))
    for v, g in ((v_j, g_j), (v_a, g_a)):
        np.testing.assert_allclose(v_t.item(), float(v), rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
def test_cpu_wrapper_runs_plain_and_launches_nothing(with_wo):
    x, y, c, w, o = _inputs(with_wo, np.float32)
    before = hk.LAUNCHES
    v, g = hk.fused_value_and_gradient(TL.LOGISTIC, _t(x), _t(y), _t(c), _t(w), _t(o))
    v_p, g_p = hk.fused_value_and_gradient_plain(
        TL.LOGISTIC, _t(x), _t(y), _t(c), _t(w), _t(o))
    assert hk.LAUNCHES == before
    assert v.item() == v_p.item()
    assert torch.equal(g, g_p)


def test_wrapper_refuses_other_devices():
    x = torch.empty((4, 3), device="meta")
    v = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hk.fused_value_and_gradient(TL.LOGISTIC, x, v, torch.empty(3, device="meta"))


def test_width_limit_fits_shared_memory():
    # (warps + 1) rows of d floats per block within Hopper's 227 KB
    assert (hk._WARPS + 1) * hk.D_MAX * 4 <= 232_448
    assert hk.D_MAX >= 124
