"""Port aggregators == JAX aggregators in float64.

Cases: plain, weights+offsets, a mask over a padded row whose loss is
non-finite for Poisson (the `where` semantics), and normalization with
factors, shifts and both.  Tolerance: rtol 1e-10, atol 1e-10 (the same
algebra in f64; reductions may sum in other orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import aggregators as jagg
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu_torch.convert import normalization_from_numpy
from photon_ml_tpu_torch.ops import aggregators as tagg
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective

NAMES = sorted(TL.BY_NAME)
CASES = ["plain", "w+o", "mask", "factors", "shifts", "factors+shifts",
         "mask+factors+shifts"]
N, D = 300, 12


def _case(case, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    x[:, -1] = 1.0  # intercept
    y = (rng.uniform(size=N) > 0.5).astype(np.float64)
    c = rng.normal(size=D) * 0.2
    v = rng.normal(size=D)
    kw = dict(weights=None, offsets=None, mask=None)
    norm = None
    if case == "w+o":
        kw["weights"] = rng.uniform(0.5, 2.0, size=N)
        kw["offsets"] = rng.normal(size=N) * 0.1
    if case.startswith("mask"):
        mask = np.ones(N)
        mask[-3:] = 0.0
        # padded row: margin > 700, so the Poisson loss is inf there
        x[-1] = 800.0 * np.sign(c)
        kw["mask"] = mask
    if case in ("factors", "factors+shifts", "mask+factors+shifts"):
        norm = dict(factors=rng.uniform(0.5, 2.0, size=D))
        norm["factors"][-1] = 1.0
    if case in ("shifts", "factors+shifts", "mask+factors+shifts"):
        norm = dict(norm or {}, shifts=rng.normal(size=D) * 0.3)
        norm["shifts"][-1] = 0.0
    return x, y, c, v, kw, norm


def _both(case):
    x, y, c, v, kw, norm = _case(case)
    jkw = {k: None if a is None else jnp.asarray(a) for k, a in kw.items()}
    tkw = {k: None if a is None else torch.from_numpy(a) for k, a in kw.items()}
    if norm is not None:
        f, s = norm.get("factors"), norm.get("shifts")
        jkw["norm"] = JNorm(None if f is None else jnp.asarray(f),
                            None if s is None else jnp.asarray(s), D - 1)
        tkw["norm"] = normalization_from_numpy(f, s, D - 1, device="cpu")
    j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(c), jnp.asarray(v))
    t = tuple(torch.from_numpy(a) for a in (x, y, c, v))
    return j, jkw, t, tkw


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_value_and_gradient(name, case):
    (jx, jy, jc, _), jkw, (tx, ty, tc, _), tkw = _both(case)
    v_j, g_j = jagg.value_and_gradient(JL.BY_NAME[name], jx, jy, jc, **jkw)
    v_t, g_t = tagg.value_and_gradient(TL.BY_NAME[name], tx, ty, tc, **tkw)
    assert np.isfinite(v_t.item())
    _close(v_t.item(), float(v_j))
    _close(g_t.numpy(), g_j)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_value_only(name, case):
    (jx, jy, jc, _), jkw, (tx, ty, tc, _), tkw = _both(case)
    _close(tagg.value_only(TL.BY_NAME[name], tx, ty, tc, **tkw).item(),
           float(jagg.value_only(JL.BY_NAME[name], jx, jy, jc, **jkw)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_hessian_vector(name, case):
    (jx, jy, jc, jv), jkw, (tx, ty, tc, tv), tkw = _both(case)
    hv_j = jagg.hessian_vector(JL.BY_NAME[name], jx, jy, jc, jv, **jkw)
    hv_t = tagg.hessian_vector(TL.BY_NAME[name], tx, ty, tc, tv, **tkw)
    assert np.all(np.isfinite(hv_t.numpy()))
    _close(hv_t.numpy(), hv_j)


@pytest.mark.parametrize("case", ["plain", "w+o", "mask"])
@pytest.mark.parametrize("name", NAMES)
def test_hessian_diagonal(name, case):
    (jx, jy, jc, _), jkw, (tx, ty, tc, _), tkw = _both(case)
    hd_j = jagg.hessian_diagonal(JL.BY_NAME[name], jx, jy, jc, **jkw)
    hd_t = tagg.hessian_diagonal(TL.BY_NAME[name], tx, ty, tc, **tkw)
    _close(hd_t.numpy(), hd_j)


def test_mask_uses_where_not_multiply():
    """The padded row's Poisson loss is inf; a multiply would make nan."""
    (_, _, _, _), _, (tx, ty, tc, _), tkw = _both("mask")
    z = tagg.compute_margins(tx, tc)
    assert torch.isinf(TL.POISSON.loss(z, ty)).any()
    v, g = tagg.value_and_gradient(TL.POISSON, tx, ty, tc, **tkw)
    assert np.isfinite(v.item()) and torch.isfinite(g).all()


@pytest.mark.parametrize("case", ["plain", "mask", "factors+shifts"])
@pytest.mark.parametrize("name", NAMES)
def test_objective_matches_jax(name, case):
    """GLMObjective adds l2/2 |c|^2 to the aggregates, in both packages."""
    (jx, jy, jc, jv), jkw, (tx, ty, tc, tv), tkw = _both(case)
    jo = JObjective(JL.BY_NAME[name], jx, jy, l2_weight=0.7, **jkw)
    to = TObjective(TL.BY_NAME[name], tx, ty, l2_weight=0.7, **tkw)
    _close(to.value(tc).item(), float(jo.value(jc)))
    (v_t, g_t), (v_j, g_j) = to.value_and_gradient(tc), jo.value_and_gradient(jc)
    _close(v_t.item(), float(v_j))
    _close(g_t.numpy(), g_j)
    _close(to.hessian_vector(tc, tv).numpy(), jo.hessian_vector(jc, jv))
    if case == "factors+shifts":
        with pytest.raises(ValueError, match="original-space only"):
            to.hessian_diagonal(tc)
        to, jo = to.replace(norm=None), jo.replace(norm=None)
    _close(to.hessian_diagonal(tc).numpy(), jo.hessian_diagonal(jc))
    assert to.with_l2(0.0).l2_weight == 0.0 and to.dim == D


@pytest.mark.parametrize("case", ["mask", "shifts", "factors+shifts", "mask+factors+shifts"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_plain_with_mask_and_shift_matches_jax(name, case):
    """The fused kernel's plain version takes the row mask (a select: the
    masked Poisson row's loss is inf) and the shift; with the factors folded
    as the CUDA path folds them (e = c*f, grad*f) it is the JAX package's
    aggregator."""
    (jx, jy, jc, _), jkw, (tx, ty, tc, _), tkw = _both(case)
    v_j, g_j = jagg.value_and_gradient(JL.BY_NAME[name], jx, jy, jc, **jkw)
    norm = tkw.get("norm")
    f = None if norm is None else norm.factors
    e = tc if f is None else tc * f
    v_t, g_t = hk.fused_value_and_gradient_plain(
        TL.BY_NAME[name], tx, ty, e, tkw["weights"], tkw["offsets"], tkw["mask"],
        None if norm is None else norm.shifts)
    if f is not None:
        g_t = g_t * f
    assert np.isfinite(v_t.item())
    _close(v_t.item(), float(v_j))
    _close(g_t.numpy(), g_j)
