"""Sparse COO/CSR tensors, the port's counterpart of the JAX package's
BCOO: the port == the JAX package, float64, on the CPU.

The same seeded numpy matrix (game_jax_side.bcoo_problem: an intercept
column, an empty row and entries stored twice) goes to the JAX package as
a BCOO and to the port as a torch sparse tensor, COO as it is or CSR
(convert.sparse_from_numpy):
- every product (matvec, rmatvec, sq_rmatvec, pad_rows, densify, the
  shape) on the raw tensor against the same product of the BCOO, and the
  value, gradient, Hessian-vector product and Hessian diagonal of the
  aggregators (as tests/test_aggregators.py::test_sparse_matches_dense):
  rtol 1e-10, atol 1e-12.  sq_rmatvec squares each summed entry; the JAX
  package's squares each stored one, which differs where an entry is
  stored twice, so it is held to the BCOO with its duplicates summed;
- ingest (as_feature_matrix, PaddedSparse.from_torch): equal, tensor for
  tensor, to from_scipy's PaddedSparse of the same matrix, with and
  without the column view, bf16 values too;
- train_glm with LBFGS and TRON against the JAX package's train_glm on the
  BCOO (its side runs in a subprocess, game_jax_side.py bcoo): equal
  iterations and stop reason, value rtol 1e-10, coefficients atol 1e-8;
- the mesh refuses a sparse tensor, as the JAX package's mesh refuses a
  BCOO; every other sparse layout raises TypeError.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import game_jax_side as side
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.ops import aggregators as jagg
from photon_ml_tpu.ops import features as jfeat
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data.streaming import bf16_bits
from photon_ml_tpu_torch.models import training
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops import aggregators as tagg
from photon_ml_tpu_torch.ops import features as tfeat
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)

RTOL, ATOL = 1e-10, 1e-12
LAYOUTS = ("coo", "csr")
N, D = side.BCOO_N, side.BCOO_D


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX side's train_glm fits on the BCOO, from a subprocess started
    at the module's first test and waited for by the first fit test."""
    out = tmp_path_factory.mktemp("jax") / "bcoo.npz"
    proc = side.start("bcoo", out)
    results = {}

    def wait():
        if not results:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"the JAX side failed:\n{err[-4000:]}")
            with np.load(out) as z:
                results.update({k: z[k] for k in z.files})
        return results
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _start_jax_side(jax_fits):
    yield


def _problem():
    data, idx, y = side.bcoo_problem()
    rng = np.random.default_rng(31)
    return dict(data=data, idx=idx, y=y, c=rng.normal(size=D) * 0.3,
                v=rng.normal(size=D), u=rng.normal(size=N),
                w=rng.uniform(0.5, 2.0, size=N), o=rng.normal(size=N) * 0.1)


def _bcoo(p, summed=False):
    x = jsparse.BCOO((jnp.asarray(p["data"]), jnp.asarray(p["idx"])), shape=(N, D))
    return x.sum_duplicates() if summed else x


def _tensor(p, layout):
    return convert.sparse_from_numpy(p["data"], p["idx"], (N, D), layout=layout,
                                     device="cpu")


def _summed_dense(p):
    x = np.zeros((N, D))
    np.add.at(x, (p["idx"][:, 0], p["idx"][:, 1]), p["data"])
    return x


def _close(t, j, rtol=RTOL, atol=ATOL):
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("op", ["matvec", "rmatvec", "sq_rmatvec", "pad_rows",
                                "densify", "shape", "compute_score"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_products_match_jax_bcoo(layout, op):
    p = _problem()
    j, t = _bcoo(p), _tensor(p, layout)
    assert tfeat.is_sparse(t) and t.layout == {"coo": torch.sparse_coo,
                                               "csr": torch.sparse_csr}[layout]
    c, u = torch.from_numpy(p["c"]), torch.from_numpy(p["u"])
    if op == "matvec":
        _close(tfeat.matvec(t, c), jfeat.matvec(j, jnp.asarray(p["c"])))
    elif op == "rmatvec":
        _close(tfeat.rmatvec(t, u), jfeat.rmatvec(j, jnp.asarray(p["u"])))
    elif op == "sq_rmatvec":
        _close(tfeat.sq_rmatvec(t, u),
               jfeat.sq_rmatvec(_bcoo(p, summed=True), jnp.asarray(p["u"])))
        # the JAX package squares each stored entry: an entry stored twice
        # gives a^2 + b^2 there, not (a + b)^2
        assert not np.allclose(np.asarray(jfeat.sq_rmatvec(j, jnp.asarray(p["u"]))),
                               tfeat.sq_rmatvec(t, u).numpy(), rtol=RTOL)
    elif op == "pad_rows":
        got, want = tfeat.pad_rows(t, 4), jfeat.pad_rows(j, 4)
        assert got.layout == t.layout and tuple(got.shape) == tuple(want.shape) == (N + 4, D)
        stored = lambda a: (a._values() if a.layout == torch.sparse_coo else a.values()).numel()
        assert stored(got) == stored(t)  # zero rows store nothing
        _close(tfeat.densify(got), jfeat.densify(want), rtol=0, atol=0)
        assert tfeat.pad_rows(t, 0) is t
    elif op == "densify":
        _close(tfeat.densify(t), jfeat.densify(j), rtol=0, atol=0)
        assert np.array_equal(tfeat.densify(t).numpy(), _summed_dense(p))
    elif op == "shape":
        assert (tfeat.num_rows(t), tfeat.num_features(t)) == (jfeat.num_rows(j),
                                                              jfeat.num_features(j)) == (N, D)
    else:
        _close(Coefficients(c).compute_score(t),
               JCoefficients(jnp.asarray(p["c"])).compute_score(j))


@pytest.mark.parametrize("inputs", ["plain", "w+o"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_aggregates_match_jax_bcoo(layout, inputs):
    """value_and_gradient, hessian_vector and hessian_diagonal on the raw
    tensor, as the JAX package's on the BCOO (hessian_diagonal against the
    BCOO with its duplicates summed, see sq_rmatvec)."""
    p = _problem()
    j, t = _bcoo(p), _tensor(p, layout)
    jkw, tkw = {}, {}
    if inputs == "w+o":
        for k, name in (("w", "weights"), ("o", "offsets")):
            jkw[name], tkw[name] = jnp.asarray(p[k]), torch.from_numpy(p[k])
    jy, ty = jnp.asarray(p["y"]), torch.from_numpy(p["y"])
    jc, tc = jnp.asarray(p["c"]), torch.from_numpy(p["c"])
    jv, tv = jnp.asarray(p["v"]), torch.from_numpy(p["v"])
    vj, gj = jagg.value_and_gradient(JL.LOGISTIC, j, jy, jc, **jkw)
    vt, gt = tagg.value_and_gradient(TL.LOGISTIC, t, ty, tc, **tkw)
    _close(vt, vj)
    _close(gt, gj)
    _close(tagg.hessian_vector(TL.LOGISTIC, t, ty, tc, tv, **tkw),
           jagg.hessian_vector(JL.LOGISTIC, j, jy, jc, jv, **jkw))
    _close(tagg.hessian_diagonal(TL.LOGISTIC, t, ty, tc, **tkw),
           jagg.hessian_diagonal(JL.LOGISTIC, _bcoo(p, summed=True), jy, jc, **jkw))


def _scipy(p):
    return sp.coo_matrix((p["data"], (p["idx"][:, 0], p["idx"][:, 1])), shape=(N, D)).tocsr()


FIELDS = ("indices", "values", "csc_row", "csc_val", "csc_end", "csc_tiles")


@pytest.mark.parametrize("with_csc", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_ingest_equals_from_scipy(layout, with_csc):
    """The tensor's ELL form is the one from_scipy builds from the same
    matrix (duplicates summed, rows' nonzeros in column order, k the widest
    row, the column view in row order), tensor for tensor; as_feature_matrix
    takes the column view on the CPU by JAX's width rule, as for scipy."""
    p = _problem()
    t = _tensor(p, layout)
    want = tfeat.PaddedSparse.from_scipy(_scipy(p), with_csc=with_csc, device="cpu")
    got = tfeat.PaddedSparse.from_torch(t, with_csc=with_csc)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        assert a is None or (a.dtype == b.dtype and torch.equal(a, b)), f
    assert got.num_cols == want.num_cols == D
    ingested = tfeat.as_feature_matrix(t, "cpu", torch.float64, with_csc=with_csc)
    scipy_in = tfeat.as_feature_matrix(_scipy(p), "cpu", torch.float64, with_csc=with_csc)
    assert isinstance(ingested, tfeat.PaddedSparse) and not ingested.has_csc
    assert torch.equal(ingested.indices, scipy_in.indices)
    assert torch.equal(ingested.values, scipy_in.values)


def test_bf16_values_stay_bf16_through_ingest():
    """bf16 data (its uint16 bits, made a bf16 host tensor by
    convert.bf16_from_numpy) gives bf16 values, kept by ingest and by the
    column view, equal to from_scipy's matrix cast to bf16."""
    p = _problem()
    bits = bf16_bits(torch.from_numpy(p["data"]).to(torch.bfloat16))
    t = convert.sparse_from_numpy(convert.bf16_from_numpy(bits), p["idx"], (N, D),
                                  layout="csr", device="cpu")
    assert t.dtype == torch.bfloat16
    got = tfeat.as_feature_matrix(t, "cpu", torch.float64)
    assert got.values.dtype == torch.bfloat16
    with_view = tfeat.PaddedSparse.from_torch(t, with_csc=True)
    want = tfeat.PaddedSparse.from_scipy(
        sp.csr_matrix(t.to_dense().double().numpy()), with_csc=True, device="cpu")
    assert torch.equal(with_view.values, want.values.to(torch.bfloat16))
    assert torch.equal(with_view.csc_val, want.csc_val.to(torch.bfloat16))
    assert torch.equal(with_view.csc_row, want.csc_row)
    # the products promote a bf16 value exactly
    u = torch.from_numpy(p["u"])
    np.testing.assert_allclose(tfeat.rmatvec(t, u).numpy(),
                               (t.to_dense().double().T @ u).numpy(), rtol=RTOL, atol=ATOL)


def test_sparse_from_numpy_round_trips_a_bcoo():
    """A BCOO's (data, indices, shape) -> the port's tensor -> the same dense
    matrix, in both layouts; bf16 bits round-trip through the host tensor."""
    p = _problem()
    j = _bcoo(p)
    for layout in LAYOUTS:
        t = convert.sparse_from_numpy(np.asarray(j.data), np.asarray(j.indices), j.shape,
                                      layout=layout, device="cpu")
        assert np.array_equal(t.to_dense().numpy(), np.asarray(j.todense()))
    coo = convert.sparse_from_numpy(p["data"], p["idx"], (N, D), device="cpu")
    assert coo._values().numel() == len(p["data"])   # entries kept as given
    bits = np.arange(0, 65536, 97, dtype=np.uint16)
    host = convert.bf16_from_numpy(bits)
    assert host.dtype == torch.bfloat16
    assert np.array_equal(bf16_bits(host), bits)
    assert bf16_bits(bits) is None   # a plain uint16 array is integers
    assert bf16_bits(torch.zeros(2, dtype=torch.bfloat16, device="meta")) is None  # no host block
    with pytest.raises(TypeError, match="uint16"):
        convert.bf16_from_numpy(bits.astype(np.int32))
    with pytest.raises(ValueError, match="layout"):
        convert.sparse_from_numpy(p["data"], p["idx"], (N, D), layout="csc", device="cpu")


def test_mesh_refuses_a_sparse_tensor_as_jax_refuses_a_bcoo():
    """Both packages refuse to shard the raw sparse matrix over the data
    axis: the JAX package's device_put of the BCOO's leaves raises (a
    ValueError, before any compile), and the port raises naming that site."""
    from photon_ml_tpu.ops.objective import GLMObjective as JObjective
    from photon_ml_tpu.optim import OptimizerConfig as JConfig
    from photon_ml_tpu.parallel import make_mesh as jmake_mesh
    from photon_ml_tpu.parallel.fixed_effect import fit_fixed_effect as jfit
    from photon_ml_tpu_torch.parallel.mesh import pad_and_shard_rows
    p = _problem()
    with pytest.raises(ValueError):
        jfit(JObjective(JL.LOGISTIC, _bcoo(p), jnp.asarray(p["y"])), jnp.zeros(D),
             jmake_mesh(2, 1, devices=jax.devices()[:2]), JConfig(max_iterations=2))
    for layout in LAYOUTS:
        with pytest.raises(ValueError, match="fixed_effect.py:184"):
            pad_and_shard_rows(object(), _tensor(p, layout), residency_key=("fe", "t"))


def test_other_sparse_layouts_raise_type_error():
    x = torch.from_numpy(_summed_dense(_problem()))
    for bad in (x.to_sparse_csc(), x.to_sparse_bsr((1, 1))):
        for call in (lambda: tfeat.as_feature_matrix(bad, "cpu"),
                     lambda: tfeat.matvec(bad, torch.ones(D, dtype=torch.float64))):
            with pytest.raises(TypeError, match="sparse_coo or torch.sparse_csr"):
                call()


@pytest.fixture(scope="module")
def port_fits():
    p = _problem()
    out = {}
    for layout in LAYOUTS:
        for case, (opt, iters, tol) in side.BCOO_CASES.items():
            out[layout, case] = training.train_glm(
                _tensor(p, layout), torch.from_numpy(p["y"]), "logistic_regression",
                optimizer_config=OptimizerConfig(optimizer=OptimizerType(opt),
                                                 max_iterations=iters, tolerance=tol),
                regularization=RegularizationContext(RegularizationType.L2),
                regularization_weights=(1.0,), device="cpu")[0]
    return out


@pytest.mark.parametrize("case", list(side.BCOO_CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_glm_matches_jax_bcoo(jax_fits, port_fits, layout, case):
    j = jax_fits()
    f = lambda field: j[f"{case}/{field}"]
    t = port_fits[layout, case]
    r = t.result
    assert r.iterations == int(f("iterations")) > 0
    assert int(r.reason) == int(f("reason"))
    if case == "tron":
        assert r.hv_count == int(f("hv_count")) > 0
    else:
        assert r.fg_count == int(f("fg_count"))
    np.testing.assert_allclose(r.value.item(), float(f("value")), rtol=RTOL)
    np.testing.assert_allclose(t.model.coefficients.means.numpy(), f("means"),
                               rtol=0, atol=1e-8)


def test_uint16_data_keeps_its_integer_values():
    """A BCOO of uint16 counts is integers, as in the JAX package (which
    promotes them): sparse_from_numpy keeps the values (widened to int64,
    as torch's sparse ops take no uint16) and ingest casts them to the
    compute dtype, equal to from_scipy's matrix of the same counts."""
    p = _problem()
    counts = (np.arange(len(p["data"])) * 257 % 65535 + 1).astype(np.uint16)
    dense = np.zeros((N, D))
    np.add.at(dense, tuple(p["idx"].T), counts.astype(np.float64))
    for layout in LAYOUTS:
        t = convert.sparse_from_numpy(counts, p["idx"], (N, D), layout=layout, device="cpu")
        assert t.dtype == torch.int64
        assert np.array_equal(t.to_dense().numpy(), dense)
        got = tfeat.as_feature_matrix(t, "cpu", torch.float64)
        want = tfeat.PaddedSparse.from_scipy(sp.csr_matrix(dense), device="cpu")
        assert got.values.dtype == torch.float64
        assert torch.equal(got.values, want.values) and torch.equal(got.indices, want.indices)


def test_ell_form_cache_drops_a_freed_tensor():
    """ell_form caches a tensor's ELL form while the tensor lives, makes it
    again after an in-place write, and drops it when the tensor is freed."""
    import gc
    p = _problem()
    t = convert.sparse_from_numpy(p["data"], p["idx"], (N, D), layout="csr", device="cpu")
    key = id(t)
    form = tfeat.ell_form(t)
    assert tfeat.ell_form(t) is form and key in tfeat._ELL_FORMS
    t.values().mul_(2.0)
    again = tfeat.ell_form(t)
    assert again is not form and torch.equal(again.values, 2.0 * form.values)
    del t, form, again
    gc.collect()
    assert key not in tfeat._ELL_FORMS
