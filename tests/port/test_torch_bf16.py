"""bf16 feature storage: the port == the JAX package, float64 labels, on the CPU.

The same seeded numpy data goes to both packages with the features stored
bfloat16 (values drawn in float64 and rounded to bf16 first, so both sides
hold the same bits) and everything else float64 (x64 on the JAX side).
Both promote X exactly in every product, so the results agree as the f64
aggregates do:
- value_and_gradient on a dense X, a PaddedSparse without and with its
  column view, four losses, plain / weights + offsets / weights + offsets +
  standardization; hessian_vector; rmatvec and sq_rmatvec (as
  tests/test_sparse_wide.py::test_bf16_values_accumulate_f32_gradient):
  rtol 1e-10, atol 1e-10;
- train_glm with LBFGS, OWLQN and TRON on a small a1a-shaped dense X and a
  small bench-config-6-shaped sparse X: equal iterations, passes and stop
  reason, value rtol 1e-10, coefficients atol 1e-7 (the GLM parity of
  test_torch_training.py).  The JAX side of the fits runs in a subprocess
  (game_jax_side.py bf16), started when the module starts and read by the
  fit tests at the end, so no solver compiles in the test process.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import game_jax_side as side
from photon_ml_tpu.ops import aggregators as jagg
from photon_ml_tpu.ops import features as jfeat
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.normalization import build_normalization_context as jbuild
from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like, make_wide_sparse_logistic
from photon_ml_tpu_torch.models import training
from photon_ml_tpu_torch.ops import aggregators as tagg
from photon_ml_tpu_torch.ops import features as tfeat
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.normalization import build_normalization_context as tbuild
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)

N, D = 200, 16
ICPT = D - 1
KINDS = ("dense", "ell", "csc")
INPUTS = ("plain", "w+o", "w+o+std")
RTOL = ATOL = 1e-10


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX side's bf16 fits, from a subprocess started here, at the
    module's first test, and waited for by the first fit test."""
    out = tmp_path_factory.mktemp("jax") / "bf16.npz"
    proc = subprocess.Popen(
        [sys.executable, str(Path(side.__file__).resolve()), "bf16", str(out)],
        cwd=side.ROOT, env=dict(os.environ, PYTHONPATH=str(side.ROOT), JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
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


def _problem(seed=21):
    """X [N, D] in float64, every value exact in bf16 (~40 % zeros, an
    intercept column), labels, coefficients, a direction, weights,
    offsets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)) * (rng.uniform(size=(N, D)) < 0.6)
    x = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    x[:, ICPT] = 1.0
    return dict(x=x, y=(rng.uniform(size=N) > 0.5).astype(np.float64),
                c=rng.normal(size=D) * 0.2, v=rng.normal(size=D),
                w=rng.uniform(0.5, 2.0, size=N), o=rng.normal(size=N) * 0.1)


def _matrices(x, kind):
    """(JAX, port) feature matrices of x with bf16 storage."""
    xb = torch.from_numpy(x).to(torch.bfloat16)
    if kind == "dense":
        return jnp.asarray(x, jnp.bfloat16), xb
    j = jfeat.PaddedSparse.from_dense(x)
    t = tfeat.PaddedSparse.from_dense(xb, device="cpu")
    if kind == "csc":
        j, t = j.with_csc(), t.with_csc()
    cast = lambda a: None if a is None else a.astype(jnp.bfloat16)
    j = jfeat.PaddedSparse(j.indices, cast(j.values), j.num_cols, j.csc_row,
                           cast(j.csc_val), j.csc_end)
    assert t.values.dtype == torch.bfloat16
    assert t.has_csc == (kind == "csc") and (not t.has_csc or t.csc_val.dtype == torch.bfloat16)
    return j, t


def _inputs(p, inputs):
    """(JAX kwargs, port kwargs) of value_and_gradient."""
    jkw, tkw = {}, {}
    if inputs != "plain":
        for k, name in (("w", "weights"), ("o", "offsets")):
            jkw[name], tkw[name] = jnp.asarray(p[k]), torch.from_numpy(p[k])
    if inputs.endswith("std"):
        mean, var = p["x"].mean(axis=0), p["x"].var(axis=0)
        jkw["norm"] = jbuild("standardization", mean=jnp.asarray(mean),
                             variance=jnp.asarray(var), intercept_index=ICPT)
        tkw["norm"] = tbuild("standardization", mean=torch.from_numpy(mean),
                             variance=torch.from_numpy(var), intercept_index=ICPT)
    return jkw, tkw


def _close(t, j):
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("loss", sorted(TL.BY_NAME))
@pytest.mark.parametrize("kind", KINDS)
def test_value_and_gradient_matches_jax(kind, loss, inputs):
    p = _problem()
    jx, tx = _matrices(p["x"], kind)
    jkw, tkw = _inputs(p, inputs)
    jv, jg = jagg.value_and_gradient(JL.BY_NAME[loss], jx, jnp.asarray(p["y"]),
                                     jnp.asarray(p["c"]), **jkw)
    tv, tg = tagg.value_and_gradient(TL.BY_NAME[loss], tx, torch.from_numpy(p["y"]),
                                     torch.from_numpy(p["c"]), **tkw)
    assert jg.dtype == jnp.float64
    _close(tv, jv)
    _close(tg, jg)


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
@pytest.mark.parametrize("kind", KINDS)
def test_hessian_vector_matches_jax(kind, loss):
    p = _problem(seed=22)
    jx, tx = _matrices(p["x"], kind)
    jkw, tkw = _inputs(p, "w+o+std")
    jh = jagg.hessian_vector(JL.BY_NAME[loss], jx, jnp.asarray(p["y"]), jnp.asarray(p["c"]),
                             jnp.asarray(p["v"]), **jkw)
    th = tagg.hessian_vector(TL.BY_NAME[loss], tx, torch.from_numpy(p["y"]),
                             torch.from_numpy(p["c"]), torch.from_numpy(p["v"]), **tkw)
    _close(th, jh)


@pytest.mark.parametrize("op", ["rmatvec", "sq_rmatvec"])
@pytest.mark.parametrize("kind", KINDS)
def test_products_promote_as_jax(kind, op):
    """X^T u and (X*X)^T u of bf16 storage: in f64 against the JAX
    package's; with an f32 u, the result is f32 (no bf16 accumulator), and
    with binary features, exact in bf16, it agrees with f32 storage to f32
    (tests/test_sparse_wide.py::test_bf16_values_accumulate_f32_gradient)."""
    p = _problem(seed=23)
    jx, tx = _matrices(p["x"], kind)
    jop, top = getattr(jfeat, op), getattr(tfeat, op)
    _close(top(tx, torch.from_numpy(p["o"])), jop(jx, jnp.asarray(p["o"])))

    binary = (np.abs(p["x"]) > 0).astype(np.float32)
    u = torch.from_numpy(p["o"].astype(np.float32))
    _, t16 = _matrices(binary, kind)
    t32 = t16.float() if kind == "dense" else t16.to(dtype=torch.float32)
    g16, g32 = top(t16, u), top(t32, u)
    assert g16.dtype == g32.dtype == torch.float32
    np.testing.assert_allclose(g16.numpy(), g32.numpy(), rtol=1e-6)


def test_storage_survives_ingest_and_train_glm(monkeypatch):
    """as_feature_matrix keeps bf16 features bf16 (a dense tensor, a
    PaddedSparse and its column view) and casts every other dtype as
    before; train_glm's objective holds the bf16 X, not a widened copy."""
    p = _problem(seed=24)
    xb = torch.from_numpy(p["x"]).to(torch.bfloat16)
    dense = tfeat.as_feature_matrix(xb, "cpu", torch.float64)
    sparse = tfeat.as_feature_matrix(tfeat.PaddedSparse.from_dense(xb, device="cpu"),
                                     "cpu", torch.float64, with_csc=True)
    assert dense.dtype == torch.bfloat16 and sparse.values.dtype == torch.bfloat16
    assert tfeat.as_feature_matrix(xb.float(), "cpu", torch.float64).dtype == torch.float64
    seen = []

    def spy(objective, *args, **kwargs):
        seen.append(objective.x.dtype)
        return solve(objective, *args, **kwargs)
    solve = training.solve
    monkeypatch.setattr(training, "solve", spy)
    for x in (xb, sparse):
        training.train_glm(x, torch.from_numpy(p["y"]), "logistic_regression",
                           optimizer_config=OptimizerConfig(max_iterations=3),
                           device="cpu")
    assert seen == [torch.bfloat16, torch.bfloat16]


def test_bf16_statistics_build_a_float32_context():
    """Statistics taken over a bf16 X in its own dtype are widened before
    the factors and shifts are formed: none of them is rounded to bf16."""
    p = _problem(seed=25)
    xb = torch.from_numpy(p["x"]).to(torch.bfloat16)
    mean, var = xb.mean(0), xb.var(0)
    got = tbuild("standardization", mean=mean, variance=var, intercept_index=ICPT)
    want = tbuild("standardization", mean=mean.float(), variance=var.float(),
                  intercept_index=ICPT)
    assert got.factors.dtype == got.shifts.dtype == torch.float32
    assert torch.equal(got.factors, want.factors) and torch.equal(got.shifts, want.shifts)


def test_paths_that_keep_float32_refuse_bf16():
    """One path takes no bf16 X, in both packages: the consensus-ADMM lane,
    whose Gram eigendecomposition has no bfloat16 kernel in the JAX package
    (jnp.linalg.eigh at photon_ml_tpu/parallel/fixed_effect.py:243 raises
    NotImplementedError, wrapped by its staging layer's MeshStagingError;
    nothing compiles).  The port raises NotImplementedError naming that
    site before it stages anything.  The candidate lanes, the streamed
    chunk and the monolithic mesh lane take a bf16 X (test_torch_lanes.py,
    test_torch_streaming.py, test_torch_mesh.py)."""
    import jax
    from photon_ml_tpu.ops.objective import GLMObjective as JObjective
    from photon_ml_tpu.optim import ADMMConfig, RegularizationContext as JReg
    from photon_ml_tpu.optim import RegularizationType as JRT
    from photon_ml_tpu.parallel import make_mesh
    from photon_ml_tpu.parallel.fixed_effect import fit_fixed_effect_admm
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.parallel.fixed_effect import stage_admm_grid
    import ml_dtypes
    p = _problem(seed=26)
    with pytest.raises(Exception) as err:
        fit_fixed_effect_admm(JObjective(JL.LOGISTIC, p["x"].astype(ml_dtypes.bfloat16),
                                         p["y"]),
                              np.zeros(D), make_mesh(1, 2, devices=jax.devices()[:2]),
                              ADMMConfig(max_iterations=2), reg=JReg(JRT.L2),
                              reg_weight=1.0, residency_key=("bf16-admm", "jax"))
    chain, e = [], err.value
    while e is not None:
        chain.append(e)
        e = e.__cause__
    assert any(isinstance(e, NotImplementedError) and "bfloat16" in str(e) for e in chain)
    xb = torch.from_numpy(p["x"]).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"fixed_effect\.py:243"):
        stage_admm_grid(("bf16-admm", "port"), object(), xb, torch.float64)
    assert GLMObjective(TL.LOGISTIC, xb, torch.from_numpy(p["y"])).x.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def port_fits():
    out = {}
    for kind in ("dense", "sparse"):
        x, y = side.bf16_problem(kind, make_a1a_like, make_wide_sparse_logistic)
        xb = (torch.from_numpy(x).to(torch.bfloat16) if kind == "dense" else
              tfeat.PaddedSparse.from_scipy(x, with_csc=True, device="cpu").to(
                  dtype=torch.bfloat16))
        for case, (opt, reg, lam, tol) in side.BF16_CASES.items():
            out[kind, case] = training.train_glm(
                xb, torch.from_numpy(y), "logistic_regression",
                optimizer_config=OptimizerConfig(
                    optimizer=OptimizerType(opt), max_iterations=side.BF16_MAX_ITERATIONS,
                    tolerance=tol),
                regularization=RegularizationContext(RegularizationType(reg)),
                regularization_weights=(lam,), device="cpu")[0]
    return out


@pytest.mark.parametrize("case", list(side.BF16_CASES))
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_train_glm_matches_jax(jax_fits, port_fits, kind, case):
    j = jax_fits()
    f = lambda field: j[f"{kind}/{case}/{field}"]
    t = port_fits[kind, case]
    r = t.result
    assert r.iterations == int(f("iterations")) > 0
    assert int(r.reason) == int(f("reason"))
    if case == "tron":
        assert r.fg_count is None and r.hv_count == int(f("hv_count")) > 0
    else:
        assert r.fg_count == int(f("fg_count"))
    np.testing.assert_allclose(r.value.item(), float(f("value")), rtol=1e-10)
    np.testing.assert_allclose(t.model.coefficients.means.numpy(), f("means"),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("d", [1, 7, 37, 124, 2048, 8192])
def test_bf16_plans_fit_and_stay_aligned(d):
    """The fused kernel's plan for a bf16 X: tiles of ~48 KB whose rows are
    a multiple of 8 (16 bytes of any 8 rows of an aligned X) once a tile
    holds 8 or more, the X span large enough for the tile and 7 values of
    alignment room, two or more stages within a block's shared memory;
    kernel A's plan for bf16 values sized by 6-byte slots."""
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    plan = hk.plan_fused(1_643_520, d, 132, 2)
    rows = plan.rows_per_tile
    assert rows % 8 == 0 or rows < 8
    assert 2 * rows * d <= hk._TILE_BYTES + 16 * d
    assert 4 * plan.layout.stage_x >= 2 * rows * d + 14
    assert plan.stages >= 2 and plan.layout.bytes <= hk.MAX_SMEM
    assert plan.layout == hk.smem_layout(d, rows, plan.stages, 2)
    f32 = hk.plan_fused(1_643_520, d, 132)
    assert f32.layout == hk.smem_layout(d, f32.rows_per_tile, f32.stages, 4)
    a = sk.plan_margins(285_135, 25, 14_983, 132, 2)
    assert a.c_in_smem and a.smem_bytes == sk.margin_smem_bytes(25, a.rows, a.stages, 14_983, 2)
    assert a.smem_bytes < sk.plan_margins(285_135, 25, 14_983, 132).smem_bytes
