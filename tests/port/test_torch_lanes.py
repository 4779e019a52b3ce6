"""The candidate-lane oracles == the JAX package's vmapped objectives, in
float64 on the CPU.

- ops/lanes.py::FixedEffectLanes (the fixed effect's K lanes; on the card,
  the lanes kernel) against jax.vmap of photon_ml_tpu's GLMObjective over
  (c, offsets, l2), the pass the JAX sweep's _fe_sweep_update makes: values,
  gradients and Hessian-vector products, raw and standardized, for the
  four losses, with weights, and over a PaddedSparse X; and its "single"
  route (a dense X wider than the lanes kernel takes, the single kernel
  once per lane) against the same vmapped objective;
- parallel/random_effect.py's lanes oracle (K candidates x E entities over
  one bucket's shared blocks) against the port's per-candidate
  batched_value_and_gradient and batched_hessian_vector_at;
- lanes_matvec against K matvecs.
Tolerance rtol 1e-12 (the same sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.normalization import build_normalization_context as jnorm
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops.lanes import (
    FixedEffectLanes, lanes_matvec, lanes_route, launch_groups,
)
from photon_ml_tpu_torch.ops.normalization import build_normalization_context as tnorm
from photon_ml_tpu_torch.parallel.random_effect import (
    EntityBlocks, batched_hessian_vector_at, batched_value_and_gradient,
    lanes_hessian_vector_at, lanes_value_and_gradient,
)

N, D, K = 240, 7, 4
RTOL = 1e-12


def _problem(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    x[:, 3] = np.where(rng.uniform(size=N) < 0.6, 0.0, x[:, 3])
    x[:, -1] = 1.0
    y = (rng.uniform(size=N) > 0.5).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=N)
    o = rng.normal(size=(K, N)) * 0.2
    c = rng.normal(size=(K, D)) * 0.3
    v = rng.normal(size=(K, D))
    l2 = np.asarray([0.0, 0.5, 2.0, 10.0])
    return x, y, w, o, c, v, l2


def _stats(x):
    mean = x.mean(0)
    var = x.var(0)
    return mean, var


@pytest.mark.parametrize("norm", ["none", "standardization"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_fixed_effect_lanes_match_vmapped_jax_objective(name, norm):
    x, y, w, o, c, v, l2 = _problem()
    mean, var = _stats(x)
    jn = tn = None
    if norm != "none":
        jn = jnorm(norm, mean=jnp.asarray(mean), variance=jnp.asarray(var),
                   intercept_index=D - 1)
        tn = tnorm(norm, mean=torch.from_numpy(mean), variance=torch.from_numpy(var),
                   intercept_index=D - 1)
    jloss = JL.BY_NAME[name]

    def one(ck, ok, lk, vk):
        obj = JObjective(jloss, jnp.asarray(x), jnp.asarray(y), weights=jnp.asarray(w),
                         offsets=ok, norm=jn).with_l2(lk)
        val, grad = obj.value_and_gradient(ck)
        return val, grad, obj.hessian_vector(ck, vk)

    jv, jg, jh = jax.jit(jax.vmap(one))(jnp.asarray(c), jnp.asarray(o), jnp.asarray(l2),
                                        jnp.asarray(v))
    t = torch.from_numpy
    lanes = FixedEffectLanes(TL.BY_NAME[name], t(x), t(y), t(o), t(l2), weights=t(w),
                             norm=tn)
    tv, tg = lanes.value_and_gradient(t(c))
    th = lanes.hessian_vector_at(t(c))(t(v))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-10, atol=1e-10)
    assert lanes.groups == [(0, K)]


def test_fixed_effect_lanes_over_a_padded_sparse_x():
    """A PaddedSparse X takes each lane's aggregator pass (kernels A and B
    on the card, once per candidate per pass): equal to the dense lanes."""
    x, y, w, o, c, v, l2 = _problem()
    t = torch.from_numpy
    dense = FixedEffectLanes(TL.LOGISTIC, t(x), t(y), t(o), t(l2), weights=t(w))
    sparse = FixedEffectLanes(TL.LOGISTIC, fops.PaddedSparse.from_dense(x, device="cpu"),
                              t(y), t(o), t(l2), weights=t(w))
    assert sparse.groups == []
    for a, b in zip(dense.value_and_gradient(t(c)), sparse.value_and_gradient(t(c))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(sparse.hessian_vector_at(t(c))(t(v)).numpy(),
                               dense.hessian_vector_at(t(c))(t(v)).numpy(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lanes_matvec(sparse.x, t(c)).numpy(),
                               lanes_matvec(t(x), t(c)).numpy(), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(lanes_matvec(t(x), t(c)).numpy(), c @ x.T, rtol=RTOL)


def test_launch_groups():
    """Groups of up to max_lanes(d) lanes on the card (none on the CPU);
    past the lanes kernel's widths, one lane a group (the single kernel's
    route); past the single kernel's D_MAX, a refusal."""
    assert launch_groups(40, 31, torch.device("cpu")) == [(0, 40)]
    assert launch_groups(40, 31, torch.device("cuda")) == [(0, 16), (16, 32), (32, 40)]
    assert launch_groups(9, 2048, torch.device("cuda")) == [(0, 8), (8, 9)]
    assert launch_groups(2, 4096, torch.device("cuda")) == [(0, 1), (1, 2)]
    with pytest.raises(ValueError, match=f"d={hk.D_MAX + 1}"):
        launch_groups(2, hk.D_MAX + 1, torch.device("cuda"))


@pytest.mark.parametrize("d", [2049, 3000, hk.D_MAX])
def test_wide_dense_fixed_effect_takes_the_single_kernel_route(d):
    """A dense fixed effect wider than the lanes kernel takes (max_lanes(d)
    = 0) runs the single fused kernel once per lane on the card, up to its
    D_MAX, where the first lanes kernel's wrapper refused it; no card
    needed to choose the route."""
    cuda = torch.device("cuda")
    assert hk.max_lanes(d) == 0
    assert lanes_route(d, cuda) == "single"
    assert launch_groups(16, d, cuda) == [(k, k + 1) for k in range(16)]
    assert lanes_route(2048, cuda) == "lanes" and lanes_route(d, torch.device("cpu")) == "plain"


@pytest.mark.parametrize("norm", ["none", "standardization"])
@pytest.mark.parametrize("name", ["logistic", "poisson"])
def test_single_kernel_route_matches_vmapped_jax_objective(name, norm, monkeypatch):
    """The "single" route's pass (the single kernel's wrapper per lane, its
    plain version on the CPU) with the route forced at a small width ==
    jax.vmap of the JAX package's GLMObjective, raw and standardized
    (rtol 1e-12: the same sums in another order)."""
    from photon_ml_tpu_torch.ops import lanes as lanes_mod
    monkeypatch.setattr(lanes_mod, "lanes_route", lambda d, device, xbytes=4: "single")
    x, y, w, o, c, v, l2 = _problem()
    mean, var = _stats(x)
    jn = tn = None
    if norm != "none":
        jn = jnorm(norm, mean=jnp.asarray(mean), variance=jnp.asarray(var),
                   intercept_index=D - 1)
        tn = tnorm(norm, mean=torch.from_numpy(mean), variance=torch.from_numpy(var),
                   intercept_index=D - 1)

    def one(ck, ok, lk):
        obj = JObjective(JL.BY_NAME[name], jnp.asarray(x), jnp.asarray(y),
                         weights=jnp.asarray(w), offsets=ok, norm=jn).with_l2(lk)
        return obj.value_and_gradient(ck)

    jv, jg = jax.jit(jax.vmap(one))(jnp.asarray(c), jnp.asarray(o), jnp.asarray(l2))
    t = torch.from_numpy
    lanes = FixedEffectLanes(TL.BY_NAME[name], t(x), t(y), t(o), t(l2), weights=t(w), norm=tn)
    assert lanes.route == "single" and lanes.groups == [(k, k + 1) for k in range(K)]
    tv, tg = lanes.value_and_gradient(t(c))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("name", ["logistic", "poisson"])
def test_random_effect_lanes_match_per_candidate_batches(name, weighted):
    """K candidates x E entities over one bucket's shared blocks == each
    candidate's own batched oracle (its offsets gathered into the blocks,
    its L2 weight)."""
    rng = np.random.default_rng(4)
    E, S, d = 6, 9, 3
    mask = (np.arange(S)[None, :] < rng.integers(0, S + 1, size=E)[:, None]).astype(float)
    x = rng.normal(size=(E, S, d)) * mask[:, :, None]
    y = np.where(mask > 0, (rng.uniform(size=(E, S)) > 0.5) * 1.0, 0.5)
    w = rng.uniform(0.5, 2.0, size=(E, S)) * mask if weighted else None
    off = rng.normal(size=(K, E, S)) * 0.3 * mask
    c = rng.normal(size=(K, E, d)) * 0.3
    v = rng.normal(size=(K, E, d))
    l2 = np.asarray([0.0, 0.5, 2.0, 10.0])
    t = lambda a: None if a is None else torch.from_numpy(a)
    loss = TL.BY_NAME[name]
    blocks = EntityBlocks(t(x), t(y), t(mask), t(w))
    val, grad = lanes_value_and_gradient(loss, blocks, t(off), t(c).reshape(K * E, d), t(l2))
    hv = lanes_hessian_vector_at(loss, blocks, t(off), t(c).reshape(K * E, d),
                                 t(l2))(t(v).reshape(K * E, d))
    for k in range(K):
        bk = EntityBlocks(t(x), t(y), t(mask), t(w), t(off[k]))
        vk, gk = batched_value_and_gradient(loss, bk, t(c[k]), float(l2[k]))
        hk = batched_hessian_vector_at(loss, bk, t(c[k]), float(l2[k]))(t(v[k]))
        rows = slice(k * E, (k + 1) * E)
        np.testing.assert_allclose(val[rows].numpy(), vk.numpy(), rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(grad[rows].numpy(), gk.numpy(), rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(hv[rows].numpy(), hk.numpy(), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("reg", ["l2", "elastic_net"])
def test_solve_takes_regweights_as_the_split(reg):
    """optim/config.py::solve with RegWeights reproduces the static split
    bit for bit (the JAX package's test_regweights_matches_static_split),
    and the batched solve's per-lane L1 weights equal one weight shared."""
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim import batched
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType, solve)
    from photon_ml_tpu_torch.optim.schedule import RegWeights
    x, y, w, o, c, v, l2 = _problem()
    ctx = (RegularizationContext(RegularizationType.L2) if reg == "l2" else
           RegularizationContext(RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5))
    obj = GLMObjective(TL.LOGISTIC, torch.from_numpy(x), torch.from_numpy(y))
    x0 = torch.zeros(D, dtype=torch.float64)
    static = solve(obj, x0, OptimizerConfig(), ctx, 0.7)
    traced = solve(obj, x0, OptimizerConfig(), ctx,
                   RegWeights.from_context(ctx, 0.7, dtype=torch.float64))
    assert torch.equal(static.x, traced.x) and static.iterations == traced.iterations
    l1, l2w = ctx.split(0.7)
    lanes = FixedEffectLanes(TL.LOGISTIC, obj.x, obj.labels,
                             torch.zeros((3, N), dtype=torch.float64),
                             torch.full((3,), l2w, dtype=torch.float64))
    shared = batched.solve(lanes.value_and_gradient, torch.zeros((3, D), dtype=torch.float64),
                           OptimizerConfig(), ctx, RegWeights(torch.tensor(l1, dtype=torch.float64), None))
    per_lane = batched.solve(lanes.value_and_gradient, torch.zeros((3, D), dtype=torch.float64),
                             OptimizerConfig(), ctx,
                             RegWeights(torch.full((3,), l1, dtype=torch.float64), None))
    assert torch.equal(shared.x, per_lane.x)
    np.testing.assert_allclose(shared.x[0].numpy(), static.x.numpy(), rtol=1e-6, atol=1e-6)


# -- a bf16 X on the candidate lanes -----------------------------------------

U_BF16 = 2.0 ** -8   # bf16's unit roundoff


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(torch.bfloat16)


@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_bf16_lanes_pass_matches_vmapped_jax_objective(name):
    """One pass of K bootstrap-style lanes (weights w * keep_k) at the same
    bf16 C, with the lane state in X's dtype as the JAX package keeps it
    (photon_ml_tpu/diagnostics/bootstrap.py:112-126): X, labels, weights and
    C bf16 on both sides.  The JAX package rounds every intermediate to
    bf16; the port computes the pass in float32 and rounds its results.
    So values agree within 4 u relative and each gradient entry within
    4 u sum_i |w_i l'_i x_ij| + u |g_j| (u = 2^-8: a few roundings of each
    term, one of the sum)."""
    x, y, w, _, c, _, _ = _problem(seed=5)
    keep = np.random.default_rng(6).uniform(size=(K, N)) < 0.75
    xb, yb, cb = _bf16(x), _bf16(y), _bf16(c)
    jloss = JL.BY_NAME[name]

    def one(ck, wk):
        return JObjective(jloss, jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                          weights=wk).value_and_gradient(ck)

    jv, jg = jax.vmap(one)(jnp.asarray(c, jnp.bfloat16), jnp.asarray(keep * w, jnp.bfloat16))
    lanes = FixedEffectLanes(TL.BY_NAME[name], xb, yb, None,
                             torch.zeros(K, dtype=torch.bfloat16), weights=_bf16(w),
                             lane_keep=torch.from_numpy(keep))
    tv, tg = lanes.value_and_gradient(cb)
    assert tv.dtype == tg.dtype == torch.bfloat16 and jv.dtype == jnp.bfloat16
    # the terms' scale, from the same bf16 inputs in float64
    z = xb.double().numpy() @ cb.double().numpy().T
    _, dl = TL.BY_NAME[name].loss_and_dz(torch.from_numpy(z), yb.double()[:, None])
    wk = (keep * _bf16(w).double().numpy()).T
    terms = np.abs(xb.double().numpy()).T @ np.abs(wk * dl.numpy())   # [d, K]
    jv, jg = np.asarray(jv, np.float64), np.asarray(jg, np.float64)
    np.testing.assert_allclose(tv.double().numpy(), jv, rtol=4 * U_BF16)
    bound = 4 * U_BF16 * terms.T + U_BF16 * np.abs(jg)
    assert np.all(np.abs(tg.double().numpy() - jg) <= bound)


def test_bf16_plain_version_promotes_x_exactly():
    """The plain version takes a bf16 X as the kernel does (every other
    operand float32 on the card, float64 here) and widens it exactly: the
    same numbers as the plain version over X widened first."""
    x, y, w, o, c, _, _ = _problem(seed=7)
    t = torch.from_numpy
    xb = _bf16(x)
    got = hk.fused_value_and_gradient_lanes_plain(TL.LOGISTIC, xb, t(y), t(c), t(w), t(o))
    want = hk.fused_value_and_gradient_lanes_plain(TL.LOGISTIC, xb.double(), t(y), t(c),
                                                   t(w), t(o))
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    lanes = FixedEffectLanes(TL.LOGISTIC, xb, t(y), t(o), t(np.zeros(K)), weights=t(w))
    for a, b in zip(lanes.value_and_gradient(t(c)), want[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [31, 124])
def test_bf16_lanes_plans_fit_shared_memory(d, masked):
    """The lanes kernel's plan for a bf16 X at K = 4, 8 and 16: tiles of a
    multiple of 8 rows (16-byte aligned tiles of an aligned X), an X span
    holding the tile and 7 elements of alignment room, two or more stages,
    within MAX_SMEM at the instantiated gradient slots, as the C entry's
    smem_layout reproduces it; never fewer lanes a launch than float32."""
    for lanes in (4, 8, 16):
        plan = hk.plan_lanes(950_051, d, lanes, 132, masked=masked, xbytes=2)
        rows = plan.rows_per_tile
        assert rows % 8 == 0 and plan.stages >= 2
        assert 4 * plan.layout.stage_x >= 2 * rows * d + 14
        assert plan.layout.bytes <= hk.MAX_SMEM
        assert plan.layout == hk.lanes_smem_layout(d, lanes, rows, plan.stages, masked, 2)
        assert plan.slots >= hk.grad_slots(d, rows)
    assert hk.max_lanes(d, masked, xbytes=2) >= hk.max_lanes(d, masked) == hk.LANES_MAX
    with pytest.raises(ValueError, match="xbytes"):
        hk.plan_lanes(1000, d, 4, 132, xbytes=8)


@pytest.fixture(scope="module")
def bf16x(tmp_path_factory):
    import game_jax_side as side
    return side.shared_results("bf16x", tmp_path_factory)


def test_bf16_bootstrap_matches_jax(bf16x):
    """diagnostics.bootstrap_training on a bf16 X (game_jax_side.
    bootstrap_problem, 4 replicas, LBFGS with L2) against the JAX package's:
    both keep the replicas' state in bf16 and stop where bf16's gradient
    noise stops them, so the two trajectories are not bit-reproducible.
    The outputs are held instead: every coefficient summary (min,
    quartiles, max, mean) within 8 bf16 ulps of its scale, 8 u max(1, |a|)
    (u = 2^-8, a few ulps of each replica's stopping point); each holdout
    metric's mean within 2e-2 relative (the margins of those coefficients,
    rounded to bf16, over ~100 holdout rows a replica); and the
    coefficients whose interquartile range excludes zero are the same."""
    import game_jax_side as side
    from photon_ml_tpu_torch.diagnostics.bootstrap import bootstrap_training
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType)
    x, y = side.bootstrap_problem()
    rep = bootstrap_training(_bf16(x), y, "logistic_regression",
                             num_bootstrap_samples=side.BOOT_K,
                             optimizer_config=OptimizerConfig(**side.BOOT_OPTIONS),
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0, device="cpu")
    assert rep.coefficients.dtype == np.float32 and rep.solve["route"] == "plain"
    for j, cs in enumerate(rep.coefficient_summaries):
        for f in ("min", "q1", "median", "q3", "max", "mean"):
            want = float(bf16x[f"boot/coef/{j}/{f}"])
            assert abs(getattr(cs, f) - want) <= 8 * U_BF16 * max(1.0, abs(want)), (j, f)
    names = {k.split("/", 2)[2] for k in bf16x if k.startswith("boot/metric/")}
    assert names == set(rep.metric_summaries)
    for name in names:
        np.testing.assert_allclose(rep.metric_summaries[name].mean,
                                   float(bf16x[f"boot/metric/{name}"]), rtol=2e-2)
    assert np.array_equal(rep.significant_mask, bf16x["boot/significant"])
