"""The CUDA kernels on the card: against their plain versions, bit-stable,
and on train_glm's path (the fused dense kernel, and the sparse kernels A
and B).  Needs a CUDA device (and nvcc to build the kernel);
skips elsewhere.  This file imports no JAX, so on a machine with the card
it runs without the repository's JAX fixtures:

    python -m pytest --noconftest -p no:cacheprovider tests/port/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, d, with_wo, seed=1, skip=0):
    """X [n, d] etc. on the card; with skip=k, X is rows k.. of a contiguous
    [n + k, d] tensor and y, w, o are sliced to match (views whose base is
    not 16-byte aligned).

    Above d = 124 the data is shaped like a1a's (features >= 0, 25 %
    positive labels; margins of standard deviation ~0.2).  With centred
    features and balanced labels some gradient elements are sums of
    O(1) terms that cancel to near zero, and no f32 sum of 20,000 such
    terms, in any order, is within atol 1e-4 of the exact one."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()[skip:]
    m = n + skip
    wide = d > 124
    x = t(rng.uniform(size=(m, d)) if wide else rng.normal(size=(m, d)))
    y = t((rng.uniform(size=m) < (0.25 if wide else 0.5)) * 1.0)
    scale = 0.3 * d ** -0.5 if wide else 0.1
    c = torch.from_numpy((rng.normal(size=d) * scale).astype(np.float32)).cuda()
    w = t(rng.uniform(0.5, 2.0, size=m)) if with_wo else None
    o = t(rng.normal(size=m) * 0.1) if with_wo else None
    return x, y, c, w, o


SHAPES = {"scalar": (700, 37), "vec4": (5000, 124), "n3": (3, 124), "n1": (1, 37),
          "n0": (0, 37), "d2048": (20_000, 2048), "dmax": (64, hk.D_MAX),
          "misaligned": (700, 37, 1)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_kernel_matches_plain(cuda, name, with_wo, shape):
    """Tolerances of the Pallas kernel's test: value rtol 1e-5, gradient
    rtol/atol 1e-4 (f32 sums in different orders)."""
    n, d, *skip = SHAPES[shape]
    args = _inputs(n, d, with_wo, skip=skip[0] if skip else 0)
    if skip:
        assert args[0].is_contiguous() and args[0].data_ptr() % 16 != 0
    before = hk.LAUNCHES
    v, g = hk.fused_value_and_gradient(TL.BY_NAME[name], *args)
    assert hk.LAUNCHES == before + 1
    v_p, g_p = hk.fused_value_and_gradient_plain(TL.BY_NAME[name], *args)
    np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_kernel_is_bit_stable(cuda):
    """Back to back, and around a call of another shape (which must find
    the ticket reset by the call before it)."""
    args = _inputs(100_000, 124, True)
    other = _inputs(701, 37, False, skip=1)
    v1, g1 = hk.fused_value_and_gradient(TL.LOGISTIC, *args)
    v2, g2 = hk.fused_value_and_gradient(TL.LOGISTIC, *args)
    vo1, go1 = hk.fused_value_and_gradient(TL.POISSON, *other)
    v3, g3 = hk.fused_value_and_gradient(TL.LOGISTIC, *args)
    vo2, go2 = hk.fused_value_and_gradient(TL.POISSON, *other)
    assert v1.item() == v2.item() == v3.item()
    assert torch.equal(g1, g2) and torch.equal(g1, g3)
    assert vo1.item() == vo2.item() and torch.equal(go1, go2)


# throwaway kernels that open every profiled window, as chip_smoke.py's
# profile_warmup opens its windows: CUPTI loses a window's first device
# records, more the older the process, and the primer absorbs that loss;
# its kernels are left out of every count
PRIMER_LAUNCHES, PRIMER_CYCLES, PRIMER_KERNEL = 1024, 100, "spin_kernel"


def _open_window(prof):
    """End the profiler's warm-up step (its events are dropped: CUPTI's
    device tracing takes a moment to start), then open the window with
    PRIMER_LAUNCHES sleep kernels and wait for them by polling."""
    import time
    torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize()
    prof.step()
    for _ in range(PRIMER_LAUNCHES):
        torch.cuda._sleep(PRIMER_CYCLES)
    stream = torch.cuda.current_stream()
    while not stream.query():
        time.sleep(1e-4)


def _window_names(prof):
    """The names of the window's device events, the primer's left out."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and PRIMER_KERNEL not in e.name]


def _device_events(run):
    """The device events (key_averages) of run() under torch.profiler, in
    a primed window after a warm-up step (_open_window), the primer's
    left out."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        _open_window(prof)
        run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count
            and PRIMER_KERNEL not in e.key]


def test_one_device_launch_per_call(cuda):
    args = _inputs(50_000, 124, True)
    hk.fused_value_and_gradient(TL.LOGISTIC, *args)  # build, workspace
    torch.cuda.synchronize()
    device = _device_events(lambda: [hk.fused_value_and_gradient(TL.LOGISTIC, *args)
                                     for _ in range(3)])
    assert all("fvg_" in e.key for e in device), [e.key for e in device]
    assert sum(e.count for e in device) == 3


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, y, c, _, _ = _inputs(64, 8, False)
    with pytest.raises(TypeError, match="float32"):
        hk.fused_value_and_gradient(TL.LOGISTIC, x.double(), y, c)
    with pytest.raises(ValueError, match="contiguous"):
        hk.fused_value_and_gradient(TL.LOGISTIC, x.T.contiguous().T, y, c)
    with pytest.raises(ValueError, match="d <="):
        hk.fused_value_and_gradient(TL.LOGISTIC, torch.zeros((2, hk.D_MAX + 1), device="cuda"),
                                    y[:2], torch.zeros(hk.D_MAX + 1, device="cuda"))


def test_train_glm_launches_the_kernel_per_pass(cuda):
    from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.optim.config import RegularizationContext, RegularizationType
    x, y = make_a1a_like(4, seed=42)
    hk.LAUNCHES = 0
    tr = train_glm(x, y, "logistic_regression",
                   regularization=RegularizationContext(RegularizationType.L2),
                   regularization_weights=(1.0,))
    assert tr[0].result.fg_count == hk.LAUNCHES > 0
    assert tr[0].model.coefficients.means.is_cuda


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("norm", ["none", "factors", "shifts", "both"])
def test_aggregator_dispatch_on_card(cuda, norm, mask):
    """The kernel serves every dense objective, masked or normalized
    (factors folded in, the shift read by the kernel), in one launch; the
    card's result equals the CPU's (f32 tolerances as above)."""
    from photon_ml_tpu_torch.ops import aggregators as agg
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    x, y, c, w, o = _inputs(3000, 124, True)
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.uniform(0.5, 2.0, 124).astype(np.float32)).cuda()
    s = torch.from_numpy((rng.normal(size=124) * 0.3).astype(np.float32)).cuda()
    ctx = {"none": None,
           "factors": NormalizationContext(f, None, 123),
           "shifts": NormalizationContext(None, s, 123),
           "both": NormalizationContext(f, s, 123)}[norm]
    m = (torch.arange(3000, device="cuda") < 2900).float() if mask else None
    kw = dict(weights=w, offsets=o, norm=ctx, mask=m)
    before = hk.LAUNCHES
    v, g = agg.value_and_gradient(TL.LOGISTIC, x, y, c, **kw)
    assert hk.LAUNCHES - before == 1
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    kw_cpu = {k: cpu(a) for k, a in kw.items()}
    if ctx is not None:
        kw_cpu["norm"] = ctx.to("cpu")
    v_c, g_c = agg.value_and_gradient(TL.LOGISTIC, x.cpu(), y.cpu(), c.cpu(), **kw_cpu)
    np.testing.assert_allclose(v.item(), v_c.item(), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_c.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["logistic_l2", "logistic_elastic_net",
                                  "logistic_l2_tron", "poisson_l2_tron_warm",
                                  "poisson_l2_box_warm"])
def test_batched_solver_on_card_matches_cpu_f64(cuda, case):
    """The batched random-effect solver (LBFGS, OWLQN, TRON, LBFGS in a
    box) in float32 on the card lands where the float64 CPU solve does,
    lane by lane: x within 1e-3, the same convergence reason.  At tolerance
    1e-3 the convergence tests sit far above float32 rounding (tighter,
    whether a lane stops by the gradient or by the f-change rule is a
    rounding coin flip)."""
    import game_jax_side as side
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType)
    from photon_ml_tpu_torch.parallel import random_effect as tre
    loss, reg, alpha, lam, _, opt = side.SOLVER_CASES[case]
    opt = dict(opt, max_iterations=100, tolerance=1e-3)
    if "optimizer" in opt:
        opt["optimizer"] = OptimizerType(opt["optimizer"])
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        t = {k: torch.from_numpy(v).to(device=dev, dtype=dt)
             for k, v in side.solver_problem(case).items()}
        blocks = tre.EntityBlocks(t["x"], t["labels"], t["mask"], t["weights"], t["offsets"])
        out[dev] = tre.fit_random_effects(
            blocks, TL.BY_NAME[loss], x0=t["x0"],
            config=OptimizerConfig(**opt),
            reg=RegularizationContext(RegularizationType(reg), alpha), reg_weight=lam)
    c, g = out["cpu"], out["cuda"]
    assert g.x.is_cuda and g.x.dtype == torch.float32
    np.testing.assert_allclose(g.x.double().cpu().numpy(), c.x.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(g.reason.cpu().numpy(), c.reason.numpy())


@pytest.mark.parametrize("task", ["linear_regression", "poisson_regression"])
def test_train_glm_tron_on_card_matches_cpu_f64(cuda, task):
    """train_glm with TRON in float32 on the card against the CPU in
    float64 (make_a1a_like(4, task, seed=52), L2 lambda 1, TRON at its
    defaults): coefficients within 1e-3, objective within rtol 1e-5, and
    one kernel launch per value+gradient pass: iterations + 1 (the
    Hessian-vector products are tensor ops)."""
    from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType)
    x, y = make_a1a_like(4, task.split("_")[0], seed=52)
    kw = dict(optimizer_config=OptimizerConfig(optimizer=OptimizerType.TRON),
              regularization=RegularizationContext(RegularizationType.L2),
              regularization_weights=(1.0,))
    cpu = train_glm(x.astype(np.float64), y.astype(np.float64), task, device="cpu", **kw)[0]
    before = hk.LAUNCHES
    card = train_glm(x, y, task, **kw)[0]
    assert hk.LAUNCHES - before == card.result.iterations + 1 > 1
    assert card.result.fg_count is None and card.result.hv_count > 0
    np.testing.assert_allclose(card.model.coefficients.means.double().cpu().numpy(),
                               cpu.model.coefficients.means.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(card.result.value.item(), cpu.result.value.item(), rtol=1e-5)


def _movielens(n_rows):
    import game_jax_side as side
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
    from photon_ml_tpu_torch.game import GameTrainingConfig
    train, val = side.movielens_glmix(build_game_dataset, make_movielens_like,
                                      movielens_shards, n_rows)
    return train, val, GameTrainingConfig.from_dict(side.glmix_config_dict())


def test_fixed_effect_update_launches_the_kernel_per_pass(cuda):
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    train, _, cfg = _movielens(20_000)
    coord = FixedEffectCoordinate("fixed", train, cfg.coordinates["fixed"],
                                  "logistic_regression", device="cuda")
    offsets = torch.linspace(-0.5, 0.5, train.num_rows, device="cuda")
    before = hk.LAUNCHES
    model, res = coord.update(coord.initial_model(), offsets)
    assert hk.LAUNCHES - before == res.fg_count > 1
    assert model.glm.coefficients.means.is_cuda


def test_glmix_fit_on_card_matches_cpu_f64(cuda):
    """GameEstimator.fit on the card in float32 against the CPU in float64
    (config 4's coordinates at 3,000 rows): objective history within
    rtol 1e-4, validation AUC within 1e-3, fixed-effect launches equal to
    the fixed-effect passes."""
    from photon_ml_tpu_torch.game import GameEstimator
    train, val, cfg = _movielens(3000)
    cpu = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
    before = hk.LAUNCHES
    card = GameEstimator(cfg).fit(train, val, ["AUC"])
    passes = sum(t.fg_count for k, t in card.descent.trackers.items()
                 if k.endswith("/fixed"))
    assert hk.LAUNCHES - before == passes > 0
    np.testing.assert_allclose(card.objective_history, cpu.objective_history, rtol=1e-4)
    assert abs(card.validation["AUC"] - cpu.validation["AUC"]) <= 1e-3


def test_glmix_tron_fit_on_card_matches_cpu_f64(cuda):
    """The same with TRON on both coordinates: objective history within
    rtol 1e-4, fixed-effect launches equal to its iterations + 1 per
    solve, Hv rounds reported per random-effect bucket."""
    import game_jax_side as side
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    train, val, _ = _movielens(3000)
    cfg = GameTrainingConfig.from_dict(side.tron_config_dict())
    cpu = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
    before = hk.LAUNCHES
    card = GameEstimator(cfg).fit(train, val, ["AUC"])
    fixed = [t for k, t in card.descent.trackers.items() if k.endswith("/fixed")]
    assert hk.LAUNCHES - before == sum(t.iterations + 1 for t in fixed) > 0
    assert all(b.hv_rounds is not None for k, t in card.descent.trackers.items()
               if k.endswith("/perUser") for b in t.buckets)
    np.testing.assert_allclose(card.objective_history, cpu.objective_history, rtol=1e-4)


def test_kronecker_products_on_card_match_cpu_f64(cuda):
    """The factored refit's implicit design on the card (torch matrix
    products, float32) against the CPU in float64: matvec, rmatvec and
    sq_rmatvec within rtol 1e-5 of each output's scale."""
    from photon_ml_tpu_torch.ops import features as F
    rng = np.random.default_rng(5)
    x, f = rng.normal(size=(20_000, 21)), rng.normal(size=(20_000, 8))
    v, u = rng.normal(size=8 * 21), rng.normal(size=20_000)
    cpu = F.KroneckerDesign(torch.from_numpy(x), torch.from_numpy(f))
    card = cpu.to("cuda", torch.float32)
    assert card.is_cuda
    for op, arg in ((F.matvec, v), (F.rmatvec, u), (F.sq_rmatvec, u)):
        want = op(cpu, torch.from_numpy(arg)).numpy()
        got = op(card, torch.from_numpy(arg).float().cuda()).double().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_factored_fit_on_card_matches_cpu_f64(cuda):
    """Config 5's full sequence at 3,000 rows (game_jax_side.py "warm":
    fixed + perUser + perItem + the factored perUserMF) on the card in
    float32 against the CPU in float64: the factored coordinate is
    warm-started from perUser on both, the final objective within rtol
    1e-3 (the factored coordinate is not convex, so the float32 path may
    end a little apart), fixed-effect launches equal to its passes."""
    import game_jax_side as side
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    train, val = side.movielens_game(build_game_dataset, make_movielens_like,
                                     movielens_shards)
    cfg = GameTrainingConfig.from_dict(side.factored_config_dict("warm"))
    cpu = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
    before = hk.LAUNCHES
    card = GameEstimator(cfg).fit(train, val, ["AUC"])
    passes = sum(t.fg_count for k, t in card.descent.trackers.items()
                 if k.endswith("/fixed"))
    assert hk.LAUNCHES - before == passes > 0
    assert card.descent.warm_starts == cpu.descent.warm_starts == {"perUserMF": "perUser"}
    assert np.all(np.isfinite(card.objective_history))
    np.testing.assert_allclose(card.objective_history[-1], cpu.objective_history[-1],
                               rtol=1e-3)
    mf = card.descent.model.coordinates["perUserMF"]
    assert mf.latent_coefficients.is_cuda and mf.projection.is_cuda


# ------------------------------------------- sparse kernels (csrc/ell_sparse.cu)

def _sparse(n, d, k, seed=3, intercept=False, from_ell=False):
    """A PaddedSparse on the card with <= k nonzeros per row (rows 0 and 2
    empty when n > 2, column 1 empty), optionally an all-ones last column
    (it spans kernel B's tiles once n > 2048); its column view from scipy,
    or built from the ELL arrays (padding slots in column 0's segment)."""
    import scipy.sparse as sp
    from photon_ml_tpu_torch.ops.features import PaddedSparse
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, k + 1, size=n)
    if n > 2:
        counts[[0, 2]] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(2 if d > 2 else 0, d, size=rows.size)
    x = sp.csr_matrix((rng.uniform(0.2, 1.0, size=rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, d))
    if intercept:
        x = x.tolil()
        x[:, d - 1] = 1.0
        x = x.tocsr()
    if from_ell:
        return PaddedSparse.from_scipy(x, device="cuda").with_csc()
    return PaddedSparse.from_scipy(x, with_csc=True, device="cuda")


SPARSE_SHAPES = {"n0": (0, 37, 5), "n1": (1, 37, 5), "n3": (3, 37, 5),
                 "700x37": (700, 37, 5), "ell_view": (700, 37, 5),
                 "intercept": (20_000, 300, 8), "wide": (20_000, 250_000, 64)}


def _sparse_case(shape):
    n, d, k = SPARSE_SHAPES[shape]
    return _sparse(n, d, k, intercept=shape in ("intercept", "wide"),
                   from_ell=shape == "ell_view")


@pytest.mark.parametrize("shape", list(SPARSE_SHAPES))
@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_sparse_kernels_match_plain(cuda, name, with_wo, shape):
    """Kernel A in loss mode, then B over its u, against the plain versions
    on the same inputs: value rtol 1e-5 and u rtol/atol 1e-4 (as the dense
    kernel), g per column within column_sum_tolerance (2 sqrt(count) eps
    sum|terms|)."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _sparse_case(shape)
    n, d = x.shape
    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    y = t((rng.uniform(size=n) < 0.3) * 1.0)
    c = t(rng.normal(size=d) * 0.3 / np.sqrt(SPARSE_SHAPES[shape][2]))
    w = t(rng.uniform(0.5, 2.0, size=n)) if with_wo else None
    o = t(rng.normal(size=n) * 0.1) if with_wo else None
    loss = TL.BY_NAME[name]
    before = dict(sk.LAUNCHES)
    v, u = sk.ell_margin_loss(loss, x.indices, x.values, c, y, w, o)
    g = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1)
    assert sk.LAUNCHES["margin_loss"] == before["margin_loss"] + 1
    assert sk.LAUNCHES["column_sum"] == before["column_sum"] + 1
    v_p, u_p = sk.ell_margin_loss_plain(loss, x.indices, x.values, c, y, w, o)
    g_p = sk.csc_column_sum_plain(x.csc_row, x.csc_val, x.csc_end, u, 1)
    np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u.cpu().numpy(), u_p.cpu().numpy(), rtol=1e-4, atol=1e-4)
    tol = sk.column_sum_tolerance(x.csc_row, x.csc_val, x.csc_end, u, 1)
    assert bool(((g.double() - g_p.double()).abs() <= tol + 1e-30).all())
    if shape == "n1" or shape == "n3" or shape == "700x37":
        assert float(g[1]) == 0.0  # the empty column


@pytest.mark.parametrize("shape", ["n0", "n3", "700x37", "ell_view", "intercept", "wide"])
def test_sparse_margins_and_squared_sums_match_plain(cuda, shape):
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _sparse_case(shape)
    n, d = x.shape
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.normal(size=d).astype(np.float32)).cuda()
    o = torch.from_numpy(rng.normal(size=n).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.uniform(-1, 1, size=n).astype(np.float32)).cuda()
    z = sk.ell_margins(x.indices, x.values, c, o)
    z_p = sk.ell_margins_plain(x.indices, x.values, c, o)
    assert bool(((z.double() - z_p.double()).abs()
                 <= sk.margins_tolerance(x.indices, x.values, c, o) + 1e-30).all())
    for power in (1, 2):
        g = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, power)
        g_p = sk.csc_column_sum_plain(x.csc_row, x.csc_val, x.csc_end, u, power)
        tol = sk.column_sum_tolerance(x.csc_row, x.csc_val, x.csc_end, u, power)
        assert bool(((g.double() - g_p.double()).abs() <= tol + 1e-30).all()), power


def test_sparse_kernels_are_bit_stable(cuda):
    """Two calls of each, around a call at another shape (which must find
    the ticket reset by the call before it): identical bits."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x, other = _sparse_case("wide"), _sparse_case("700x37")
    n, d = x.shape
    rng = np.random.default_rng(6)
    y = torch.from_numpy((rng.uniform(size=n) < 0.3).astype(np.float32)).cuda()
    c = torch.from_numpy((rng.normal(size=d) * 0.05).astype(np.float32)).cuda()

    def run():
        v, u = sk.ell_margin_loss(TL.LOGISTIC, x.indices, x.values, c, y)
        g = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1)
        h = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 2)
        return v, u, g, h, sk.ell_margins(x.indices, x.values, c)

    first = run()
    sk.ell_margin_loss(TL.POISSON, other.indices, other.values,
                       torch.zeros(other.shape[1], device="cuda"),
                       torch.ones(other.shape[0], device="cuda"))
    second = run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


_PROFILE_PASSES = """
import json, sys
sys.path.insert(0, "tests/port")
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from photon_ml_tpu_torch.ops import aggregators as agg, losses as TL
from test_torch_cuda import _open_window, _sparse_case, _window_names
x = _sparse_case("intercept")
n, d = x.shape
y = (torch.arange(n, device="cuda") % 3 == 0).float()
c = torch.full((d,), 0.01, device="cuda")
agg.value_and_gradient(TL.LOGISTIC, x, y, c)  # build, workspace
torch.cuda.synchronize()
# a warm-up step, then a primed window (_open_window)
with profile(activities=[ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1)) as prof:
    _open_window(prof)
    for _ in range(3):
        agg.value_and_gradient(TL.LOGISTIC, x, y, c)
    torch.cuda.synchronize()
print(json.dumps(_window_names(prof)))
"""


def test_sparse_pass_is_two_device_launches(cuda):
    """value_and_gradient on a CUDA PaddedSparse: kernel A then kernel B,
    and nothing else on the device.  Profiled in a process of its own: in
    a process that has run much else, torch.profiler has recorded a few of
    the first sparse launches of a window fewer than were made."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", _PROFILE_PASSES], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) == 6, names
    assert sum("ell_margin_loss" in k for k in names) == 3, names
    assert sum("csc_column_sum" in k for k in names) == 3, names


def _stream_of(nnz: int, n: int = 600, d: int = 40, seed: int = 7):
    """A PaddedSparse on the card whose column view holds exactly `nnz`
    nonzeros: an all-ones last column (n of them, spanning kernel B's
    tiles once nnz > 2048) and nnz - n at distinct random cells."""
    import scipy.sparse as sp
    from photon_ml_tpu_torch.ops.features import PaddedSparse
    rng = np.random.default_rng(seed)
    cells = rng.choice(n * (d - 1), size=nnz - n, replace=False)
    rows = np.concatenate([cells // (d - 1), np.arange(n)])
    cols = np.concatenate([cells % (d - 1), np.full(n, d - 1)])
    vals = np.concatenate([rng.uniform(0.2, 1.0, size=nnz - n), np.ones(n)])
    x = sp.csr_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, d))
    return PaddedSparse.from_scipy(x, with_csc=True, device="cuda")


@pytest.mark.parametrize("nnz", [2047, 2048, 2049])
def test_column_sum_at_tile_lengths_matches_plain(cuda, nnz):
    """Kernel B one short of, exactly and one past a tile of the stream
    (2049: a ragged last run), powers 1 and 2, within column_sum_tolerance."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _stream_of(nnz)
    assert x.csc_row.numel() == nnz
    u = torch.linspace(-1.0, 1.0, x.shape[0], device="cuda")
    for power in (1, 2):
        g = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, power, x.csc_tiles)
        g_p = sk.csc_column_sum_plain(x.csc_row, x.csc_val, x.csc_end, u, power)
        tol = sk.column_sum_tolerance(x.csc_row, x.csc_val, x.csc_end, u, power)
        assert bool(((g.double() - g_p.double()).abs() <= tol + 1e-30).all()), power


def test_column_sum_refuses_a_misaligned_view(cuda):
    """Kernel B loads the stream 16 bytes at a time: a view that starts
    4 bytes into the arrays raises in the wrapper; nothing is copied."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _stream_of(2049)
    u = torch.ones(x.shape[0], device="cuda")
    before = dict(sk.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        sk.csc_column_sum(x.csc_row[1:], x.csc_val[1:], x.csc_end, u)
    assert sk.LAUNCHES == before


def test_tile_map_moves_with_the_matrix(cuda):
    """.to("cuda") carries the host-built tile map; the wrapper takes it,
    and refuses one of the wrong length."""
    import scipy.sparse as sp
    from photon_ml_tpu_torch.ops import features as fops
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = sp.random(3000, 500, density=0.02, format="csr", random_state=3, dtype=np.float32)
    cpu = fops.PaddedSparse.from_scipy(x, with_csc=True, device="cpu")
    card = cpu.to("cuda")
    assert card.csc_tiles.device.type == "cuda"
    assert torch.equal(card.csc_tiles.cpu(), cpu.csc_tiles)
    u = torch.linspace(-1.0, 1.0, 3000, device="cuda")
    g = fops.rmatvec(card, u)
    assert torch.equal(g, sk.csc_column_sum(card.csc_row, card.csc_val, card.csc_end, u))
    with pytest.raises(ValueError, match="tile map"):
        sk.csc_column_sum(card.csc_row, card.csc_val, card.csc_end, u, 1,
                          card.csc_tiles[:-1])


_PROFILE_COLUMN_SUM = """
import json, sys
sys.path.insert(0, "tests/port")
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from photon_ml_tpu_torch.ops import sparse_kernels as sk
from test_torch_cuda import _open_window, _sparse_case, _window_names
x = _sparse_case("intercept")
u = torch.linspace(-1.0, 1.0, x.shape[0], device="cuda")
sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1, x.csc_tiles)  # build, workspace
torch.cuda.synchronize()
# a warm-up step, then a primed window (_open_window)
with profile(activities=[ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1)) as prof:
    _open_window(prof)
    sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1, x.csc_tiles)
    torch.cuda.synchronize()
print(json.dumps(_window_names(prof)))
"""


def test_column_sum_is_one_device_launch(cuda):
    """One call of kernel B, columns spanning tiles included, is one
    device launch and nothing else (profiled in a process of its own, as
    the pass above)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", _PROFILE_COLUMN_SUM], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "csc_column_sum" in names[0], names


def test_sparse_wrappers_refuse_what_they_do_not_take(cuda):
    from photon_ml_tpu_torch.ops import features as fops
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _sparse_case("700x37")
    c = torch.zeros(x.shape[1], device="cuda")
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match=f"got {dtype}"):
            sk.ell_margins(x.indices, x.values.to(dtype), c)
        with pytest.raises(TypeError, match=f"got {dtype}"):
            sk.csc_column_sum(x.csc_row, x.csc_val.to(dtype), x.csc_end,
                              torch.ones(x.shape[0], device="cuda"))
    with pytest.raises(TypeError, match="int32"):
        sk.ell_margins(x.indices.long(), x.values, c)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ell_margins(x.indices.T.contiguous().T, x.values.T.contiguous().T, c)
    with pytest.raises(ValueError, match="no column view"):
        fops.rmatvec(x.without_csc(), torch.ones(x.shape[0], device="cuda"))


def test_train_glm_sparse_on_card_matches_cpu_f64(cuda):
    """train_glm on a wide sparse problem in float32 on the card against the
    CPU in float64 (make_wide_sparse_logistic(3000, d=20000, nnz=16), L2
    lambda 1, LBFGS(100, 1e-6)): coefficients within 1e-3, objective rtol
    1e-5, and kernels A and B once per value+gradient pass."""
    from photon_ml_tpu_torch.data.synthetic_bench import make_wide_sparse_logistic
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType)
    x, y = make_wide_sparse_logistic(3000, d=20_000, nnz=16, seed=5)
    kw = dict(optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-6),
              regularization=RegularizationContext(RegularizationType.L2),
              regularization_weights=(1.0,))
    cpu = train_glm(x.astype(np.float64), y.astype(np.float64), "logistic_regression",
                    device="cpu", **kw)[0]
    before = dict(sk.LAUNCHES)
    card = train_glm(x, y, "logistic_regression", **kw)[0]
    fg = card.result.fg_count
    assert sk.LAUNCHES["margin_loss"] - before["margin_loss"] == fg > 1
    assert sk.LAUNCHES["column_sum"] - before["column_sum"] == fg
    np.testing.assert_allclose(card.model.coefficients.means.double().cpu().numpy(),
                               cpu.model.coefficients.means.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(card.result.value.item(), cpu.result.value.item(), rtol=1e-5)


# ------------------------------- kernel A's two c paths (staged rows, lanes)

MARGIN_KS = (1, 2, 8, 25, 32, 33, 64, 65)


def _ell_on_card(n, k, d, seed, skip=0):
    """float32 ELL arrays on the card with <= k nonzeros per row at uniform
    columns (padding: column 0, value 0), made there from a seed; with
    skip=s, rows s.. of a contiguous [n + s, k] pair (a view at a byte
    offset of 4 s k)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = n + skip
    count = torch.randint(1, k + 1, (m, 1), generator=g, device="cuda")
    pad = torch.arange(k, device="cuda")[None, :] >= count
    idx = torch.randint(0, d, (m, k), generator=g, device="cuda", dtype=torch.int32)
    val = 0.2 + 0.8 * torch.rand((m, k), generator=g, device="cuda")
    idx[pad], val[pad] = 0, 0.0
    return idx[skip:], val[skip:]


def _c_path_case(k, side, vbytes=4):
    """(n, d) that put c in shared memory ("smem": staged rows, d at the
    plan's limit) or just past it ("l2": one column more, lanes per row),
    with enough rows that every block gathers more than d and n not a
    multiple of the tile; for values of `vbytes` bytes."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = sk.plan_margins(10 ** 7, k, 1, sms, vbytes).rows
    d = sk.max_smem_cols(k, rows, vbytes) + (side == "l2")
    n = (sms * d) // k // rows * rows + rows + 7
    plan = sk.plan_margins(n, k, d, sms, vbytes)
    assert plan.c_in_smem == (side == "smem") and (side == "l2" or n % plan.rows)
    return n, d


def _a_against_plain(sk, x_idx, x_val, c, y, w, o):
    """Kernel A (every loss, then margins) against its plain version."""
    for name in sorted(TL.BY_NAME):
        loss = TL.BY_NAME[name]
        v, u = sk.ell_margin_loss(loss, x_idx, x_val, c, y, w, o)
        v_p, u_p = sk.ell_margin_loss_plain(loss, x_idx, x_val, c, y, w, o)
        np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(u.cpu().numpy(), u_p.cpu().numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    z = sk.ell_margins(x_idx, x_val, c, o)
    z_p = sk.ell_margins_plain(x_idx, x_val, c, o)
    assert bool(((z.double() - z_p.double()).abs()
                 <= sk.margins_tolerance(x_idx, x_val, c, o) + 1e-30).all())


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("side", ["smem", "l2"])
@pytest.mark.parametrize("k", MARGIN_KS)
def test_margin_kernel_matches_plain_on_both_c_paths(cuda, k, side, with_wo):
    """Kernel A with c staged in shared memory and with c one column too
    wide for it (lanes per row, gathered from L2), every loss and margins
    mode, against
    the plain versions (value rtol 1e-5, u rtol/atol 1e-4, margins within
    margins_tolerance)."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    n, d = _c_path_case(k, side)
    idx, val = _ell_on_card(n, k, d, seed=k)
    g = torch.Generator(device="cuda").manual_seed(100 + k)
    c = torch.randn(d, generator=g, device="cuda") * (0.3 / k ** 0.5)
    y = (torch.rand(n, generator=g, device="cuda") < 0.3).float()
    w = 0.5 + 1.5 * torch.rand(n, generator=g, device="cuda") if with_wo else None
    o = 0.1 * torch.randn(n, generator=g, device="cuda") if with_wo else None
    _a_against_plain(sk, idx, val, c, y, w, o)


@pytest.mark.parametrize("side", ["smem", "l2"])
def test_margin_kernel_is_bit_stable_on_both_c_paths(cuda, side):
    """Two calls around a call at another shape (which must find the ticket
    reset): the same bits, on both c paths."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    n, d = _c_path_case(25, side)
    idx, val = _ell_on_card(n, 25, d, seed=3)
    c = torch.linspace(-0.05, 0.05, d, device="cuda")
    y = (torch.arange(n, device="cuda") % 3 == 0).float()
    o_idx, o_val = _ell_on_card(700, 5, 37, seed=4)
    first = sk.ell_margin_loss(TL.LOGISTIC, idx, val, c, y) + (sk.ell_margins(idx, val, c),)
    sk.ell_margin_loss(TL.POISSON, o_idx, o_val, torch.zeros(37, device="cuda"),
                       torch.ones(700, device="cuda"))
    second = sk.ell_margin_loss(TL.LOGISTIC, idx, val, c, y) + (sk.ell_margins(idx, val, c),)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [3, 25, 201])
def test_margin_kernel_takes_a_misaligned_view(cuda, k):
    """Rows 1.. of contiguous ELL arrays start 4 k bytes in: kernel A's bulk
    copies take the 16-byte aligned interior and ordinary loads the rest,
    so the view is taken as it is (k = 201: lanes per row)."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    idx, val = _ell_on_card(3001, k, 500, seed=k, skip=1)
    assert idx.is_contiguous() and idx.data_ptr() % 16 != 0
    c = torch.linspace(-0.2, 0.2, 500, device="cuda")
    y = (torch.arange(3001, device="cuda") % 4 == 0).float()
    o = torch.linspace(-0.1, 0.1, 3001, device="cuda")
    _a_against_plain(sk, idx, val, c, y, None, o)


@pytest.mark.parametrize("k", [113, 200, 1000])
def test_long_rows_match_plain(cuda, k):
    """Rows too long for a staged tile (a warp per row) against plain."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    idx, val = _ell_on_card(2000, k, 50_000, seed=k)
    assert sk.plan_margins(2000, k, 50_000, 132).lanes == 32
    c = torch.linspace(-0.02, 0.02, 50_000, device="cuda")
    y = (torch.arange(2000, device="cuda") % 4 == 0).float()
    w = torch.linspace(0.5, 2.0, 2000, device="cuda")
    _a_against_plain(sk, idx, val, c, y, w, None)


@pytest.mark.parametrize("route", ["to", "pad_rows"])
def test_margin_kernel_takes_moved_and_padded_matrices(cuda, route):
    """A matrix built on the host and moved with .to, and one grown by
    pad_rows (fresh arrays, as the GAME and validation paths build them):
    kernel A takes them and agrees with plain."""
    import scipy.sparse as sp
    from photon_ml_tpu_torch.ops import features as fops
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = sp.random(5003, 2000, density=0.01, format="csr", random_state=4, dtype=np.float32)
    m = fops.PaddedSparse.from_scipy(x, device="cpu").to("cuda")
    if route == "pad_rows":
        m = fops.pad_rows(m, 3)
    n, d = m.shape
    c = torch.linspace(-0.3, 0.3, d, device="cuda")
    y = (torch.arange(n, device="cuda") % 2 == 0).float()
    _a_against_plain(sk, m.indices, m.values, c, y, None, None)


# --- the command-line main path on the card ----------------------------------

def _glmix_npz(tmp_path, rows=3000):
    """Config 4's shape at `rows` rows (float32), saved as npz, with its
    configuration JSON."""
    from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
    from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
    from photon_ml_tpu_torch.game import (FixedEffectCoordinateConfig, GameTrainingConfig,
                                          GLMOptimizationConfig, RandomEffectCoordinateConfig)
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType)
    ml = make_movielens_like("1m", seed=11, n_rows=rows)
    shards = {k: v.astype(np.float32) for k, v in movielens_shards(ml).items()
              if k != "per_item"}
    ds = build_game_dataset(ml.response, shards,
                            entity_ids={"userId": np.asarray([str(u) for u in ml.user_ids])})
    cut = int(rows * 0.9)
    save_game_dataset(ds.subset(np.arange(cut)), str(tmp_path / "train.npz"))
    save_game_dataset(ds.subset(np.arange(cut, rows)), str(tmp_path / "val.npz"))
    opt = GLMOptimizationConfig(optimizer=OptimizerConfig(max_iterations=100),
                                regularization=RegularizationContext(RegularizationType.L2),
                                regularization_weight=1.0)
    cfg = GameTrainingConfig(
        task_type="logistic_regression",
        coordinates={"fixed": FixedEffectCoordinateConfig("global", opt),
                     "perUser": RandomEffectCoordinateConfig("userId", "per_user", opt,
                                                             active_data_upper_bound=512)},
        updating_sequence=["fixed", "perUser"], num_outer_iterations=2)
    (tmp_path / "config.json").write_text(cfg.to_json())


def _cli(module, argv):
    import contextlib
    import io
    import json
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main([str(a) for a in argv]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_trains_and_scores_on_the_card_by_default(cuda, tmp_path):
    """cli.train --config with no --device runs on cuda (the fused kernel's
    launches == the fixed effect's passes), pipelined == strict bit for bit,
    and cli.score on the card agrees with the CPU's f64 scoring of the same
    saved model (rtol 1e-4: f32 on the card)."""
    from photon_ml_tpu_torch.cli import score, train
    _glmix_npz(tmp_path)
    common = ["--train-data", tmp_path / "train.npz", "--validation-data",
              tmp_path / "val.npz", "--config", tmp_path / "config.json",
              "--evaluators", "AUC"]
    hk.LAUNCHES = 0
    p = _cli(train, common + ["--output-dir", tmp_path / "p"])
    assert p["device"].startswith("cuda") and p["dtype"] == "float32"
    assert hk.LAUNCHES == p["solver_diagnostics"]["fixed"]["value_gradient_passes"] > 0
    s = _cli(train, common + ["--output-dir", tmp_path / "s", "--timing-mode", "strict"])
    assert p["objective_history"] == s["objective_history"]
    scores = {}
    for dev in ("cuda", "cpu"):
        extra = ["--device", dev] + (["--x64"] if dev == "cpu" else [])
        _cli(score, ["--model-dir", tmp_path / "p" / "best", "--data", tmp_path / "val.npz",
                     "--output", tmp_path / f"{dev}.npz", *extra])
        scores[dev] = np.load(tmp_path / f"{dev}.npz")["scores"]
    np.testing.assert_allclose(scores["cuda"], scores["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["npz", "avro", "reference"])
def test_load_game_model_lands_on_the_card(cuda, tmp_path, fmt):
    """load_game_model(device=None) puts every coordinate on cuda in
    float32, whatever the layout; device="cpu" keeps it on the host."""
    from photon_ml_tpu_torch.models import game
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.glm import model_for_task
    from photon_ml_tpu_torch.models.io import load_game_model, save_game_model
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a)
    model = game.GameModel({
        "fixed": game.FixedEffectModel(model_for_task(
            "logistic_regression", Coefficients(t(rng.normal(size=5)))), "global"),
        "perUser": game.RandomEffectModel(
            random_effect_type="userId", feature_shard="per_user",
            task_type="logistic_regression", coefficients=t(rng.normal(size=(3, 4))),
            entity_ids=np.asarray(["a", "b", "c"], dtype=object), projection=None,
            global_dim=4)}, "logistic_regression")
    save_game_model(model, str(tmp_path / fmt), format=fmt)
    on_card, _ = load_game_model(str(tmp_path / fmt))
    for c in (on_card.coordinates["fixed"].glm.coefficients.means,
              on_card.coordinates["perUser"].coefficients):
        assert c.is_cuda and c.dtype == torch.float32
    on_host, _ = load_game_model(str(tmp_path / fmt), device="cpu", dtype=torch.float64)
    assert not on_host.coordinates["perUser"].coefficients.is_cuda
    torch.testing.assert_close(on_card.coordinates["perUser"].coefficients.cpu(),
                               on_host.coordinates["perUser"].coefficients.float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_nan_coefficients_follow_the_plain_version(cuda, name):
    """A NaN in c (a poisoned model): the kernel's value and gradient are
    non-finite exactly where the plain version's are; non-finite for every
    loss but the smoothed hinge, which maps a NaN margin to 0 in the JAX
    package's loss, the plain version and the kernel alike."""
    loss = TL.BY_NAME[name]
    x, y, c, _, _ = _inputs(700, 37, False, seed=4)
    c[5] = float("nan")
    v_k, g_k = hk.fused_value_and_gradient(loss, x, y, c)
    v_p, g_p = hk.fused_value_and_gradient_plain(loss, x, y, c)
    assert bool(torch.isfinite(v_k)) == bool(torch.isfinite(v_p))
    assert torch.equal(torch.isfinite(g_k), torch.isfinite(g_p))
    assert bool(torch.isfinite(v_k)) == (name == "smoothed_hinge")


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron"])
def test_capped_solve_on_card_matches_cpu_f64(cuda, kind):
    """A solve under a cap of 3 iterations on the card in float32 against
    the CPU in float64: the same iterations, x and the loss history within
    1e-4, one kernel launch per pass."""
    import game_jax_side as side
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType, solve)
    from photon_ml_tpu_torch.optim.schedule import SolveBudget
    p = side.cap_problem()
    opt, reg = side.CAP_SINGLE[kind]
    opt = dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs")))
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        obj = GLMObjective(TL.BY_NAME["logistic"],
                           torch.from_numpy(p["x"]).to(device=dev, dtype=dt),
                           torch.from_numpy(p["y"]).to(device=dev, dtype=dt))
        before = hk.LAUNCHES
        out[dev] = solve(obj, torch.zeros(p["x"].shape[1], device=dev, dtype=dt),
                         OptimizerConfig(**opt), RegularizationContext(RegularizationType(reg)),
                         1.0, budget=SolveBudget.make(3, opt["tolerance"]))
        launches = hk.LAUNCHES - before
    c, g = out["cpu"], out["cuda"]
    assert g.iterations == c.iterations == 3
    passes = g.fg_count if g.fg_count is not None else g.iterations + 1
    assert launches == passes
    np.testing.assert_allclose(g.x.double().cpu().numpy(), c.x.numpy(), rtol=0, atol=1e-4)
    k = c.iterations + 1
    np.testing.assert_allclose(g.loss_history[:k].double().cpu().numpy(),
                               c.loss_history[:k].numpy(), rtol=1e-4)


def test_scheduled_glmix_fit_on_card_matches_cpu_f64(cuda):
    """A scheduled GameEstimator.fit (config 4's coordinates at 3,000 rows,
    SolverSchedule(initial_iterations=3), three outer iterations) on the
    card in float32 against the CPU in float64: the same caps, the
    objective history within rtol 1e-4, fixed-effect launches equal to the
    fixed-effect passes."""
    import dataclasses
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.optim.schedule import SolverSchedule
    train, val, cfg = _movielens(3000)
    cfg = dataclasses.replace(cfg, num_outer_iterations=3,
                              solver_schedule=SolverSchedule(initial_iterations=3))
    cpu = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
    before = hk.LAUNCHES
    card = GameEstimator(cfg).fit(train, val, ["AUC"])
    passes = sum(t.fg_count for k, t in card.descent.trackers.items()
                 if k.endswith("/fixed"))
    assert hk.LAUNCHES - before == passes > 0
    caps = lambda r: {c: d["iteration_caps"] for c, d in r.descent.solver_diagnostics().items()}
    assert caps(card) == caps(cpu) == {"fixed": [3, 6, 100], "perUser": [3, 6, 100]}
    np.testing.assert_allclose(card.objective_history, cpu.objective_history, rtol=1e-4)


@pytest.mark.parametrize("inputs", ["mask", "shift", "mask+shift"])
@pytest.mark.parametrize("shape", ["scalar", "vec4", "misaligned", "d2048"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_kernel_with_mask_and_shift_matches_plain(cuda, name, shape, inputs):
    """The row mask (about 30 % zeros, and a masked row whose loss is not
    finite) and the normalization shift, at the kernel test's tolerances;
    one launch per call."""
    n, d, *skip = SHAPES[shape]
    x, y, c, w, o = _inputs(n, d, True, skip=skip[0] if skip else 0)
    rng = np.random.default_rng(5)
    m = s = None
    if "mask" in inputs:
        m = torch.from_numpy((rng.uniform(size=n) > 0.3).astype(np.float32)).cuda()
        m[1] = 0.0
        o = o.clone()
        o[1] = float("inf")
    if "shift" in inputs:
        s = torch.from_numpy((rng.normal(size=d) * 0.3).astype(np.float32)).cuda()
    before = hk.LAUNCHES
    v, g = hk.fused_value_and_gradient(TL.BY_NAME[name], x, y, c, w, o, m, s)
    assert hk.LAUNCHES == before + 1
    v_p, g_p = hk.fused_value_and_gradient_plain(TL.BY_NAME[name], x, y, c, w, o, m, s)
    assert np.isfinite(v.item())
    np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5)
    # with shifts the gradient subtracts s * sum(w l') from X^T(w l'): its
    # f32 error scales with those terms (chip_smoke.shifted_gradient_scale)
    if s is None:
        scale = g_p.abs().cpu().numpy()
    else:
        import chip_smoke
        scale = chip_smoke.shifted_gradient_scale(TL.BY_NAME[name], x, y, c, w, o, m, s)
    err = np.abs(g.double().cpu().numpy() - g_p.double().cpu().numpy())
    assert np.all(err <= 1e-4 + 1e-4 * scale), (err / (1e-4 + 1e-4 * scale)).max()


@pytest.mark.parametrize("inputs", ["mask", "standardization"])
def test_masked_or_standardized_dense_pass_is_one_launch(cuda, inputs, monkeypatch):
    """ops/aggregators.value_and_gradient on a dense CUDA X with a mask or
    a standardization (factors and shifts) launches the fused kernel once
    and no product over X outside it."""
    from photon_ml_tpu_torch.ops import aggregators as agg
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    n = 200_000
    x, y, c, w, o = _inputs(n, 124, True)
    kw = dict(weights=w, offsets=o)
    if inputs == "mask":
        kw["mask"] = (torch.arange(n, device="cuda") % 4 != 0).float()
    else:
        f = torch.rand(124, device="cuda") + 0.5
        s = torch.randn(124, device="cuda") * 0.2
        kw["norm"] = NormalizationContext(f, s, 123)
    from photon_ml_tpu_torch.ops import features as fops

    def refuse(*args, **kwargs):
        raise AssertionError("a product over X outside the kernel")
    monkeypatch.setattr(fops, "matvec", refuse)
    monkeypatch.setattr(fops, "rmatvec", refuse)
    before = hk.LAUNCHES
    v, g = agg.value_and_gradient(TL.LOGISTIC, x, y, c, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES == before + 1 and np.isfinite(v.item())


def _stream_problem(n=200_000, d=124, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, d)) < 0.115).astype(np.float32)
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 0.25).astype(np.float32)
    return x, y


def test_streamed_pass_holds_at_most_two_chunks(cuda):
    """Peak allocated during a streamed solve is at most `depth` chunks +
    the solver state + 1 MiB: the ring of device slots holds on CUDA, with
    chunks whose kernels may still run counted."""
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType)
    from photon_ml_tpu_torch.optim.streaming import solve_streamed
    x, y = _stream_problem()
    plan = ChunkPlan.build(len(y), chunk_rows=16384)
    obj = ChunkedGLMObjective(TL.LOGISTIC, x, y, plan)
    c0 = torch.zeros(x.shape[1], device="cuda")
    obj.value_and_gradient(c0)  # kernel build, workspace, pinned ring
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = hk.LAUNCHES
    res = solve_streamed(obj, c0, OptimizerConfig(max_iterations=20, tolerance=1e-9),
                         RegularizationContext(RegularizationType.L2), 1.0)
    torch.cuda.synchronize()
    chunk = plan.chunk_rows * (x.shape[1] + 2) * 4       # x, labels, mask
    state = 4 * x.shape[1] * (2 * 10 + 16)               # curvature pairs + vectors
    assert torch.cuda.max_memory_allocated() - base <= 2 * chunk + state + (1 << 20)
    assert hk.LAUNCHES - before == res.fg_count * plan.num_chunks
    assert obj.stats.peak_resident_chunks == 2


def test_streamed_solve_on_card_matches_cpu_f64(cuda):
    """solve_streamed (LBFGS, L2 1) on the card in float32 from registered
    host memory, against the same stream on the CPU in float64: x within
    1e-4 and the final objective within 1e-4 relative."""
    from photon_ml_tpu_torch.data.streaming import ChunkPlan, is_pinned
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType)
    from photon_ml_tpu_torch.optim.streaming import solve_streamed
    x, y = _stream_problem(60_000, 37)
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        obj = ChunkedGLMObjective(TL.LOGISTIC, x, y, ChunkPlan.build(len(y), chunk_rows=8192),
                                  device=dev, dtype=dt)
        out[dev] = solve_streamed(obj, torch.zeros(37, device=dev, dtype=dt),
                                  OptimizerConfig(max_iterations=100, tolerance=1e-9),
                                  RegularizationContext(RegularizationType.L2), 1.0)
        if dev == "cuda":
            assert is_pinned(obj.x[:10])
            assert obj.staging.route_bytes["registered"] > 0
    c, g = out["cpu"], out["cuda"]
    np.testing.assert_allclose(g.x.double().cpu().numpy(), c.x.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(g.value), float(c.value), rtol=1e-4)


def test_staging_never_writes_memory_queued_kernels_still_read(cuda):
    """A tensor freed on the consumer's stream while a queued kernel still
    reads it (behind a long sleep) is never handed to the copy stream's
    chunk slots: the queued read sees its own data, and the pass is the
    same as on an idle card."""
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    x, y = _stream_problem(100_000, 124)
    obj = ChunkedGLMObjective(TL.LOGISTIC, x, y, ChunkPlan.build(len(y), chunk_rows=16384))
    c = torch.full((124,), 0.01, device="cuda")
    want = obj.value_and_gradient(c)
    torch.cuda.synchronize()
    a = torch.full((16384 * 126,), 3.0, device="cuda")
    torch.cuda._sleep(200_000_000)          # ~0.1 s of queued work
    b = a * 2.0                              # reads `a` after the sleep
    del a                                    # freed while that read is queued
    got = obj.value_and_gradient(c)
    torch.cuda.synchronize()
    assert bool((b == 6.0).all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the candidate-lanes kernel and the sweep's candidate lane ---------------

def _lanes_inputs(n, d, lanes, seed=5, skip=0):
    """X, y, C [K, d], w, O [K, n], a row mask (30 % zeros, the masked rows'
    offsets infinite) and per-lane shifts on the card, float32."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = t(rng.normal(size=(n + skip, d)))[skip:]
    y = t(rng.uniform(size=n + skip) < 0.5)[skip:]
    c = t(rng.normal(size=(lanes, d)) * (0.3 * d ** -0.5 if d > 124 else 0.1))
    w = t(rng.uniform(0.5, 2.0, size=n + skip))[skip:]
    m = rng.uniform(size=n) > 0.3
    o = np.where(m[None, :], rng.normal(size=(lanes, n)) * 0.1, np.inf)
    return x, y, c, w, t(o), t(m), t(rng.normal(size=lanes) * 0.1)


LANES_SHAPES = {"700x37": (700, 37), "misaligned": (700, 37, 1), "n1": (1, 31),
                "n0": (0, 31), "5000x124": (5000, 124), "256": (3000, 256),
                # the tensor-core tiles' edges: widths around the 8-column
                # chunks and 16-column tiles, odd row counts (ragged tiles,
                # misaligned runs of O), a misaligned view at another width
                "d1": (333, 1), "d7": (333, 7), "d8": (333, 8), "d9": (333, 9),
                "d9_misaligned": (333, 9, 1), "d31": (1001, 31), "d124": (1001, 124),
                "d512": (129, 512)}


@pytest.mark.parametrize("lanes", [1, 5, 16])
@pytest.mark.parametrize("shape", list(LANES_SHAPES))
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_lanes_kernel_matches_plain(cuda, name, shape, lanes):
    """The single kernel's tolerances, value rtol 1e-5, gradient and
    sum(w l') rtol/atol 1e-4, against the plain version in float64 on the
    same float32 inputs (the float32 plain version's own sums drifted past
    atol 1e-4 at 20,000 centred rows; the kernel's are compensated); plain
    and with weights, offsets, a mask and shifts."""
    n, d, *skip = LANES_SHAPES[shape]
    x, y, c, w, o, m, b = _lanes_inputs(n, d, lanes, skip=skip[0] if skip else 0)
    if skip:
        assert x.data_ptr() % 16 != 0
    f64 = lambda t: None if t is None else t.double()
    for args in ((), (w, o, m, b)):
        before = hk.LANES_LAUNCHES
        got = hk.fused_value_and_gradient_lanes(TL.BY_NAME[name], x, y, c, *args)
        assert hk.LANES_LAUNCHES == before + 1
        want = hk.fused_value_and_gradient_lanes_plain(
            TL.BY_NAME[name], x.double(), y.double(), c.double(), *map(f64, args))
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)
        for a, e in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.cpu().numpy(), e.cpu().numpy(), rtol=1e-4, atol=1e-4)


_PROFILE_LANES = """
import json, sys
sys.path.insert(0, "tests/port")
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from photon_ml_tpu_torch.ops import hopper_kernels as hk, losses as TL
from test_torch_cuda import _lanes_inputs, _open_window, _window_names
args = _lanes_inputs(100_000, 31, 16)
hk.fused_value_and_gradient_lanes(TL.LOGISTIC, *args)  # build, workspace
torch.cuda.synchronize()
# a warm-up step, then a primed window (_open_window)
with profile(activities=[ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1)) as prof:
    _open_window(prof)
    for _ in range(3):
        hk.fused_value_and_gradient_lanes(TL.LOGISTIC, *args)
    torch.cuda.synchronize()
print(json.dumps(_window_names(prof)))
"""


def test_lanes_kernel_is_bit_stable_and_one_device_launch(cuda):
    """Two calls bit for bit around a call of another shape; one device
    launch per call and nothing else (profiled in a process of its own, as
    the sparse passes above: late in a long process the profiler has
    recorded no event of a short window)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    args = _lanes_inputs(100_000, 31, 16)
    other = _lanes_inputs(701, 37, 5, skip=1)
    first = hk.fused_value_and_gradient_lanes(TL.LOGISTIC, *args[:3], *args[3:])
    hk.fused_value_and_gradient_lanes(TL.POISSON, *other[:3])
    again = hk.fused_value_and_gradient_lanes(TL.LOGISTIC, *args[:3], *args[3:])
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", _PROFILE_LANES], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) == 3 and all("lanes_value_gradient" in n and "fvg_" not in n
                                   for n in names), names


def test_lanes_kernel_refuses_what_it_does_not_take(cuda):
    x, y, c, w, o, m, b = _lanes_inputs(64, 8, 4)
    with pytest.raises(TypeError, match="float32"):
        hk.fused_value_and_gradient_lanes(TL.LOGISTIC, x, y, c.double())
    with pytest.raises(ValueError, match="shape"):
        hk.fused_value_and_gradient_lanes(TL.LOGISTIC, x, y, c, offsets=o[:, :10].contiguous())
    with pytest.raises(ValueError, match="1 <= K <= 16"):
        hk.fused_value_and_gradient_lanes(TL.LOGISTIC, x, y,
                                          torch.zeros((17, 8), device="cuda"))


def test_candidate_lane_on_card_matches_isolated_fits(cuda):
    """The sweep's candidate lane on the card in float32 (config 4's
    coordinates at 3,000 rows, 5 candidates): each candidate within 1e-4
    of its own isolated fit on the card; the lanes kernel launches once
    per fixed-effect round and the single kernel never."""
    import dataclasses
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.hyperparameter import SweepEvaluator
    train, val, cfg = _movielens(3000)

    def cand(lam):
        coords = {name: dataclasses.replace(c, optimization=dataclasses.replace(
            c.optimization, regularization_weight=lam if name == "fixed" else 2 * lam))
            for name, c in cfg.coordinates.items()}
        return dataclasses.replace(cfg, coordinates=coords)
    cands = [cand(lam) for lam in np.logspace(1, -1, 5)]
    sweep = SweepEvaluator(GameEstimator(cfg), train, val, ["AUC"])
    lanes, single = hk.LANES_LAUNCHES, hk.LAUNCHES
    results = sweep.evaluate_vmapped(cands)
    fe_rounds = sum(v.rounds for v in sweep.visits if v.coordinate == "fixed")
    assert hk.LANES_LAUNCHES - lanes == fe_rounds > 0 and hk.LAUNCHES == single
    for c, r in zip(cands, results):
        iso = GameEstimator(c).fit(train, val, ["AUC"])
        np.testing.assert_allclose(r.objective_history, iso.objective_history, rtol=1e-4)


def test_fixed_effect_lanes_past_the_lanes_kernel_take_the_single_kernel(cuda):
    """A dense fixed effect of width 3,000 (past the lanes kernel's 2,048)
    with 16 candidates: the "single" route, 16 launches of the single fused
    kernel a pass and none of the lanes kernel, against the oracle's plain
    route on the CPU in float64 (value rtol 1e-5, gradient rtol/atol 1e-4,
    the single kernel's own tolerances), standardized."""
    from photon_ml_tpu_torch.ops.lanes import FixedEffectLanes
    from photon_ml_tpu_torch.ops.normalization import build_normalization_context
    n, d, lanes = 2000, 3000, 16
    x, y, c, w, o, _, _ = _lanes_inputs(n, d, lanes)
    x[:, -1] = 1.0                                     # the intercept
    o = torch.nan_to_num(o, posinf=0.0)
    l2 = torch.linspace(0.1, 2.0, lanes, device="cuda")
    mean, var = x.double().mean(0), x.double().var(0)
    norms = {dev: build_normalization_context("standardization", mean=mean.to(dev, dt),
                                              variance=var.to(dev, dt), intercept_index=d - 1)
             for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64))}
    got_lanes = FixedEffectLanes(TL.LOGISTIC, x, y, o, l2, weights=w, norm=norms["cuda"])
    assert got_lanes.route == "single" and len(got_lanes.groups) == lanes
    single, before = hk.LAUNCHES, hk.LANES_LAUNCHES
    value, grad = got_lanes.value_and_gradient(c)
    torch.cuda.synchronize()
    assert hk.LAUNCHES - single == lanes and hk.LANES_LAUNCHES == before
    cpu = lambda t: t.double().cpu()
    want = FixedEffectLanes(TL.LOGISTIC, cpu(x), cpu(y), cpu(o), cpu(l2), weights=cpu(w),
                            norm=norms["cpu"]).value_and_gradient(cpu(c))
    np.testing.assert_allclose(value.cpu().numpy(), want[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(grad.cpu().numpy(), want[1].numpy(), rtol=1e-4, atol=1e-4)


def test_candidate_lane_on_card_takes_a_wide_dense_fixed_effect(cuda):
    """evaluate_vmapped on the card with a dense fixed effect of width
    2,100 (bench.py's pipeline data at 2,000 rows, 40 users): its visits
    take the "single" route, the single kernel launching once per
    candidate per fixed-effect round and the lanes kernel never, and every
    candidate's objective history within 1e-4 of the same sweep on the CPU
    in float64 (the plain versions)."""
    import dataclasses
    from photon_ml_tpu_torch.data.synthetic_bench import pipeline_dataset
    from photon_ml_tpu_torch.game import (FixedEffectCoordinateConfig, GameEstimator,
                                          GameTrainingConfig, GLMOptimizationConfig,
                                          RandomEffectCoordinateConfig)
    from photon_ml_tpu_torch.hyperparameter import SweepEvaluator
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType)
    train, val = pipeline_dataset(2000, 2100, 40, 4, seed=5)

    def config(lam):
        opt = GLMOptimizationConfig(optimizer=OptimizerConfig(max_iterations=20),
                                    regularization=RegularizationContext(RegularizationType.L2),
                                    regularization_weight=lam)
        return GameTrainingConfig(
            task_type="logistic_regression",
            coordinates={"fixed": FixedEffectCoordinateConfig("global", opt),
                         "perUser": RandomEffectCoordinateConfig(
                             "userId", "per_user", dataclasses.replace(
                                 opt, regularization_weight=2 * lam), projector="identity")},
            updating_sequence=["fixed", "perUser"], num_outer_iterations=2, seed=5)
    cands = [config(lam) for lam in (10.0, 1.0, 0.1)]
    single, lanes = hk.LAUNCHES, hk.LANES_LAUNCHES
    sweep = SweepEvaluator(GameEstimator(config(1.0)), train, val, ["AUC"])
    got = sweep.evaluate_vmapped(cands)
    torch.cuda.synchronize()
    fe = [v for v in sweep.visits if v.coordinate == "fixed"]
    assert all(v.route == "single" for v in fe)
    assert hk.LAUNCHES - single == sum(v.single_launches for v in fe) \
        == len(cands) * sum(v.rounds for v in fe) > 0
    assert hk.LANES_LAUNCHES == lanes
    want = SweepEvaluator(GameEstimator(config(1.0), device="cpu", dtype=torch.float64),
                          train, val, ["AUC"]).evaluate_vmapped(cands)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.objective_history, w.objective_history, rtol=1e-4)


@pytest.mark.parametrize("lanes", [1, 5, 16])
@pytest.mark.parametrize("shape", ["700x37", "misaligned", "n1", "n0", "d9", "d31", "d124"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_lanes_kernel_with_lane_mask_matches_plain(cuda, name, shape, lanes):
    """The masked instantiation (bit k of an int32 word per row a 0/1
    factor on lane k's weights; a lane with no bit set, a lane with every
    bit set) against the plain version in float64, with and without
    weights, and with the row mask, offsets and shifts on top; the single
    kernel's tolerances."""
    from photon_ml_tpu_torch.ops.lanes import lane_words
    n, d, *skip = LANES_SHAPES[shape]
    x, y, c, w, o, m, b = _lanes_inputs(n, d, lanes, skip=skip[0] if skip else 0)
    keep = torch.from_numpy(np.random.default_rng(9).uniform(size=(lanes, n)) < 0.7).cuda()
    keep[0] = False
    if lanes > 1:
        keep[1] = True
    word = lane_words(keep)
    f64 = lambda t: None if t is None else t.double()
    for args in ((None, None, None, None), (w, None, None, None), (w, o, m, b)):
        before = hk.LANES_LAUNCHES
        got = hk.fused_value_and_gradient_lanes(TL.BY_NAME[name], x, y, c, *args,
                                                lane_mask=word)
        assert hk.LANES_LAUNCHES == before + 1
        want = hk.fused_value_and_gradient_lanes_plain(
            TL.BY_NAME[name], x.double(), y.double(), c.double(), *map(f64, args),
            lane_mask=word)
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)
        for a, e in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.cpu().numpy(), e.cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_small_bootstrap_on_card_matches_isolated_fits(cuda):
    """bootstrap_training on the card in float32 at [6,000 x 31]: one
    launch of the masked lanes kernel per round (one lane group), none of
    the single kernel; replicas 0, 2 and 4 within 1e-4 of an isolated fit
    of weights member_k * w through the single kernel (host float64
    objectives)."""
    from photon_ml_tpu_torch.diagnostics import bootstrap_training
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim import (OptimizerConfig, RegularizationContext,
                                           RegularizationType, solve)
    rng = np.random.default_rng(3)
    n, d, k = 6000, 31, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ (rng.normal(size=d) * 0.3)))) * 1.0
    w = rng.uniform(0.5, 2.0, size=n)
    reg, cfg = RegularizationContext(RegularizationType.L2), OptimizerConfig(tolerance=1e-6)
    lanes, single = hk.LANES_LAUNCHES, hk.LAUNCHES
    rep = bootstrap_training(x, y, "logistic_regression", num_bootstrap_samples=k,
                             weights=w, optimizer_config=cfg, regularization=reg,
                             regularization_weight=1.0, device="cuda", dtype=torch.float32)
    assert rep.solve["route"] == "lanes" and rep.solve["lane_groups"] == 1
    assert hk.LANES_LAUNCHES - lanes == rep.solve["rounds"] > 0 and hk.LAUNCHES == single
    member = np.random.default_rng(7).random((k, n)) < 0.75
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    def f64(coef, wk):
        z = x.astype(np.float64) @ coef
        return float(np.sum(wk * (np.logaddexp(0, z) - y * z)) + 0.5 * coef @ coef)
    for r in (0, 2, 4):
        wk = member[r] * w
        iso = solve(GLMObjective(TL.LOGISTIC, t(x), t(y), weights=t(wk)),
                    torch.zeros(d, device="cuda"), cfg, reg, 1.0)
        got, want = f64(rep.coefficients[r].astype(np.float64), wk), \
            f64(iso.x.double().cpu().numpy(), wk)
        assert abs(got - want) <= 1e-4 * abs(want), (r, got, want)


def test_tracked_random_effect_fit_on_card(cuda):
    """A random effect's batched solve with coefficient tracking on the
    card: every lane's iterates [E, max_iterations + 1, d], row 0 the
    start, the row at its iteration count its solution, NaN after."""
    from photon_ml_tpu_torch.optim import OptimizerConfig, RegularizationContext
    from photon_ml_tpu_torch.optim.config import RegularizationType
    from photon_ml_tpu_torch.parallel import random_effect as tre
    rng = np.random.default_rng(4)
    E, S, d = 64, 12, 5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    mask = (np.arange(S)[None, :] < rng.integers(1, S + 1, size=E)[:, None]) * 1.0
    x = rng.normal(size=(E, S, d)) * mask[:, :, None]
    y = np.where(mask > 0, rng.uniform(size=(E, S)) < 0.5, 0.5) * 1.0
    blocks = tre.EntityBlocks(t(x), t(y), t(mask), t(mask), t(np.zeros((E, S))))
    cfg = OptimizerConfig(max_iterations=30, track_coefficients=True)
    res = tre.fit_random_effects(blocks, TL.LOGISTIC, config=cfg,
                                 reg=RegularizationContext(RegularizationType.L2),
                                 reg_weight=1.0)
    hist = res.coefficient_history
    assert hist.shape == (E, 31, d) and hist.is_cuda
    assert torch.equal(hist[:, 0], torch.zeros((E, d), device="cuda"))
    for e in range(E):
        it = int(res.iterations[e])
        assert torch.equal(hist[e, it], res.x[e])
        assert torch.isnan(hist[e, it + 1:]).all()


def _online_service(updates=True, dtype=torch.float64):
    """online_jax_side's model as a ScoringService on the card."""
    import online_jax_side as oj
    from photon_ml_tpu_torch.models import game
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.glm import model_for_task
    from photon_ml_tpu_torch.online import OnlineUpdateConfig
    from photon_ml_tpu_torch.serving import ScoringService, ServingConfig
    pkg = {"asarray": lambda a: torch.tensor(a, dtype=dtype, device="cuda"),
           "Coefficients": Coefficients, "model_for_task": model_for_task,
           **{k: getattr(game, k) for k in ("GameModel", "FixedEffectModel",
                                            "RandomEffectModel")}}
    return ScoringService(
        model=oj.build_model(pkg, oj.model_arrays()),
        config=ServingConfig(max_batch=64, min_bucket=4, dtype=dtype),
        updates=OnlineUpdateConfig(micro_batch=4, **oj.SOLVER) if updates else None,
        start_updater=False), oj


def test_anchored_cycle_on_card_matches_the_cpu(cuda):
    """One micro-batch update cycle on the card in float64: the same
    deltas as on the CPU (rows and priors equal, values within 1e-9), the
    table and its blocks on the card, and no kernel of the kernels line."""
    import test_torch_online as tto
    svc, oj = _online_service()
    cpu = oj._service(tto.PKG, micro_batch=4)
    hk.LAUNCHES = hk.LANES_LAUNCHES = 0
    try:
        for s in (svc, cpu):
            s.feedback(*oj.feedback(21, 20))
            s.updater.flush()
        assert svc.registry.scorer.re_table("perUser").is_cuda
        tto.check_deltas(oj._deltas(svc, tto.host), oj._deltas(cpu, tto.host),
                         tto.RTOL)
        assert hk.LAUNCHES == hk.LANES_LAUNCHES == 0
    finally:
        svc.close()
        cpu.close()


def test_delta_rollback_on_card_is_bit_exact(cuda):
    svc, oj = _online_service(dtype=torch.float32)
    try:
        before = svc.audit()
        svc.feedback(*oj.feedback(22, 24))
        assert svc.updater.flush()["deltas"] >= 2
        assert svc.audit()["table_hashes"] != before["table_hashes"]
        while svc.registry.pending_deltas():
            svc.rollback()
        assert svc.audit()["table_hashes"] == before["table_hashes"]
    finally:
        svc.close()


def test_replog_round_trip_of_card_rows(cuda, tmp_path):
    """A card table's rows through the replication log: the codec reads the
    CUDA tensor back bit for bit, and the logged deltas replay into a
    fresh service on the card to the live hashes."""
    from photon_ml_tpu_torch.fleet import (ReplicationLog, decode_array,
                                           delta_from_record, encode_array,
                                           record_for_event)
    svc, oj = _online_service(dtype=torch.float32)
    fresh, _ = _online_service(updates=False, dtype=torch.float32)
    log = ReplicationLog(str(tmp_path / "log"))
    try:
        table = svc.registry.scorer.re_table("perUser")
        back = decode_array(encode_array(table))
        assert back.tobytes() == table.cpu().numpy().tobytes()
        svc.registry.add_publish_hook(
            lambda ticket, event: log.append(record_for_event(event)))
        svc.feedback(*oj.feedback(23, 16))
        svc.updater.flush()
        for env in log.read(0):
            fresh.registry.apply_delta(delta_from_record(env["record"]))
        assert fresh.audit() == svc.audit()
    finally:
        svc.close()
        fresh.close()


def _refit_driver(tmp_path, device, dtype):
    """A service over the refit tests' saved model on `device` and a
    driver over their feedback lane (fleet_jax_side.write_lane)."""
    import fleet_jax_side as fj
    import test_torch_online as tto
    from photon_ml_tpu_torch.fleet import FeedbackLog
    from photon_ml_tpu_torch.models.io import save_game_model
    from photon_ml_tpu_torch.refit import (CompactorConfig, LogCompactor,
                                           RefitDriver)
    from photon_ml_tpu_torch.serving import ScoringService, ServingConfig
    import online_jax_side as oj
    if not (tmp_path / "model").exists():
        save_game_model(oj.build_model(tto.PKG, oj.model_arrays()),
                        str(tmp_path / "model"))
        fj.write_lane(tto.PKG, tmp_path / "lane")
    svc = ScoringService(model_dir=str(tmp_path / "model"), start_updater=False,
                         config=ServingConfig(device=device, dtype=dtype))
    comp = LogCompactor(FeedbackLog(str(tmp_path / "lane")),
                        str(tmp_path / f"chunks_{device}"),
                        CompactorConfig(chunk_rows=fj.CHUNK_ROWS))
    return svc, RefitDriver(svc.registry, comp, str(tmp_path / f"models_{device}"))


def test_refit_fe_pass_launches_the_fused_kernel(cuda, tmp_path):
    """The warm refit's fixed-effect passes run the fused kernel on the
    card: one launch per value+gradient pass, nothing else."""
    svc, drv = _refit_driver(tmp_path, "cuda", torch.float32)
    try:
        drv.compactor.compact()
        rows = drv.gather_rows()
        hk.LAUNCHES = hk.LANES_LAUNCHES = 0
        fit = drv.fit_candidate(rows)
        assert hk.LAUNCHES == sum(fit.fe_passes) > 0
        assert hk.LANES_LAUNCHES == 0
        assert fit.model.coordinates["fixed"].glm.coefficients.means.is_cuda
        assert fit.model.coordinates["perUser"].coefficients.is_cuda
    finally:
        svc.close()


def test_refit_on_card_matches_the_cpu(cuda, tmp_path):
    """One run_once on the card in float32 against the CPU in float64: the
    objective history within GLMIX_RTOL, the same decision and row counts."""
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        svc, drv = _refit_driver(tmp_path, device, dtype)
        try:
            out[device] = drv.run_once(version="cand")
        finally:
            svc.close()
    cpu, card = out["cpu"], out["cuda"]
    assert card.swapped == cpu.swapped and card.reason == cpu.reason
    assert (card.train_rows, card.holdout_rows, card.sealed_rows) == \
        (cpu.train_rows, cpu.holdout_rows, cpu.sealed_rows)
    np.testing.assert_allclose(card.objective_history, cpu.objective_history,
                               rtol=1e-4)


def test_front_import_leaves_cuda_uninitialised(cuda):
    """The front is model-free: importing it and routing nothing touches
    no device, so CUDA stays uninitialised in its process."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import torch; from photon_ml_tpu_torch.fleet import front; "
            "f = front.Front(['http://127.0.0.1:9'], start_probes=False); "
            "f.probe_once(); f.close(); print(torch.cuda.is_initialized())")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env={**__import__("os").environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


_MESH_RANK = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                              RegularizationType)
from photon_ml_tpu_torch.parallel import fit_fixed_effect, make_mesh, multihost
rank = int(sys.argv[1])
multihost.initialize(sys.argv[2], 2, rank, backend="gloo", device="cuda:0", timeout_s=120)
rng = np.random.default_rng(3)
x = rng.normal(size=(20_001, 31)).astype(np.float32)
y = (rng.uniform(size=20_001) < 0.5).astype(np.float32)
mesh = make_mesh(2, 1, device="cuda:0")
obj = GLMObjective(LOGISTIC, x, torch.as_tensor(y, device="cuda"))
hk.LAUNCHES = 0
res = fit_fixed_effect(obj, torch.zeros(31, device="cuda"), mesh,
                       OptimizerConfig(max_iterations=30),
                       RegularizationContext(RegularizationType.L2), 1.0)
print(json.dumps({{"x": res.x.cpu().tolist(), "fg": res.fg_count, "launches": hk.LAUNCHES,
                  "history": res.loss_history[:res.iterations + 1].tolist()}}))
multihost.shutdown()
"""


def _mesh_ranks(code, root):
    import subprocess
    import sys
    from photon_ml_tpu_torch.parallel import multihost
    addr = f"127.0.0.1:{multihost.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), addr], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    return [p.communicate(timeout=300) + (p.returncode,) for p in procs]


def test_two_gloo_ranks_on_one_card_run_the_fused_kernel_per_shard(cuda):
    """Two ranks of a gloo group on cuda:0, each with half the rows: one
    launch of the fused kernel per value+gradient pass on each rank, the
    ranks' solutions bit-equal, and the fit within 1e-5 of one device's."""
    import json
    from pathlib import Path
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType, solve)
    root = str(Path(__file__).resolve().parents[2])
    runs = _mesh_ranks(_MESH_RANK.format(root=root), root)
    assert [rc for _, _, rc in runs] == [0, 0], [err[-1500:] for _, err, _ in runs]
    r0, r1 = (json.loads(out.strip().splitlines()[-1]) for out, _, _ in runs)
    assert r0["x"] == r1["x"] and r0["history"] == r1["history"]
    assert r0["launches"] == r0["fg"] == r1["launches"] > 0
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(20_001, 31)).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.uniform(size=20_001) < 0.5).astype(np.float32)).cuda()
    one = solve(GLMObjective(LOGISTIC, x, y), torch.zeros(31, device="cuda"),
                OptimizerConfig(max_iterations=30),
                RegularizationContext(RegularizationType.L2), 1.0)
    np.testing.assert_allclose(r0["history"][-1], one.loss_history[one.iterations].item(),
                               rtol=1e-5)


_NCCL_RANK = """
import sys
sys.path.insert(0, {root!r})
from photon_ml_tpu_torch.parallel import multihost
try:
    multihost.initialize(sys.argv[2], 2, int(sys.argv[1]), backend="nccl",
                         device="cuda:0", timeout_s=60)
except multihost.MultihostInitError as e:
    print(e)
    sys.exit(3)
sys.exit(0)
"""


def test_two_nccl_ranks_on_one_card_raise(cuda):
    """NCCL cannot run two ranks on one card: bring-up refuses before NCCL
    starts, naming gloo; nothing switches backend by itself."""
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[2])
    runs = _mesh_ranks(_NCCL_RANK.format(root=root), root)
    for out, err, rc in runs:
        assert rc == 3, err[-1500:]
        assert "NCCL cannot run two ranks on one card" in out and "gloo" in out


# --- bf16 feature storage: the fused kernel on bf16 X, A and B on bf16 values

BF16_SHAPES = {"scalar": (700, 37), "tile_tail": (5003, 124), "n3": (3, 124),
               "n1": (1, 37), "d2048": (20_000, 2048), "misaligned": (700, 37, 1)}


@pytest.mark.parametrize("shape", list(BF16_SHAPES))
@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_bf16_kernel_matches_plain(cuda, name, with_wo, shape):
    """The fused kernel on a bf16 X against its plain version on the same
    X (widened exactly): value rtol 1e-5, gradient rtol/atol 1e-4, as the
    f32 kernel's check.  Odd d (ragged ends of up to 7 bf16 values), a
    last tile shorter than the rest, a view 37 * 2 bytes into the array."""
    n, d, *skip = BF16_SHAPES[shape]
    x, y, c, w, o = _inputs(n, d, with_wo, skip=skip[0] if skip else 0)
    # a view of the bf16 copy of X's contiguous base
    xb = x._base.to(torch.bfloat16)[skip[0]:] if skip else x.to(torch.bfloat16)
    if skip:
        assert xb.is_contiguous() and xb.data_ptr() % 16 != 0
    before, before16 = hk.LAUNCHES, hk.BF16_LAUNCHES
    v, g = hk.fused_value_and_gradient(TL.BY_NAME[name], xb, y, c, w, o)
    assert hk.LAUNCHES == before + 1 and hk.BF16_LAUNCHES == before16 + 1
    v_p, g_p = hk.fused_value_and_gradient_plain(TL.BY_NAME[name], xb, y, c, w, o)
    assert g.dtype == g_p.dtype == torch.float32
    np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_kernel_refuses_other_storage(cuda):
    """X in float16 or float64 raises; nothing widens it."""
    x, y, c, _, _ = _inputs(64, 8, False)
    for dtype in (torch.float16, torch.float64):
        before = hk.LAUNCHES
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            hk.fused_value_and_gradient(TL.LOGISTIC, x.to(dtype), y, c)
        assert hk.LAUNCHES == before


@pytest.mark.parametrize("shape", list(SPARSE_SHAPES))
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_bf16_sparse_kernels_match_plain(cuda, name, shape):
    """Kernel A (loss mode, weights and offsets) then B over its u, and A
    in margins mode and B at power 2, on bf16 values against the plain
    versions on the same values: the f32 checks' tolerances (value rtol
    1e-5, u rtol/atol 1e-4, margins and column sums within their float32
    bounds)."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    x = _sparse_case(shape).to(dtype=torch.bfloat16)
    assert x.values.dtype == x.csc_val.dtype == torch.bfloat16
    n, d = x.shape
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    y = t((rng.uniform(size=n) < 0.3) * 1.0)
    c = t(rng.normal(size=d) * 0.3 / np.sqrt(SPARSE_SHAPES[shape][2]))
    w, o = t(rng.uniform(0.5, 2.0, size=n)), t(rng.normal(size=n) * 0.1)
    r = t(rng.uniform(-1, 1, size=n))
    loss = TL.BY_NAME[name]
    before = dict(sk.BF16_LAUNCHES)
    v, u = sk.ell_margin_loss(loss, x.indices, x.values, c, y, w, o)
    g = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1, x.csc_tiles)
    z = sk.ell_margins(x.indices, x.values, c, o)
    h = sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, r, 2, x.csc_tiles)
    assert all(sk.BF16_LAUNCHES[k] == before[k] + 1 for k in before), sk.BF16_LAUNCHES
    v_p, u_p = sk.ell_margin_loss_plain(loss, x.indices, x.values, c, y, w, o)
    np.testing.assert_allclose(v.item(), v_p.item(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u.cpu().numpy(), u_p.cpu().numpy(), rtol=1e-4, atol=1e-4)
    z_p = sk.ell_margins_plain(x.indices, x.values, c, o)
    assert bool(((z.double() - z_p.double()).abs()
                 <= sk.margins_tolerance(x.indices, x.values, c, o) + 1e-30).all())
    for power, uu, got in ((1, u, g), (2, r, h)):
        want = sk.csc_column_sum_plain(x.csc_row, x.csc_val, x.csc_end, uu, power)
        assert got.dtype == want.dtype == torch.float32
        tol = sk.column_sum_tolerance(x.csc_row, x.csc_val, x.csc_end, uu, power)
        assert bool(((got.double() - want.double()).abs() <= tol + 1e-30).all()), power


@pytest.mark.parametrize("side", ["smem", "l2"])
@pytest.mark.parametrize("k", [2, 25, 65])
def test_bf16_margin_kernel_matches_plain_on_both_c_paths(cuda, k, side):
    """Kernel A on bf16 values with c staged beside the bf16 tiles (the
    plan counts 2-byte values) and one column past that limit, every loss
    and margins mode, weights and offsets set."""
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    n, d = _c_path_case(k, side, vbytes=2)
    idx, val = _ell_on_card(n, k, d, seed=k)
    val = val.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(200 + k)
    c = torch.randn(d, generator=g, device="cuda") * (0.3 / k ** 0.5)
    y = (torch.rand(n, generator=g, device="cuda") < 0.3).float()
    w = 0.5 + 1.5 * torch.rand(n, generator=g, device="cuda")
    o = 0.1 * torch.randn(n, generator=g, device="cuda")
    _a_against_plain(sk, idx, val, c, y, w, o)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_bf16_train_glm_runs_the_kernels_on_bf16(cuda, kind):
    """train_glm on bf16 features (binary, exact in bf16) on the card: the
    objective's X stays bf16, every pass launches the bf16 kernels (the
    fused kernel, or A and B, once a pass), and the fit lands on the f32
    fit's objective within 1e-5."""
    from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like, make_wide_sparse_logistic
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.ops.features import PaddedSparse
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType,
    )
    if kind == "dense":
        x_np, y = make_a1a_like(4, seed=42)
        x32 = torch.from_numpy(x_np).cuda()
        x16 = x32.to(torch.bfloat16)
    else:
        x_np, y = make_wide_sparse_logistic(3000, d=20_000, nnz=16, seed=5)
        x32 = PaddedSparse.from_scipy(x_np, with_csc=True, device="cuda")
        x16 = x32.to(dtype=torch.bfloat16)
    kw = dict(optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-7),
              regularization=RegularizationContext(RegularizationType.L2),
              regularization_weights=(1.0,))
    f32 = train_glm(x32, y, "logistic_regression", **kw)[0]
    hk.BF16_LAUNCHES = 0
    sk.BF16_LAUNCHES.update(dict.fromkeys(sk.BF16_LAUNCHES, 0))
    f16 = train_glm(x16, y, "logistic_regression", **kw)[0]
    passes = f16.result.fg_count
    if kind == "dense":
        assert hk.BF16_LAUNCHES == passes > 0
    else:
        assert sk.BF16_LAUNCHES["margin_loss"] == sk.BF16_LAUNCHES["column_sum"] == passes > 0
    np.testing.assert_allclose(f16.result.value.item(), f32.result.value.item(), rtol=1e-5)


# --- bf16 X on the lanes kernel, the streamed chunk; sparse tensors ---------

BF16_LANES_SHAPES = ("700x37", "misaligned", "n1", "n0", "d9", "d9_misaligned", "d124",
                     "d512")


@pytest.mark.parametrize("lanes", [1, 5, 16])
@pytest.mark.parametrize("shape", BF16_LANES_SHAPES)
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_bf16_lanes_kernel_matches_plain(cuda, name, shape, lanes):
    """The lanes kernel on a bf16 X (its 2-byte ring, the ragged ends of a
    misaligned view copied by the producer lane, X a native TF32 operand)
    against the plain version in float64 on the same bf16 X widened: the
    float32 kernel's tolerances, value rtol 1e-5, the rest rtol/atol 1e-4;
    plain, and with weights, offsets, a mask and shifts; counted among the
    bf16 launches."""
    n, d, *skip = LANES_SHAPES[shape]
    x, y, c, w, o, m, b = _lanes_inputs(n, d, lanes, skip=skip[0] if skip else 0)
    xb = torch.empty((n + (skip[0] if skip else 0), d), dtype=torch.bfloat16,
                     device="cuda")[skip[0] if skip else 0:]
    xb.copy_(x)
    if skip:
        assert xb.data_ptr() % 16 != 0
    f64 = lambda t: None if t is None else t.double()
    for args in ((), (w, o, m, b)):
        before = hk.LANES_BF16_LAUNCHES
        got = hk.fused_value_and_gradient_lanes(TL.BY_NAME[name], xb, y, c, *args)
        assert hk.LANES_BF16_LAUNCHES == before + 1
        want = hk.fused_value_and_gradient_lanes_plain(
            TL.BY_NAME[name], xb.double(), y.double(), c.double(), *map(f64, args))
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)
        for a, e in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.cpu().numpy(), e.cpu().numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_lanes_kernel_with_lane_mask_and_bootstrap(cuda):
    """A bf16 X with a lane mask (the bootstrap's lanes) against the plain
    version, and bootstrap_training on a bf16 X on the card: its replicas'
    state in bf16, one bf16 launch of the lanes kernel a round."""
    from photon_ml_tpu_torch.diagnostics.bootstrap import bootstrap_training
    from photon_ml_tpu_torch.ops.lanes import lane_words
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType)
    x, y, c, w, o, m, b = _lanes_inputs(5001, 31, 16)
    keep = torch.rand((16, 5001), device="cuda") < 0.75
    q = lane_words(keep)
    xb = x.to(torch.bfloat16)
    got = hk.fused_value_and_gradient_lanes(TL.LOGISTIC, xb, y, c, w, lane_mask=q)
    want = hk.fused_value_and_gradient_lanes_plain(TL.LOGISTIC, xb.double(), y.double(),
                                                   c.double(), w.double(), lane_mask=q)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    rng = np.random.default_rng(3)
    xh = rng.normal(size=(20_000, 12))
    xh[:, 0] = 1.0
    yh = (rng.uniform(size=20_000) < 1 / (1 + np.exp(-xh @ rng.normal(size=12)))) * 1.0
    before = hk.LANES_BF16_LAUNCHES
    rep = bootstrap_training(torch.from_numpy(xh).to(torch.bfloat16).cuda(), yh,
                             "logistic_regression", num_bootstrap_samples=8,
                             optimizer_config=OptimizerConfig(max_iterations=50),
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0)
    assert rep.solve["route"] == "lanes" and rep.solve["lane_groups"] == 1
    assert hk.LANES_BF16_LAUNCHES - before == rep.solve["rounds"] > 0
    assert np.all(np.isfinite(rep.coefficients))


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_sparse_tensor_train_glm_runs_kernels_a_and_b(cuda, layout):
    """train_glm on a CUDA sparse COO/CSR tensor: converted on the card into
    the ELL layout from_scipy builds (tensor for tensor), kernels A and B
    once a pass each and no dense launch, and the fit the scipy-ingested
    fit's bit for bit; a raw tensor's products run its cached ELL form."""
    from photon_ml_tpu_torch.data.synthetic_bench import make_wide_sparse_logistic
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import features as F
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType)
    x_sp, y = make_wide_sparse_logistic(3000, d=20_000, nnz=16, seed=5)
    coo = x_sp.tocoo()
    t = torch.sparse_coo_tensor(np.stack([coo.row, coo.col]), coo.data, coo.shape,
                                device="cuda")
    t = t if layout == "coo" else t.coalesce().to_sparse_csr()
    want = F.PaddedSparse.from_scipy(x_sp, with_csc=True, device="cuda")
    got = F.PaddedSparse.from_torch(t, with_csc=True)
    for f in ("indices", "values", "csc_row", "csc_val", "csc_end", "csc_tiles"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    kw = dict(optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-7),
              regularization=RegularizationContext(RegularizationType.L2),
              regularization_weights=(1.0,))
    ref = train_glm(x_sp, y, "logistic_regression", **kw)[0]
    before, dense = dict(sk.LAUNCHES), hk.LAUNCHES
    fit = train_glm(t, y, "logistic_regression", **kw)[0]
    passes = fit.result.fg_count
    assert sk.LAUNCHES["margin_loss"] - before["margin_loss"] == passes > 0
    assert sk.LAUNCHES["column_sum"] - before["column_sum"] == passes
    assert hk.LAUNCHES == dense
    assert torch.equal(fit.model.coefficients.means, ref.model.coefficients.means)
    u = torch.rand(3000, device="cuda")
    v = torch.randn(20_000, device="cuda") * 0.01
    assert F.ell_form(t) is F.ell_form(t)
    cpu = t.cpu().double()
    np.testing.assert_allclose(F.matvec(t, v).cpu().numpy(),
                               F.matvec(cpu, v.cpu().double()).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(F.rmatvec(t, u).cpu().numpy(),
                               F.rmatvec(cpu, u.cpu().double()).numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_streamed_chunk_runs_the_fused_kernel_on_bf16(cuda):
    """A streamed objective over a bf16 host X (a CPU bf16 tensor): each
    chunk's 2-byte bits staged and run by the fused kernel on bf16, one
    launch a chunk; its value and gradient within the kernel's tolerances
    of the float32 streamed objective over the same values."""
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(300_001, 24))).to(torch.bfloat16)
    y = (rng.uniform(size=300_001) < 0.4) * 1.0
    plan = ChunkPlan.build(300_001, chunk_rows=65_536)
    c = torch.from_numpy(rng.normal(size=24) * 0.1).float().cuda()
    b16 = ChunkedGLMObjective(TL.LOGISTIC, x, y, plan, device="cuda")
    f32 = ChunkedGLMObjective(TL.LOGISTIC, x.float().numpy(), y, plan, device="cuda")
    before = hk.BF16_LAUNCHES
    v16, g16 = b16.value_and_gradient(c)
    assert hk.BF16_LAUNCHES - before == plan.num_chunks
    v32, g32 = f32.value_and_gradient(c)
    np.testing.assert_allclose(v16.item(), v32.item(), rtol=1e-5)
    np.testing.assert_allclose(g16.cpu().numpy(), g32.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert b16.stats.total_bytes < f32.stats.total_bytes
    with pytest.raises(TypeError, match="host"):   # a CUDA block is no host block
        ChunkedGLMObjective(TL.LOGISTIC, x[:8].cuda(), y[:8], ChunkPlan.build(8, chunk_rows=8),
                            device="cuda")
