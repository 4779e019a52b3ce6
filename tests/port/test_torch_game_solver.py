"""Port batched LBFGS/OWLQN/TRON == the JAX package's jit(vmap(solve)) per
lane.

The JAX side (parallel/random_effect.py::_cached_batched_solver) runs once
for the module in a subprocess (game_jax_side.py, float64 on the CPU), so
its XLA programs never compile in the test process.  Problems are
[E=24, S=16, d=5] blocks with all-masked lanes, one-row lanes and ragged
lanes, weights and offsets on every lane, under L2, elastic net and none,
LBFGS with and without a box [-0.3, 0.3] shared by every lane, OWLQN and
TRON, cold and warm started.  Per lane: equal iterations, reason and
fg_count (LBFGS/OWLQN) or hv_count (TRON); x within rtol 1e-9 (TRON, box)
or atol 1e-7; value within rtol 1e-10 (the same arithmetic in float64, in
another summation order)."""
import dataclasses

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.optim import batched
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.parallel import random_effect as tre

@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("solver", tmp_path_factory.mktemp("jax") / "solver.npz")


def _blocks(case):
    p = side.solver_problem(case)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return tre.EntityBlocks(t["x"], t["labels"], t["mask"], t["weights"],
                            t["offsets"]), t["x0"]


def _config(case):
    opt = dict(side.SOLVER_CASES[case][5])
    if "optimizer" in opt:
        opt["optimizer"] = OptimizerType(opt["optimizer"])
    return OptimizerConfig(**{"max_iterations": side.SOLVER_MAX_ITERATIONS,
                              "tolerance": side.SOLVER_TOLERANCE, **opt})


def _port_solve(case, blocks=None, x0=None):
    loss, reg, alpha, lam, _, _ = side.SOLVER_CASES[case]
    if blocks is None:
        blocks, x0 = _blocks(case)
    return tre.fit_random_effects(
        blocks, TL.BY_NAME[loss], x0=x0, config=_config(case),
        reg=RegularizationContext(RegularizationType(reg), alpha),
        reg_weight=lam)


def _count(case):
    """The per-lane pass count of the case's solver."""
    return "hv_count" if _config(case).optimizer == OptimizerType.TRON else "fg_count"


@pytest.mark.parametrize("case", list(side.SOLVER_CASES))
def test_batched_solver_matches_jax_per_lane(jax_results, case):
    res = _port_solve(case)
    count = _count(case)
    j = {f: jax_results[f"{case}/{f}"] for f in
         ("x", "value", "iterations", count, "reason", "loss_history")}
    np.testing.assert_array_equal(res.iterations.numpy(), j["iterations"])
    np.testing.assert_array_equal(getattr(res, count).numpy(), j[count])
    np.testing.assert_array_equal(res.reason.numpy(), j["reason"])
    if side.SOLVER_CASES[case][5]:
        np.testing.assert_allclose(res.x.numpy(), j["x"], rtol=1e-9, atol=1e-12)
        # lanes that fit exactly end at values ~1e-30: rounding, not a gap
        np.testing.assert_allclose(res.value.numpy(), j["value"], rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(res.loss_history.numpy(), j["loss_history"],
                                   rtol=1e-9, atol=1e-14, equal_nan=True)
    else:
        np.testing.assert_allclose(res.x.numpy(), j["x"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(res.value.numpy(), j["value"], rtol=1e-10)
        np.testing.assert_allclose(res.loss_history.numpy(), j["loss_history"],
                                   rtol=1e-9, equal_nan=True)
    # the lanes took different paths: not every lane stopped at one step
    assert len(np.unique(j["iterations"])) > 2


@pytest.mark.parametrize("case", list(side.SOLVER_CASES))
def test_frozen_lanes_do_not_move(case):
    """A lane's result does not depend on the other lanes of the batch:
    solving lanes one at a time gives the same per-lane results."""
    blocks, x0 = _blocks(case)
    full = _port_solve(case)
    count = _count(case)
    for e in (0, 1, 2, 9):
        one = tre.EntityBlocks(*(getattr(blocks, f)[e:e + 1] for f in
                                 ("x", "labels", "mask", "weights", "offsets")))
        r = _port_solve(case, one, x0[e:e + 1])
        assert int(r.iterations[0]) == int(full.iterations[e])
        assert int(getattr(r, count)[0]) == int(getattr(full, count)[e])
        np.testing.assert_allclose(r.x[0].numpy(), full.x[e].numpy(),
                                   rtol=0, atol=1e-12)


def test_batched_value_and_gradient_is_masked_glm_objective():
    """One lane of the batched aggregator == the port's single-objective
    aggregator on that lane's real rows."""
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    blocks, _ = _blocks("logistic_l2")
    c = torch.from_numpy(np.random.default_rng(3).normal(size=(side.SOLVER_E,
                                                                side.SOLVER_D)))
    v, g = tre.batched_value_and_gradient(TL.LOGISTIC, blocks, c, 0.7)
    for e in range(side.SOLVER_E):
        rows = blocks.mask[e] > 0
        obj = GLMObjective(TL.LOGISTIC, blocks.x[e][rows], blocks.labels[e][rows],
                           weights=blocks.weights[e][rows],
                           offsets=blocks.offsets[e][rows], l2_weight=0.7)
        ve, ge = obj.value_and_gradient(c[e])
        np.testing.assert_allclose(v[e].item(), ve.item(), rtol=1e-12)
        np.testing.assert_allclose(g[e].numpy(), ge.numpy(), rtol=1e-12, atol=1e-13)


def test_padded_rows_with_nonfinite_loss_do_not_poison():
    blocks, _ = _blocks("poisson_elastic_net_warm")
    pad = blocks.mask == 0
    poisoned = tre.EntityBlocks(blocks.x, blocks.labels,
                                blocks.mask, blocks.weights,
                                torch.where(pad, torch.full_like(blocks.offsets, 1e6),
                                            blocks.offsets))
    c = torch.zeros((side.SOLVER_E, side.SOLVER_D), dtype=torch.float64)
    v, g = tre.batched_value_and_gradient(TL.POISSON, poisoned, c)
    v0, g0 = tre.batched_value_and_gradient(TL.POISSON, blocks, c)
    assert torch.isfinite(v).all() and torch.equal(v, v0) and torch.equal(g, g0)


@pytest.mark.parametrize("config,reg,error,match", [
    (OptimizerConfig(optimizer=OptimizerType.TRON), RegularizationType.L1,
     ValueError, "TRON supports only L2"),
    (OptimizerConfig(optimizer=OptimizerType.TRON, box_lower=(-1.0,) * side.SOLVER_D),
     RegularizationType.L2, ValueError, "box constraints are an LBFGS feature"),
    (OptimizerConfig(track_coefficients=True), RegularizationType.L2, None, None),
], ids=["tron", "box", "track"])
def test_unported_batched_options_raise(config, reg, error, match):
    """TRON under L1 and TRON with a box break the JAX package's rules, on
    batched solves too.  Coefficient tracking, which raised here until it
    was ported, now solves: every lane's iterates, row 0 its start, the
    last written row its solution."""
    blocks, x0 = _blocks("logistic_l2")
    fit = lambda: tre.fit_random_effects(blocks, TL.LOGISTIC, x0=x0, config=config,
                                         reg=RegularizationContext(reg), reg_weight=1.0)
    if error is not None:
        with pytest.raises(error, match=match):
            fit()
        return
    res = fit()
    hist = res.coefficient_history
    assert hist.shape == (side.SOLVER_E, config.resolved().max_iterations + 1, side.SOLVER_D)
    assert torch.equal(hist[:, 0], x0)
    for e in range(side.SOLVER_E):
        assert torch.equal(hist[e, int(res.iterations[e])], res.x[e])


@pytest.mark.parametrize("case", side.TRACKED_SOLVER_CASES)
def test_batched_tracking_matches_jax(jax_results, case):
    """With track_coefficients every route of the batched solve (LBFGS,
    OWLQN, a box, TRON) records each lane's iterates as jax.vmap of the
    JAX package's solve does: row 0 the start, one row per iteration, NaN
    after the lane stops; within 1e-10 of JAX's, the NaN padding equal.
    Tracking records and changes nothing: x and the loss history are the
    untracked solve's, bit for bit."""
    loss, reg, alpha, lam, _, _ = side.SOLVER_CASES[case]
    blocks, x0 = _blocks(case)
    cfg = dataclasses.replace(_config(case), track_coefficients=True)
    res = tre.fit_random_effects(
        blocks, TL.BY_NAME[loss], x0=x0, config=cfg,
        reg=RegularizationContext(RegularizationType(reg), alpha), reg_weight=lam)
    hist = res.coefficient_history.numpy()
    want = jax_results[f"tracked/{case}/coefficient_history"]
    assert hist.shape == want.shape == (side.SOLVER_E, side.SOLVER_MAX_ITERATIONS + 1,
                                        side.SOLVER_D)
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(want))
    np.testing.assert_allclose(hist, want, rtol=0, atol=1e-10, equal_nan=True)
    plain = _port_solve(case)
    assert torch.equal(res.x, plain.x)
    assert torch.equal(res.loss_history.nan_to_num(7.0), plain.loss_history.nan_to_num(7.0))


@pytest.mark.parametrize("case", ["logistic_l2_tron", "squared_l2_tron_warm",
                                  "poisson_l2_tron_warm"])
def test_batched_hessian_vector_is_masked_glm_hessian_vector(case):
    """One lane of the batched Hv == the port's single-objective Hv on that
    lane's real rows; padded rows with a non-finite l'' do not poison."""
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    loss = TL.BY_NAME[side.SOLVER_CASES[case][0]]
    blocks, _ = _blocks(case)
    rng = np.random.default_rng(6)
    c = torch.from_numpy(rng.normal(size=(side.SOLVER_E, side.SOLVER_D)) * 0.3)
    v = torch.from_numpy(rng.normal(size=(side.SOLVER_E, side.SOLVER_D)))
    hv = tre.batched_hessian_vector(loss, blocks, c, v, 0.7)
    for e in range(side.SOLVER_E):
        rows = blocks.mask[e] > 0
        obj = GLMObjective(loss, blocks.x[e][rows], blocks.labels[e][rows],
                           weights=blocks.weights[e][rows],
                           offsets=blocks.offsets[e][rows], l2_weight=0.7)
        np.testing.assert_allclose(hv[e].numpy(), obj.hessian_vector(c[e], v[e]).numpy(),
                                   rtol=1e-12, atol=1e-13)
    pad = blocks.mask == 0
    poisoned = tre.EntityBlocks(blocks.x, blocks.labels, blocks.mask, blocks.weights,
                                torch.where(pad, torch.full_like(blocks.offsets, 1e6),
                                            blocks.offsets))
    assert torch.equal(tre.batched_hessian_vector(loss, poisoned, c, v, 0.7), hv)


def test_mesh_raises():
    """A mesh, refused until entity sharding was ported, now solves: on a
    1x1 mesh (no process group) the batched solve is the one without a
    mesh, bit for bit (multi-rank meshes: test_torch_mesh.py)."""
    from photon_ml_tpu_torch.parallel import make_mesh
    blocks, x0 = _blocks("logistic_l2")
    x0 = torch.zeros((blocks.num_entities, blocks.dim), dtype=blocks.x.dtype)
    plain = tre.fit_random_effects(blocks, TL.LOGISTIC, None, x0=x0)
    meshed = tre.fit_random_effects(blocks, TL.LOGISTIC, make_mesh(1, 1, device="cpu"),
                                    x0=x0, cache_key=("solver-test",))
    for f in ("x", "value", "iterations", "loss_history"):
        # NaN past each lane's last iteration: array_equal's NaN rule
        np.testing.assert_array_equal(getattr(meshed, f).numpy(),
                                      getattr(plain, f).numpy(), err_msg=f)


def test_zero_iterations_and_empty_batch():
    blocks, x0 = _blocks("logistic_l2")
    r = batched.lbfgs(lambda c: tre.batched_value_and_gradient(TL.LOGISTIC, blocks, c),
                      x0, max_iterations=0)
    assert torch.equal(r.x, x0) and int(r.iterations.sum()) == 0
    assert (r.reason == 1).all()  # MAX_ITERATIONS
    empty = torch.zeros((0, 3), dtype=torch.float64)
    r = batched.lbfgs(lambda c: (c.sum(-1), c), empty)
    assert r.x.shape == (0, 3) and r.iterations.shape == (0,)


def test_score_and_variance_helpers():
    """score_by_entity, scatter_local_to_global, score_entity_blocks and
    random_effect_variances against plain numpy."""
    rng = np.random.default_rng(4)
    coef = rng.normal(size=(4, 3))
    proj = np.array([[0, 2, -1], [1, 3, 4], [4, -1, -1], [0, 1, 2]])
    g = tre.scatter_local_to_global(torch.from_numpy(coef), proj, 5).numpy()
    want = np.zeros((4, 5))
    for e in range(4):
        for k in range(3):
            if proj[e, k] >= 0:
                want[e, proj[e, k]] += coef[e, k]
    np.testing.assert_array_equal(g, want)
    x = rng.normal(size=(7, 5))
    lanes = np.array([0, 3, -1, 2, 2, 1, 9])
    s = tre.score_by_entity(torch.from_numpy(want), torch.from_numpy(x),
                            torch.from_numpy(lanes)).numpy()
    ok = (lanes >= 0) & (lanes < 4)
    np.testing.assert_allclose(s, np.where(ok, (x * want[np.clip(lanes, 0, 3)]).sum(1), 0.0))
    assert tre.score_by_entity(torch.zeros((0, 5)), torch.from_numpy(x),
                               torch.from_numpy(lanes)).abs().sum() == 0
    blocks, _ = _blocks("logistic_l2")
    c = torch.from_numpy(rng.normal(size=(side.SOLVER_E, side.SOLVER_D)))
    sb = tre.score_entity_blocks(c, blocks).numpy()
    p = side.solver_problem("logistic_l2")
    np.testing.assert_allclose(
        sb, (np.einsum("esd,ed->es", p["x"], c.numpy()) + p["offsets"]) * p["mask"])
    var = tre.random_effect_variances(
        blocks, TL.LOGISTIC, c, RegularizationContext(RegularizationType.L2), 2.0).numpy()
    z = np.einsum("esd,ed->es", p["x"], c.numpy()) + p["offsets"]
    s_ = 1.0 / (1.0 + np.exp(-z))
    d2 = s_ * (1 - s_) * p["weights"] * p["mask"]
    np.testing.assert_allclose(var, 1.0 / (np.einsum("es,esd->ed", d2, p["x"] ** 2)
                                           + 2.0 + 1e-12), rtol=1e-12)
