"""Parity of the port's consensus-ADMM lane (optim/admm.py and
parallel/fixed_effect.py::fit_fixed_effect_admm) with the JAX package's.

The JAX side (mesh_jax_side.py admm) and the port side (four gloo ranks of
mesh_port_side.py admm) each run once per module, at the same time, in
float64 on the CPU, bench.py's _admm_problem cut to 384 x 14 for logistic
and squared loss under L2 and logistic loss under L1, on meshes 1x2 and
2x2.  With the tolerance 0 both packages run the same number of
iterations and their histories agree entry by entry within 1e-9; the
port's converged solve lands within 1e-6 of the monolithic solver
(bench.py's gate) and its L1 support is OWLQN's.  Each iteration makes
exactly one [n_local] feature-axis all_reduce and one [d_F] data-axis
all_reduce, by the mesh's counter (the JAX package counts them in its HLO).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mesh_jax_side as mj
import mesh_port_side as mp

CASES = [(c, s) for c in mj.ADMM_CASES for s in mj.ADMM_SHAPES]
ids = lambda case: f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("admm")
    jax_proc = mj.run_jax_side("admm", root)
    ranks = mp.start_ranks("admm", root)
    port = mp.read_ranks(ranks, "admm", root)
    return mj.read_results(jax_proc, "admm", root), port


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_admm_matches_jax(results, case):
    jax, port = results
    got, want = port[0][("fixed",) + case], jax[case]
    assert got["iterations"] == want["iterations"] == mj.ADMM_ITERATIONS
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["gnorm_history"], want["gnorm_history"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_admm_collectives_per_iteration(results, case):
    """Per iteration: one [n_local] feature-axis all_reduce, one [d_F]
    data-axis all_reduce and one packed scalar sum; outside the loop the
    Gram (data axis, [d_F, d_F]) and the eigenvalue table (feature axis),
    the initial margins and scalars, and the solution's assembly."""
    _, port = results
    got = port[0][("fixed",) + case]
    k, n_local, d_f = got["iterations"], got["n_local"], got["block_width"]
    F = case[1][1]
    calls = got["collectives"]
    assert calls["all_reduce.data.calls"] == k + 1
    assert calls["all_reduce.data.elements"] == k * d_f + d_f * d_f
    assert calls["all_reduce.feature.calls"] == k + 2
    assert calls["all_reduce.feature.elements"] == (k + 1) * n_local + F * d_f
    assert calls["all_reduce.world.calls"] == k + 2


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_admm_ranks_are_bit_equal(results, case):
    _, port = results
    ranks = case[1][0] * case[1][1]
    ref = port[0][("fixed",) + case]
    for r in range(1, ranks):
        got = port[r][("fixed",) + case]
        assert np.array_equal(got["x"], ref["x"])
        assert np.array_equal(got["loss_history"], ref["loss_history"])


def _penalized(case, c):
    loss, reg, weight = mj.ADMM_CASES[case]
    x, y = mj.admm_problem(loss)
    z = x @ c
    data = (np.sum(np.logaddexp(0.0, z) - y * z) if loss == "logistic"
            else 0.5 * np.sum((z - y) ** 2))
    return data + (0.5 * weight * c @ c if reg == "l2"
                   else weight * np.abs(c).sum())


@pytest.mark.parametrize("case", list(mj.ADMM_CASES))
def test_admm_matches_monolithic(results, case):
    """The converged consensus solve (polish off) against the monolithic
    host-stepped solver (LBFGS, or OWLQN under L1), bench.py's gate: the
    penalized objective within 1e-6 relative, and under L1 the same
    support."""
    _, port = results
    admm, mono = port[0][("converged", case)]["x"], port[0][("monolithic", case)]
    gap = abs(_penalized(case, admm) - _penalized(case, mono)) / abs(_penalized(case, mono))
    assert gap <= 1e-6
    if mj.ADMM_CASES[case][1] == "l1":
        support = np.flatnonzero(mono)
        assert 0 < len(support) < mj.ADMM_D
        np.testing.assert_array_equal(np.flatnonzero(admm), support)


def test_fold_x0_matches_jax():
    """ADMM's [d] warm start folded to the [F, d_F] shard grid, as the JAX
    package folds it (zero-padded tail)."""
    from photon_ml_tpu.parallel.fixed_effect import _fold_x0 as jax_fold
    from photon_ml_tpu_torch.parallel.fixed_effect import _fold_x0
    x0 = np.arange(1.0, 12.0)
    for F in (1, 2, 3, 4):
        width = -(-x0.shape[0] // F)
        want = jax_fold(x0, F, width)
        np.testing.assert_array_equal(_fold_x0(x0, F, width), want)
        np.testing.assert_array_equal(
            _fold_x0(torch.as_tensor(x0), F, width).numpy(), want)
        np.testing.assert_array_equal(want.reshape(-1)[: x0.shape[0]], x0)


def test_admm_config_round_trips_with_jax():
    """A GLM's `admm` block loads in either package and writes the same
    JSON (so the checkpoint fingerprints agree)."""
    import game_jax_side as side
    from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
    from photon_ml_tpu_torch.game import GameTrainingConfig
    d = side.glmix_config_dict()
    d["coordinates"]["fixed"]["optimization"]["admm"] = {
        "rho": 2.0, "max_iterations": 50, "polish": False}
    d["coordinates"]["fixed"]["shard_features"] = True
    port, jax = GameTrainingConfig.from_dict(d), JConfig.from_dict(d)
    assert port.to_dict() == jax.to_dict()
    assert port.coordinates["fixed"].optimization.admm.rho == 2.0
