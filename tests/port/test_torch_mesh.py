"""Parity of the port's multi-rank training (parallel/mesh.py,
mesh_residency.py, fixed_effect.py, random_effect.py, factored.py and the
estimator's `mesh=`) with the JAX package's mesh fits.

The JAX side (mesh_jax_side.py mesh) and the port side (four gloo ranks
of mesh_port_side.py mesh) each run once per test process, at the same
time (mesh_port_side.mesh_results, shared with
test_torch_mesh_streaming.py, whose scenarios they also run), in
float64 on the CPU: GLMix (config 4's shape, cut) and a fixed effect with
a factored random effect on meshes 4x1, 2x2 and 1x4 (the fixed effect
takes the consensus-ADMM lane when the feature axis is wider than 1, in
both packages), and a sparse fixed effect on 2x1 (the port's shards carry
their own column views, the JAX package's none); on the port side only, a
1x1 mesh and the fits without a mesh.  Objective histories agree within
1e-10 relative and coefficients within 1e-8 (JAX's own mesh against one
device differs by 3.3e-13, BENCH_mesh.json); the ranks of each mesh agree
bit for bit; a 1x1 mesh is the fit without a mesh bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest

import mesh_jax_side as mj
import mesh_port_side as mp

HISTORY_RTOL, COEF_ATOL = 1e-10, 1e-8
JAX_CASES = ([("glmix", s) for s in mj.MESH_SHAPES]
             + [("factored", s) for s in mj.FACTORED_SHAPES]
             + [("sparse", mj.SPARSE_SHAPE)])
PORT_CASES = JAX_CASES + [("glmix", (1, 1))]
ids = lambda case: f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mp.mesh_results(tmp_path_factory)


def _flat(coefficients: dict) -> dict:
    out = {}
    for name, c in coefficients.items():
        parts = c if isinstance(c, tuple) else (c,)
        for k, a in enumerate(parts):
            out[f"{name}/{k}"] = np.asarray(a)
    return out


def _close_histories(got, want, rtol):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("case", JAX_CASES, ids=ids)
def test_mesh_fit_matches_jax(results, case):
    jax, port = results
    got, want = port[0][case], jax[case]
    _close_histories(got["history"], want["history"], HISTORY_RTOL)
    g, w = _flat(got["coefficients"]), _flat(want["coefficients"])
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=COEF_ATOL, err_msg=k)
    for spec, hist in want["validation"].items():
        _close_histories(got["validation"][spec], hist, 1e-9)


@pytest.mark.parametrize("case", PORT_CASES, ids=ids)
def test_ranks_are_bit_equal(results, case):
    _, port = results
    ranks = case[1][0] * case[1][1]
    ref = port[0][case]
    for r in range(1, len(port)):
        got = port[r][case]
        if r >= ranks:
            assert got is None  # outside the mesh
            continue
        assert got["history"] == ref["history"]
        g, w = _flat(got["coefficients"]), _flat(ref["coefficients"])
        for k in g:
            assert np.array_equal(g[k], w[k]), k


def test_mesh_1x1_equals_no_mesh(results):
    _, port = results
    got, want = port[0][("glmix", (1, 1))], port[0][("glmix", None)]
    assert got["history"] == want["history"]
    g, w = _flat(got["coefficients"]), _flat(want["coefficients"])
    for k in g:
        assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("case", [("glmix", (4, 1)), ("factored", (4, 1)),
                                  ("sparse", mj.SPARSE_SHAPE)], ids=ids)
def test_data_parallel_fit_matches_no_mesh(results, case):
    """Without a feature axis the mesh splits only the sums: the fit is the
    one without a mesh (on rank 0) up to summation order.  The sparse
    shards carry their own column views."""
    _, port = results
    got, want = port[0][case], port[0][(case[0], None)]
    _close_histories(got["history"], want["history"], HISTORY_RTOL)
    g, w = _flat(got["coefficients"]), _flat(want["coefficients"])
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=COEF_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", mj.MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_warm_iteration_stages_no_cold_bytes(results, shape):
    """The warm outer iteration stages no static data on any rank, and on
    a data-only mesh at most coefficients + offsets of the rank's blocks
    (bench.py's _warm_operand_bound, per rank).  The ADMM lane (a feature
    axis) also stages the polish's operands, so it is held to cold = 0
    only, as bench.py's mesh legs (data meshes) are."""
    _, port = results
    for rank in port:
        rec = rank[("glmix", shape)]
        for name in ("fixed", "perUser"):
            cold = rec["trackers"][f"0/{name}"]["staged"]
            warm = rec["trackers"][f"1/{name}"]["staged"]
            assert cold["cold"] > 0 and warm["cold"] == 0, (name, cold, warm)
            if shape[1] == 1:
                assert 0 < warm["warm"] <= rec["warm_bounds"][name], name


def test_data_mesh_collectives_per_pass(results):
    """On the 4x1 mesh every collective is a data-axis all_reduce: one per
    fixed-effect value+gradient pass, one per fixed-effect rescore, and
    per random-effect visit one per bucket (the table) plus one rescore."""
    _, port = results
    rec = port[0][("glmix", (4, 1))]
    passes = sum(t["fg_count"] for k, t in rec["trackers"].items()
                 if k.endswith("/fixed"))
    visits = sum(1 for k in rec["trackers"] if k.endswith("/fixed"))
    re_visits = sum(1 for k in rec["trackers"] if k.endswith("/perUser"))
    expect = passes + visits + re_visits * (rec["buckets"]["perUser"] + 1)
    assert rec["collectives"] == {
        "all_reduce.data.calls": expect,
        "all_reduce.data.elements": rec["collectives"]["all_reduce.data.elements"]}


def test_bf16_mesh_fit_matches_jax(results):
    """A bf16 X on the monolithic lane of a 2x1 mesh, as the JAX package's
    fit_fixed_effect on a bf16 design (mesh_jax_side.bf16_mesh_problem): X
    stays bf16 in each rank's staged block, the labels, weights and the
    solve take x0's float64 (the JAX package's result dtype too), every
    product promotes X exactly, so the fits agree as the float64 mesh fits
    do: the same iterations and stop reason, histories within
    HISTORY_RTOL, coefficients within COEF_ATOL; the two ranks bit for bit,
    one data-axis all_reduce a pass."""
    jax, port = results
    want = jax[("bf16", mj.BF16_SHAPE)]
    got = port[0][("bf16", mj.BF16_SHAPE)]
    assert want["dtype"] == "float64" and got["dtype"] == "torch.float64"
    assert got["staged_dtype"] == "torch.bfloat16"
    assert got["staged_rows"] == -(-mj.BF16_N // 2)
    assert got["iterations"] == want["iterations"] > 0
    assert got["reason"] == want["reason"]
    _close_histories(got["loss_history"], want["loss_history"], HISTORY_RTOL)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=COEF_ATOL)
    other = port[1][("bf16", mj.BF16_SHAPE)]
    assert np.array_equal(other["x"], got["x"])
    assert np.array_equal(other["loss_history"], got["loss_history"])
    assert all(("bf16", mj.BF16_SHAPE) not in rank for rank in port[2:])
    assert got["collectives"]["all_reduce.data.calls"] >= got["iterations"]


def test_bf16_admm_raises_in_both_packages(results):
    """The consensus-ADMM lane takes no bf16 design in either package: the
    JAX package's Gram eigendecomposition raises (no bfloat16 eigh,
    photon_ml_tpu/parallel/fixed_effect.py:243), and the port raises on
    every rank of the mesh, naming that site, before any collective."""
    jax, port = results
    chain = jax[("bf16_admm", mj.BF16_ADMM_SHAPE)]["error"]
    assert chain and any("NotImplementedError" in e and "bfloat16" in e for e in chain)
    for rank in port[:2]:
        err = rank[("bf16_admm", mj.BF16_ADMM_SHAPE)]["error"]
        assert err and "fixed_effect.py:243" in err[0]
