"""Parity of the port's streaming over a mesh (data/streaming.py's
`process_block` and rank blocks, ops/chunked.py's `ChunkedGLMObjective`
with `mesh=`, optim/stochastic.py's reduced coordinate steps, the streamed
fixed effect of game/coordinates.py on a mesh) with the JAX package's.

The fits run among the scenarios of the mesh group (mesh_port_side.py
mesh: four gloo ranks, float64 on the CPU; the JAX side in
mesh_jax_side.py's `mstream` part, beside the mesh group's other JAX
processes), once per test process and shared with test_torch_mesh.py:

  - tests/test_mesh_residency.py's mesh-streamed GLMix fit (n 2,400,
    d_global 96, 80 users x 4, LBFGS 6, its per-device budget rule) on
    2 x 1 and 2 x 2, against the JAX package's on the same meshes of its
    virtual devices: histories within 1e-9 relative, coefficients within
    1e-8, the ranks bit-equal, each rank's residency record per device
    and under its budget, and one pass staging 1/D of a one-rank pass on
    the same plan;
  - tests/test_stochastic.py's stochastic lane on a data mesh (n 4,096,
    d 10, chunks of 1,024 rows, row multiple 8, 2 passes of 3 epochs),
    both merges, on 2 x 1 and 4 x 1 against the JAX package's 8 x 1:
    histories and x within rtol 1e-9, the ranks bit-equal, and
    passes x chunks x (1 + d x epochs) data-axis all_reduces;
  - the streamed fit on a 1 x 1 mesh against the streamed fit without a
    mesh, bit for bit.

The plan arithmetic and the refusal of a plan that the data axis does not
divide run in this process (numpy only; no XLA program is compiled).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mesh_jax_side as mj
import mesh_port_side as mp

HISTORY_RTOL, COEF_ATOL = 1e-9, 1e-8
STOCH_RTOL, STOCH_ATOL = 1e-9, 1e-12
shape_id = lambda s: f"{s[0]}x{s[1]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mp.mesh_results(tmp_path_factory)


# (rows, chunk_rows, row_multiple): full chunks and tails, tails whose last
# blocks are all padding (300 rows -> 512 on 4 ranks: rank 3 holds 384-511)
PLANS = [(300, 256, 4), (300, 512, 4), (2160, 256, 2), (2400, 1024, 8),
         (4096, 1024, 8), (5000, 1024, 3), (777, 256, 1), (1, 256, 2)]


@pytest.mark.parametrize("rows,chunk_rows,multiple", PLANS,
                         ids=lambda v: str(v))
def test_process_blocks_match_jax(rows, chunk_rows, multiple):
    """ChunkPlan.build(row_multiple=) and process_block over every shard
    range equal the JAX package's; each rank's block plan covers exactly
    its real rows of every chunk."""
    from photon_ml_tpu.data.streaming import ChunkPlan as JaxPlan
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    plan = ChunkPlan.build(rows, chunk_rows=chunk_rows, row_multiple=multiple)
    want = JaxPlan.build(rows, chunk_rows=chunk_rows, row_multiple=multiple)
    assert plan.chunk_rows == want.chunk_rows
    assert [(c.index, c.start, c.stop, c.padded_rows) for c in plan.chunks] == [
        (c.index, c.start, c.stop, c.padded_rows) for c in want.chunks]
    for num in sorted({1, 2, multiple}):
        for spec, jspec in zip(plan.chunks, want.chunks):
            for lo in range(num):
                for hi in range(lo + 1, num + 1):
                    kw = dict(num_shards=num, shard_lo=lo, shard_hi=hi)
                    if spec.padded_rows % num:
                        with pytest.raises(ValueError) as got:
                            plan.process_block(spec, **kw)
                        with pytest.raises(ValueError) as exp:
                            want.process_block(jspec, **kw)
                        assert str(got.value) == str(exp.value)
                    else:
                        assert plan.process_block(spec, **kw) == \
                            want.process_block(jspec, **kw)
        if any(c.padded_rows % num for c in plan.chunks):
            continue
        covered = np.zeros(rows, int)
        for shard in range(num):
            blocks = plan.rank_blocks(num, shard)
            assert blocks.chunk_rows == plan.chunk_rows // num
            for spec, block in zip(plan.chunks, blocks.chunks):
                lo, _ = plan.process_block(spec, num_shards=num, shard_lo=shard,
                                           shard_hi=shard + 1)
                assert block.index == spec.index
                assert block.padded_rows == spec.padded_rows // num
                assert block.start == min(spec.start + lo, spec.stop)
                covered[block.start:block.stop] += 1
        assert np.all(covered == 1)


def test_plan_the_data_axis_does_not_divide_raises_jax_text():
    """A chunk whose padded size the data axis does not divide raises the
    JAX package's ValueError, word for word, before anything stages."""
    import jax
    from photon_ml_tpu.data.streaming import ChunkPlan as JaxPlan
    from photon_ml_tpu.ops.chunked import ChunkedGLMObjective as JaxChunked
    from photon_ml_tpu.ops.losses import LOGISTIC as JAX_LOGISTIC
    from photon_ml_tpu.parallel import make_mesh as jax_mesh
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.parallel.mesh import Mesh
    x = np.ones((1000, 3))
    y = np.zeros(1000)
    with pytest.raises(ValueError) as exp:
        JaxChunked(JAX_LOGISTIC, x, y, JaxPlan.build(1000, chunk_rows=256),
                   mesh=jax_mesh(3, 1, devices=jax.devices()[:3]))
    with pytest.raises(ValueError) as got:
        ChunkedGLMObjective(LOGISTIC, x, y, ChunkPlan.build(1000, chunk_rows=256),
                            mesh=Mesh(3, 1, 0, torch.device("cpu")), device="cpu",
                            dtype=torch.float64)
    assert str(got.value) == str(exp.value)
    assert "row_multiple=data_axis" in str(got.value)


def _flat(coefficients: dict) -> dict:
    return {name: np.asarray(c) for name, c in coefficients.items()}


@pytest.mark.parametrize("shape", mj.MSTREAM_SHAPES, ids=shape_id)
def test_mesh_streamed_fit_matches_jax(results, shape):
    jax, port = results
    want, got = jax[("mstream", shape)], port[0][("mstream", shape)]
    assert "error" not in want, want.get("error")
    assert got["budget"] == want["budget"]
    assert len(got["history"]) == len(want["history"])
    np.testing.assert_allclose(got["history"], want["history"], rtol=HISTORY_RTOL, atol=0)
    g, w = _flat(got["coefficients"]), _flat(want["coefficients"])
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=COEF_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", mj.MSTREAM_SHAPES, ids=shape_id)
def test_mesh_streamed_ranks_are_bit_equal(results, shape):
    _, port = results
    ranks = shape[0] * shape[1]
    ref = port[0][("mstream", shape)]
    for r in range(1, len(port)):
        got = port[r][("mstream", shape)]
        if r >= ranks:
            assert got is None  # outside the mesh
            continue
        assert got["history"] == ref["history"]
        for k, a in _flat(got["coefficients"]).items():
            assert np.array_equal(a, np.asarray(ref["coefficients"][k])), k


@pytest.mark.parametrize("shape", mj.MSTREAM_SHAPES, ids=shape_id)
def test_mesh_streamed_residency_per_rank(results, shape):
    """Each rank's record is per device (the JAX package's keys and
    values), under its budget with the fixed effect streamed; the data
    per device exceeds the budget; one pass stages 1/D of what one rank
    stages over the same plan, and the rank's stream counters are its
    own blocks'."""
    jax, port = results
    want = jax[("mstream", shape)]["residency"]
    resident = port[0][("mstream", None)]["residency"]
    D = shape[0]
    for rank in port[:shape[0] * shape[1]]:
        rec = rank[("mstream", shape)]
        acct, budget = rec["residency"], rec["budget"]
        assert acct["per_device"] is True and acct["data_devices"] == D
        assert acct["streamed_chunk_bytes"] == want["streamed_chunk_bytes"] != {}
        assert acct["under_budget"] is True and acct["peak_tracked_bytes"] <= budget
        assert acct["peak_tracked_bytes"] == want["peak_tracked_bytes"]
        fe_b = resident["resident_block_bytes"]["fixed"]
        re_b = resident["resident_block_bytes"]["perUser"]
        assert -(-(fe_b + re_b) // D) + resident["flat_vector_bytes"] > budget
        mine, one_rank = rec["pass_bytes"]
        assert mine * D == one_rank > 0
        chunks, chunk_rows = rec["plan"]
        stream = acct["stream"]["fixed"]
        assert stream["chunks_staged"] == chunks * stream["passes"]
        assert stream["peak_resident_chunks"] <= 2
        assert stream["examples_per_staged_byte"] == (
            stream["examples_processed"] / stream["total_bytes"])


def test_mesh_streamed_collectives_per_pass(results):
    """On 2 x 1 every collective is a data-axis all_reduce: one per streamed
    pass of the fixed effect (its solve's value+gradient passes, then its
    rescore), and per random-effect visit one for its one bucket (27 rows
    per user) plus one rescore."""
    _, port = results
    rec = port[0][("mstream", (2, 1))]
    fixed = [t for k, t in rec["trackers"].items() if k.endswith("/fixed")]
    re_visits = sum(1 for k in rec["trackers"] if k.endswith("/perUser"))
    for t in fixed:
        assert t["stream"]["passes"] == t["fg_count"] + 1
    assert rec["collectives"]["all_reduce.data.calls"] == (
        sum(t["stream"]["passes"] for t in fixed) + 2 * re_visits)
    assert set(rec["collectives"]) == {"all_reduce.data.calls", "all_reduce.data.elements"}


def test_streamed_1x1_mesh_equals_no_mesh(results):
    _, port = results
    got, want = port[0][("mstream", (1, 1))], port[0][("mstream", "none")]
    assert got["history"] == want["history"]
    for k, a in _flat(got["coefficients"]).items():
        assert np.array_equal(a, np.asarray(want["coefficients"][k])), k


@pytest.mark.parametrize("merge", mj.STOCH_MERGES)
@pytest.mark.parametrize("shape", mj.STOCH_MESHES, ids=shape_id)
def test_stochastic_mesh_matches_jax(results, shape, merge):
    jax, port = results
    want = jax[("stoch", merge, (8, 1))]
    got = port[0][("stoch", merge, shape)]
    finite = np.isfinite(want["loss_history"])
    np.testing.assert_array_equal(np.isfinite(got["loss_history"]), finite)
    np.testing.assert_allclose(got["loss_history"][finite], want["loss_history"][finite],
                               rtol=STOCH_RTOL)
    np.testing.assert_allclose(got["x"], want["x"], rtol=STOCH_RTOL, atol=STOCH_ATOL)
    # one all_reduce per chunk (entry loss and column sums) and one per
    # coordinate step
    assert got["collectives"]["all_reduce.data.calls"] == (
        mj.STOCH_PASSES * got["chunks"] * (1 + mj.STOCH_D * mj.STOCH_EPOCHS))
    for rank in port[1:shape[0]]:
        other = rank[("stoch", merge, shape)]
        assert np.array_equal(other["x"], got["x"])
        assert np.array_equal(other["loss_history"], got["loss_history"], equal_nan=True)
