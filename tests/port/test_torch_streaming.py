"""Port data/streaming.py, ops/chunked.py and optim/streaming.py == the JAX
package's.

- `ChunkPlan`s built from chunk rows or from a budget are equal (in
  process: the JAX plan is plain Python);
- the streamed oracle (value, value+gradient, Hessian-vector, Hessian
  diagonal, scores) is within 1e-12 of the JAX package's chunk-wise one,
  with and without weights and offsets, a row mask and standardization
  shifts, for three losses, and the stream accounting is equal;
- solve_streamed with LBFGS, OWLQN and TRON, uncapped and capped, gives
  histories within 1e-10 relative, the same iterations, reasons and
  passes;
- a transient `stage.fetch` / `stage.transfer` fault retries to a
  bit-equal result; a fatal one raises ChunkStagingError naming the chunk;
  an interrupt passes through unwrapped; the Prefetcher never has more
  than `depth` chunks resident.
The JAX side runs once, in a subprocess (game_jax_side.py stream, f64 CPU),
shared with test_torch_stochastic.py and test_torch_residency.py.
"""
import json

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.data.streaming import ChunkPlan as JaxChunkPlan
from photon_ml_tpu_torch.data.streaming import (
    ChunkPlan, ChunkStagingError, Prefetcher, StreamStats,
)
from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
from photon_ml_tpu_torch.ops.losses import BY_NAME
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.optim.schedule import SolveBudget
from photon_ml_tpu_torch.optim.streaming import solve_streamed
from photon_ml_tpu_torch.utils import faults

REL = 1e-12
SOLVE_REL = 1e-10


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return side.stream_results(tmp_path_factory.mktemp("stream") / "jax.npz")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, dtype=np.float64))


PLAN_CASES = [dict(chunk_rows=512), dict(chunk_rows=300), dict(chunk_rows=1),
              dict(chunk_rows=1 << 20), dict(hbm_budget_bytes=200_000, bytes_per_row=64),
              dict(hbm_budget_bytes=1, bytes_per_row=8),
              dict(chunk_rows=512, row_multiple=3)]


@pytest.mark.parametrize("n", [1, 255, 256, 3000, 65_537])
@pytest.mark.parametrize("kw", PLAN_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_chunk_plans_match_jax(n, kw):
    a, b = ChunkPlan.build(n, **kw), JaxChunkPlan.build(n, **kw)
    assert a.chunk_rows == b.chunk_rows and a.chunk_shapes == b.chunk_shapes
    assert [(c.index, c.start, c.stop, c.padded_rows) for c in a.chunks] == \
        [(c.index, c.start, c.stop, c.padded_rows) for c in b.chunks]
    assert a.chunk_bytes(40) == b.chunk_bytes(40)


def test_chunk_plan_refuses_bad_requests():
    for kw in (dict(), dict(hbm_budget_bytes=10)):
        with pytest.raises(ValueError):
            ChunkPlan.build(10, **kw)
    with pytest.raises(ValueError):
        ChunkPlan.build(0, chunk_rows=4)


def oracle_objective(case, plan=None, **kw):
    loss = side.ORACLE_CASES[case][0]
    p = side.oracle_problem(case)
    norm = (None if p["f"] is None
            else NormalizationContext(_t(p["f"]), _t(p["s"]), side.ORACLE_D - 1))
    plan = plan or ChunkPlan.build(side.ORACLE_N, chunk_rows=side.ORACLE_CHUNK)
    obj = ChunkedGLMObjective(BY_NAME[loss], p["x"], p["y"], plan, weights=p["w"],
                              offsets=p["o"], mask=p["m"], norm=norm, l2_weight=0.5,
                              device="cpu", dtype=torch.float64, **kw)
    return obj, p


def _close(got, want, rel=REL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("case", list(side.ORACLE_CASES))
def test_streamed_oracle_matches_jax(jax_side, case):
    obj, p = oracle_objective(case)
    c = _t(p["c"])
    key = f"oracle/{case}"
    v, g = obj.value_and_gradient(c)
    _close(obj.value(c), jax_side[f"{key}/value"])
    _close(v, jax_side[f"{key}/vg_value"])
    _close(g, jax_side[f"{key}/grad"])
    _close(obj.hessian_vector(c, _t(p["v"])), jax_side[f"{key}/hv"])
    if f"{key}/hd" in jax_side:
        _close(obj.hessian_diagonal(c), jax_side[f"{key}/hd"])
    else:
        with pytest.raises(ValueError, match="original-space"):
            obj.hessian_diagonal(c)
    _close(obj.scores(c), jax_side[f"{key}/scores"])
    assert obj.stats.snapshot() == json.loads(str(jax_side[f"{key}/stats"]))


def test_single_chunk_oracle_equals_resident():
    """A plan of one chunk is the resident GLMObjective's arithmetic."""
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    obj, p = oracle_objective("all", plan=ChunkPlan.build(side.ORACLE_N,
                                                          chunk_rows=1 << 13))
    tail = obj.plan.chunks[0].padded_rows - side.ORACLE_N
    pad = lambda a, fill: torch.cat([_t(a), torch.full((tail,) + a.shape[1:], fill,
                                                       dtype=torch.float64)])
    res = GLMObjective(obj.loss, pad(p["x"], 0.0), pad(p["y"], 0.5), weights=pad(p["w"], 0.0),
                       offsets=pad(p["o"], 0.0), mask=pad(p["m"], 0.0), norm=obj.norm,
                       l2_weight=0.5)
    c = _t(p["c"])
    for a, b in zip(obj.value_and_gradient(c), res.value_and_gradient(c)):
        assert torch.equal(a, b)


def _solve(case, cap, **obj_kw):
    opt, reg, lam = side.STREAM_SOLVES[case]
    opt = dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs")))
    x, y = side.solve_problem()
    obj = ChunkedGLMObjective(BY_NAME["logistic"], x, y,
                              ChunkPlan.build(side.SOLVE_N, chunk_rows=side.SOLVE_CHUNK),
                              device="cpu", dtype=torch.float64, **obj_kw)
    budget = None if cap is None else SolveBudget(cap, opt["tolerance"])
    res = solve_streamed(obj, torch.zeros(side.SOLVE_D, dtype=torch.float64),
                         OptimizerConfig(**opt),
                         RegularizationContext(RegularizationType(reg)), lam, budget=budget)
    return res, obj


def check_result(res, jax_side, key, rel=SOLVE_REL):
    assert int(res.iterations) == int(jax_side[f"{key}/iterations"])
    assert int(res.reason) == int(jax_side[f"{key}/reason"])
    for field in ("fg_count", "hv_count"):
        if f"{key}/{field}" in jax_side:
            assert int(getattr(res, field)) == int(jax_side[f"{key}/{field}"]), field
    hist, want = res.loss_history.numpy(), jax_side[f"{key}/loss_history"]
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(hist[finite], want[finite], rtol=rel)
    _close(res.x, jax_side[f"{key}/x"], rel=1e-8)


@pytest.mark.parametrize("cap", side.STREAM_CAPS, ids=lambda c: f"cap={c}")
@pytest.mark.parametrize("case", list(side.STREAM_SOLVES))
def test_streamed_solvers_match_jax(jax_side, case, cap):
    res, obj = _solve(case, cap)
    key = f"solve/{case}/{cap}"
    check_result(res, jax_side, key)
    assert obj.stats.passes == int(jax_side[f"{key}/passes"])


@pytest.mark.parametrize("site", ["stage.fetch", "stage.transfer"])
def test_transient_staging_fault_retries_bit_equal(site):
    obj, p = oracle_objective("all")
    c = _t(p["c"])
    want = obj.value_and_gradient(c)
    plan = faults.FaultPlan.from_dict({"faults": [{"site": site, "hits": [3, 4]}]})
    with faults.injected(plan):
        got = obj.value_and_gradient(c)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert obj.stats.retries == 2 and obj.stats.gave_up == 0


@pytest.mark.parametrize("action,hits", [("fatal", [3]), ("transient", [3, 4, 5])],
                         ids=["fatal", "exhausted"])
def test_failed_staging_raises_naming_the_chunk(action, hits):
    obj, p = oracle_objective("plain")
    plan = faults.FaultPlan.from_dict(
        {"faults": [{"site": "stage.fetch", "action": action, "hits": hits}]})
    with faults.injected(plan), pytest.raises(ChunkStagingError) as e:
        obj.value_and_gradient(_t(p["c"]))
    assert e.value.chunk_index == 2 and "chunk 2 of 6" in str(e.value)
    assert e.value.__cause__ is not None
    assert obj.stats.gave_up == 1


def test_interrupt_passes_through_unwrapped():
    plan = ChunkPlan.build(2000, chunk_rows=256)

    def fetch(spec):
        if spec.index == 2:
            raise KeyboardInterrupt
        return {"x": np.zeros((spec.padded_rows, 3))}

    with pytest.raises(KeyboardInterrupt):
        for _ in Prefetcher(plan, fetch, device="cpu").stream():
            pass


def test_prefetcher_holds_at_most_depth_chunks():
    """Chunk i+2 is not staged before the consumer has moved past chunk i."""
    plan = ChunkPlan.build(4000, chunk_rows=256)
    stats = StreamStats()
    for depth in (2, 3):
        seen = []
        for spec, ch in Prefetcher(plan, lambda s: {"x": np.full((s.padded_rows, 2), s.index, float)},
                                   depth=depth, stats=stats, device="cpu").stream(pin_epochs=2):
            seen.append(int(ch["x"][0, 0]))
            assert stats.resident_chunks <= depth
        assert seen == list(range(plan.num_chunks))
        assert stats.peak_resident_chunks == depth
    snap = stats.snapshot()
    assert snap["passes"] == 2 and snap["local_epochs"] == 2 * 2 * plan.num_chunks
    assert snap["examples_processed"] == 2 * 2 * 4000
    with pytest.raises(ValueError):
        Prefetcher(plan, lambda s: {}, depth=1, device="cpu")


def test_sparse_shard_is_refused():
    import scipy.sparse as sp
    with pytest.raises(TypeError, match="dense"):
        ChunkedGLMObjective(BY_NAME["logistic"], sp.csr_matrix(np.eye(4)), np.zeros(4),
                            ChunkPlan.build(4, chunk_rows=256), device="cpu")
