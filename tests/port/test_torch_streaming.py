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


# -- a bf16 host X on the streamed chunk -------------------------------------

@pytest.fixture(scope="module")
def bf16x(tmp_path_factory):
    return side.shared_results("bf16x", tmp_path_factory)


def _bf16_objective(form: str, **kw):
    """The bf16x problem's objective over a bf16 host X given as a CPU
    torch.bfloat16 tensor, or as its raw uint16 bits made into one by
    convert.bf16_from_numpy (the JAX side streams the same bits as an
    ml_dtypes array)."""
    from photon_ml_tpu_torch import convert
    p = side.bf16x_problem()
    xb = torch.from_numpy(p["x"]).to(torch.bfloat16)
    x = (xb if form == "tensor"
         else convert.bf16_from_numpy(xb.view(torch.int16).numpy().view(np.uint16)))
    return p, ChunkedGLMObjective(
        BY_NAME["logistic"], x, p["y"], ChunkPlan.build(side.BF16X_N, chunk_rows=side.BF16X_CHUNK),
        weights=p["w"], offsets=p["o"], l2_weight=1.0, device="cpu", dtype=torch.float64, **kw)


@pytest.mark.parametrize("form", ["tensor", "uint16"])
def test_bf16_streamed_oracle_matches_jax(bf16x, form):
    """value, value_and_gradient, hessian_vector, hessian_diagonal, scores
    and one stochastic pass over a bf16 host X, against the JAX package's
    ChunkedGLMObjective over an ml_dtypes bf16 X with the same bits: both
    promote X exactly to the float64 coefficients, so float64 results
    within REL (the stochastic pass's 2 epochs of coordinate steps within
    SOLVE_REL)."""
    p, obj = _bf16_objective(form)
    assert obj.x.dtype == np.uint16 and obj.x.nbytes == 2 * side.BF16X_N * side.BF16X_D
    c, v = _t(p["c"]), _t(p["v"])
    got = {"value": obj.value(c), "hessian_vector": obj.hessian_vector(c, v),
           "hessian_diagonal": obj.replace(offsets=None).hessian_diagonal(c),
           "scores": obj.scores(c)}
    got["vg_value"], got["vg_gradient"] = obj.value_and_gradient(c)
    for name, t in got.items():
        assert t.dtype == torch.float64, name
        np.testing.assert_allclose(t.numpy(), bf16x[f"chunk/{name}"], rtol=REL, atol=REL,
                                   err_msg=name)
    c_out, entry = obj.stochastic_pass(c, local_epochs=side.BF16X_EPOCHS,
                                       seed=side.BF16X_PASS_SEED)
    np.testing.assert_allclose(c_out.numpy(), bf16x["chunk/stochastic_x"], rtol=SOLVE_REL,
                               atol=SOLVE_REL)
    np.testing.assert_allclose(entry.item(), float(bf16x["chunk/stochastic_entry"]),
                               rtol=SOLVE_REL)


def test_bf16_chunk_stages_two_bytes_per_element():
    """The bits are staged as they are: a pass moves 2 bytes per X element
    (the float32 objective over the same values, 8 in float64),
    data/streaming.py's stream_row_bytes counts 2, and each staged chunk is
    bf16 where the aggregators see it; a bf16 compute dtype is refused
    (numpy holds no bf16 labels)."""
    from photon_ml_tpu_torch.data.streaming import stream_row_bytes
    p, obj = _bf16_objective("tensor")
    wide = ChunkedGLMObjective(
        BY_NAME["logistic"], torch.from_numpy(p["x"]).to(torch.bfloat16).float().numpy(),
        p["y"], ChunkPlan.build(side.BF16X_N, chunk_rows=side.BF16X_CHUNK),
        weights=p["w"], offsets=p["o"], device="cpu", dtype=torch.float64)
    c = _t(p["c"])
    obj.value_and_gradient(c)
    wide.value_and_gradient(c)
    rows = sum(s.padded_rows for s in obj.plan.chunks)
    assert wide.stats.total_bytes - obj.stats.total_bytes == rows * side.BF16X_D * 6
    assert stream_row_bytes(side.BF16X_D, obj.x.itemsize, 8) == 2 * side.BF16X_D + 32
    seen = [ch["x"].dtype for _, ch in obj._stream()]
    assert seen == [torch.bfloat16] * obj.plan.num_chunks
    with pytest.raises(TypeError, match="float32 or float64"):
        ChunkedGLMObjective(BY_NAME["logistic"], p["x"], p["y"], obj.plan, device="cpu",
                            dtype=torch.bfloat16)


def test_uint16_integer_block_streams_as_its_values():
    """A plain uint16 host X is integer counts, not bf16 bits: the streamed
    objective casts it to the compute dtype, as the resident path does
    (features.as_feature_matrix), so a single-chunk pass equals the
    resident GLMObjective's, and a FixedEffectCoordinate over a uint16
    shard fits the same model streamed as resident (float64, rtol 1e-10:
    the two sum in different orders)."""
    from photon_ml_tpu_torch.data.game_data import GameDataset
    from photon_ml_tpu_torch.game.config import FixedEffectCoordinateConfig
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    from photon_ml_tpu_torch.ops.features import as_feature_matrix
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    rng = np.random.default_rng(24)
    n, d = 256, 5
    x = rng.integers(0, 40_000, size=(n, d)).astype(np.uint16)
    y = (rng.random(n) < 0.5).astype(np.float64)
    c = _t(rng.normal(size=d) * 1e-5)
    obj = ChunkedGLMObjective(BY_NAME["logistic"], x, y, ChunkPlan.build(n, chunk_rows=n),
                              device="cpu", dtype=torch.float64)
    assert obj.x.dtype == np.float64 and np.array_equal(obj.x, x.astype(np.float64))
    res = GLMObjective(BY_NAME["logistic"], as_feature_matrix(x, "cpu", torch.float64), _t(y))
    for a, b in zip(obj.value_and_gradient(c), res.value_and_gradient(c)):
        assert torch.equal(a, b)
    fits = {}
    for mode in ("resident", "streamed"):
        data = GameDataset(response=y, feature_shards={"g": x})
        coord = FixedEffectCoordinate(
            "fe", data, FixedEffectCoordinateConfig("g", memory_mode=mode, chunk_rows=64),
            "logistic_regression", device="cpu", dtype=torch.float64)
        assert coord.streamed == (mode == "streamed")
        model, _ = coord.update(coord.initial_model(), torch.zeros(n, dtype=torch.float64))
        fits[mode] = model.glm.coefficients.means
    np.testing.assert_allclose(fits["streamed"].numpy(), fits["resident"].numpy(),
                               rtol=1e-10, atol=1e-14)
