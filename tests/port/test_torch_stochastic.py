"""Port optim/stochastic.py (the stochastic lane over a chunk stream) == the
JAX package's.

bench.py --stoch --smoke's out-of-core problem (16,384 x 16 logistic, 8
chunks, 2 passes of 6 local epochs, seed 7) with both merges, and at a
smaller size a Poisson objective (the step clip) and a standardized one:
the per-pass streaming objective within 1e-9 relative, the coarse
coefficients within 1e-8, the LBFGS polish from them within 1e-10 (its
iterations and reason equal), and the stream accounting equal.  The
`solve.local` fault site: a transient fault retries to a bit-equal
result; a fatal one raises LocalSolveError naming the chunk.  The JAX side
is game_jax_side.py's stream mode (shared, see test_torch_streaming.py).
"""
import json

import numpy as np
import pytest
import torch

import game_jax_side as side
from test_torch_streaming import check_result
from photon_ml_tpu_torch.data.streaming import ChunkPlan
from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective, LocalSolveError
from photon_ml_tpu_torch.ops.losses import BY_NAME
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.optim.schedule import StochasticPlan
from photon_ml_tpu_torch.optim.stochastic import resolve_step_clip
from photon_ml_tpu_torch.optim.streaming import solve_streamed
from photon_ml_tpu_torch.utils import faults

HIST_REL = 1e-9


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return side.stream_results(tmp_path_factory.mktemp("stoch") / "jax.npz")


def stoch_objective(case):
    loss, n, d, merge, standardized = side.STOCH_CASES[case]
    x, y = side.stoch_problem(case)
    norm = None
    if standardized:
        f, s = side.stoch_norm(x)
        norm = NormalizationContext(torch.from_numpy(f), torch.from_numpy(s), d - 1)
    obj = ChunkedGLMObjective(BY_NAME[loss], x, y,
                              ChunkPlan.build(n, chunk_rows=max(n // 8, 256)),
                              norm=norm, device="cpu", dtype=torch.float64)
    plan = StochasticPlan(passes=side.STOCH_PASSES, local_epochs=side.STOCH_EPOCHS,
                          seed=side.STOCH_SEED, merge=merge)
    return obj, plan, d


def run(case):
    obj, plan, d = stoch_objective(case)
    cfg = OptimizerConfig(max_iterations=80, tolerance=1e-9)
    l2 = RegularizationContext(RegularizationType.L2)
    coarse = solve_streamed(obj, torch.zeros(d, dtype=torch.float64), cfg, l2, 1.0,
                            stochastic=plan)
    polish = solve_streamed(obj, coarse.x, cfg, l2, 1.0)
    return obj, coarse, polish


@pytest.mark.parametrize("case", list(side.STOCH_CASES))
def test_stochastic_lane_matches_jax(jax_side, case):
    obj, coarse, polish = run(case)
    key = f"stoch/{case}"
    hist, want = coarse.loss_history.numpy(), jax_side[f"{key}/loss_history"]
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(hist[finite], want[finite], rtol=HIST_REL)
    assert coarse.iterations == side.STOCH_PASSES and coarse.fg_count == side.STOCH_PASSES
    np.testing.assert_allclose(coarse.x.numpy(), jax_side[f"{key}/x"], rtol=1e-8, atol=1e-10)
    check_result(polish, jax_side, f"{key}/polish")
    assert obj.stats.snapshot() == json.loads(str(jax_side[f"{key}/stats"]))


def test_lane_does_more_work_per_staged_byte():
    """Each staged chunk is pinned for the local epochs: the lane's
    examples per staged byte is local_epochs times a strict pass's."""
    obj, plan, d = stoch_objective("sequential")
    obj.value_and_gradient(torch.zeros(d, dtype=torch.float64))
    strict = obj.stats.snapshot()["examples_per_staged_byte"]
    obj2, plan, d = stoch_objective("sequential")
    obj2.stochastic_pass(torch.zeros(d, dtype=torch.float64),
                         local_epochs=plan.local_epochs, seed=plan.seed)
    assert obj2.stats.snapshot()["examples_per_staged_byte"] == pytest.approx(
        plan.local_epochs * strict)


def test_step_clip_resolves_per_loss():
    assert resolve_step_clip(BY_NAME["logistic"], None) == float("inf")
    assert resolve_step_clip(BY_NAME["poisson"], None) == 1.0
    assert resolve_step_clip(BY_NAME["poisson"], 0.25) == 0.25


def _pass(obj, d):
    return obj.stochastic_pass(torch.zeros(d, dtype=torch.float64), local_epochs=2,
                               seed=3, pass_index=1)


def test_transient_local_fault_retries_bit_equal():
    obj, _, d = stoch_objective("poisson")
    want = _pass(obj, d)
    plan = faults.FaultPlan.from_dict(
        {"faults": [{"site": "solve.local", "hits": [2, 3], "match": {"epoch": 1}}]})
    with faults.injected(plan):
        got = _pass(obj, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("action,hits", [("fatal", [4]), ("transient", [4, 5, 6])],
                         ids=["fatal", "exhausted"])
def test_failed_local_solve_raises_naming_the_chunk(action, hits):
    obj, _, d = stoch_objective("poisson")
    plan = faults.FaultPlan.from_dict(
        {"faults": [{"site": "solve.local", "action": action, "hits": hits}]})
    with faults.injected(plan), pytest.raises(LocalSolveError) as e:
        _pass(obj, d)
    assert e.value.chunk_index == 3 and "chunk 3 of 8" in str(e.value)
    assert e.value.__cause__ is not None
