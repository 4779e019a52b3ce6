"""Port hyperparameter/vectorized.py and game_evaluation.py == the JAX
package's, on a small GLMix (a fixed effect and a per-user random effect,
row weights and base offsets, two outer iterations) in float64 on the CPU.

- the candidate lane (`evaluate_vmapped`, K = 5) for L2 LBFGS, elastic net
  (OWLQN with each candidate's own L1 weight), TRON, a standardized fixed
  effect, a random effect on a random projection and a sparse (CSR) fixed
  effect: per candidate, objective histories and validation AUC within
  1e-10 relative, equal iterations and stop reasons per visit;
- the path lane (`evaluate_path`), warm and cold, and with a factored
  coordinate: the same, results in the caller's order;
- the refusals: `vmap_eligible` for a streamed, a down-sampled and a
  factored coordinate, and `compatible` for a structural change, with the
  JAX package's messages;
- GaussianProcessSearch.find over GameEstimatorEvaluationFunction: the same
  candidate vectors and validation values within 1e-10;
- one batched elastic-net solve whose lanes carry their own (lambda,
  alpha), against jax.vmap of the solve over RegWeights.
The JAX side runs once for the module in a subprocess (sweep_jax_side.py),
so its vmapped GAME programs never compile in the test process.
"""
import json

import numpy as np
import pytest
import torch

import sweep_jax_side as side
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.evaluation.evaluators import AUC
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.hyperparameter import (
    GameEstimatorEvaluationFunction, GaussianProcessSearch, SweepEvaluator,
)
from photon_ml_tpu_torch.ops.lanes import FixedEffectLanes
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim import batched
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.optim.schedule import RegWeights

REL = 1e-10
F64 = dict(device="cpu", dtype=torch.float64)


def _cfg(d: dict) -> GameTrainingConfig:
    return GameTrainingConfig.from_dict(d)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.sweep_results(tmp_path_factory.mktemp("jax") / "sweep.npz")


@pytest.fixture(scope="module")
def data():
    return {sparse: side.sweep_data(build_game_dataset, sparse=sparse)
            for sparse in (False, True)}


def _sweep(data, case: str) -> SweepEvaluator:
    train, val = data[case == "sparse"]
    return SweepEvaluator(GameEstimator(_cfg(side.sweep_config_dict(case)), **F64),
                          train, val, ["AUC"])


@pytest.fixture(scope="module")
def vmapped(data):
    """case -> (the sweep, its candidate-lane results)."""
    out = {}
    for case in side.VMAP_CASES:
        sweep = _sweep(data, case)
        out[case] = (sweep, sweep.evaluate_vmapped(
            [_cfg(d) for d in side.candidate_dicts(case, side.vmap_weights())]))
    return out


@pytest.fixture(scope="module")
def paths(data):
    out = {}
    for name, (case, warm) in side.PATH_CASES.items():
        out[name] = _sweep(data, case).evaluate_path(
            [_cfg(d) for d in side.candidate_dicts(case, side.PATH_WEIGHTS)],
            warm_start=warm)
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# the outcomes of a lane that stops at its optimum: which one a lane
# reports when its gradient or function-value test sits within rounding of
# its threshold follows the order of the sums (see _check_result)
_AT_OPTIMUM = ("GRADIENT_CONVERGED", "FUNCTION_VALUES_CONVERGED", "LINE_SEARCH_FAILED")


def _check_result(jax_results, key: str, res, loose=()) -> None:
    """Histories and AUC within REL; per visit, equal iterations and stop
    reasons, except for the coordinates in `loose`, whose lanes' sums run
    in another order than the JAX package's: in the candidate lane a
    random-effect bucket's K x E lanes share one batched product over the
    blocks (JAX's vmap keeps each lane's own order), and a factored
    coordinate's projection comes from torch's SVD.  There a visit's
    iterations may differ by 1 % and at most a tenth of its lanes may
    trade one at-optimum outcome for another; every other count is
    equal."""
    want = jax_results[f"{key}/objective_history"]
    assert len(res.objective_history) == len(want) == 2 * side.SWEEP_OUTER
    assert _rel(res.objective_history, want) <= REL, key
    assert _rel(res.validation["AUC"], jax_results[f"{key}/auc"]) <= REL, key
    keys = sorted(k.split("/iterations/")[1] for k in jax_results
                  if k.startswith(f"{key}/iterations/"))
    assert sorted(res.descent.trackers) == keys
    for k in keys:
        t = res.descent.trackers[k]
        its = int(jax_results[f"{key}/iterations/{k}"])
        reasons = json.loads(str(jax_results[f"{key}/reasons/{k}"]))
        if k.split("/")[1] not in loose:
            assert t.iterations == its, (key, k)
            assert t.reasons == reasons, (key, k)
            continue
        assert abs(t.iterations - its) <= 0.01 * its, (key, k)
        lanes = sum(reasons.values())
        assert sum(t.reasons.values()) == lanes, (key, k)
        traded = 0
        for name in set(t.reasons) | set(reasons):
            diff = t.reasons.get(name, 0) - reasons.get(name, 0)
            assert diff == 0 or name in _AT_OPTIMUM, (key, k, name)
            traded += abs(diff)
        assert traded <= 2 * 0.1 * lanes, (key, k, t.reasons, reasons)


@pytest.mark.parametrize("k", range(side.NUM_CANDIDATES))
@pytest.mark.parametrize("case", side.VMAP_CASES)
def test_candidate_lane_matches_jax(jax_results, vmapped, case, k):
    _check_result(jax_results, f"vmap/{case}/{k}", vmapped[case][1][k], loose=("perUser",))


@pytest.mark.parametrize("name", list(side.PATH_CASES))
def test_path_lane_matches_jax(jax_results, paths, name):
    results = paths[name]
    assert len(results) == len(side.PATH_WEIGHTS)
    for k, (res, w) in enumerate(zip(results, side.PATH_WEIGHTS)):
        # the caller's order, whatever order the path ran in
        assert res.config.coordinates["fixed"].optimization.regularization_weight == w
        _check_result(jax_results, f"path/{name}/{k}", res, loose=("perUserMF",))


def test_candidate_lane_matches_isolated_fits(data, vmapped):
    """Each candidate of the lockstep lane lands where its own fit does."""
    train, val = data[False]
    configs = side.candidate_dicts("l2", side.vmap_weights())
    for d, res in zip(configs, vmapped["l2"][1]):
        iso = GameEstimator(_cfg(d), **F64).fit(train, val, ["AUC"])
        assert _rel(res.objective_history, iso.objective_history) <= REL
        assert _rel(res.validation["AUC"], iso.validation["AUC"]) <= REL
        for name, t in iso.descent.trackers.items():
            got = res.descent.trackers[name].iterations
            assert abs(got - t.iterations) <= 0.01 * t.iterations, name


@pytest.mark.parametrize("case", side.VMAP_CASES)
def test_candidate_lane_visits_on_the_cpu(vmapped, case):
    """One record per (outer iteration, coordinate); on the CPU no kernel
    launches, and every value+gradient round of a lockstep visit is
    counted, with the host's read-backs."""
    sweep, results = vmapped[case]
    seq = sweep.config.updating_sequence
    assert [(v.iteration, v.coordinate) for v in sweep.visits] == \
        [(it, name) for it in range(side.SWEEP_OUTER) for name in seq]
    for v in sweep.visits:
        assert v.lanes_launches == 0 and v.rounds >= 1 and v.readbacks >= 1
        assert (v.hv_rounds is not None) == (case == "tron")
        if v.coordinate == "perUser":
            assert v.buckets and sum(b[1] for b in v.buckets) == v.rounds
            assert all(b[0][0] % side.NUM_CANDIDATES == 0 for b in v.buckets)
    # every candidate's passes are at most the rounds of its visits
    for res in results:
        for key, t in res.descent.trackers.items():
            it, name = key.split("/")
            visit = next(v for v in sweep.visits
                         if v.iteration == int(it) and v.coordinate == name)
            if name == "fixed":
                assert (t.hv_count or t.fg_count) <= max(visit.rounds, visit.hv_rounds or 0)


@pytest.mark.parametrize("case", side.ELIGIBILITY_CASES)
def test_vmap_eligible_refusals_match_jax(jax_results, data, case):
    sweep = _sweep(data, case)
    ok, why = sweep.vmap_eligible()
    assert [ok, why] == json.loads(str(jax_results[f"eligible/{case}"]))
    with pytest.raises(ValueError, match="vmap lane ineligible: " + why):
        sweep.evaluate_vmapped([_cfg(side.sweep_config_dict(case))] * 2)


def test_evaluate_routes_to_a_lane(data, vmapped, paths):
    """evaluate(): the candidate lane for K > 1 cold candidates, the path
    lane for one, for a warm start and for an ineligible sweep."""
    sweep = _sweep(data, "l2")
    configs = [_cfg(d) for d in side.candidate_dicts("l2", side.vmap_weights())]
    got = sweep.evaluate(configs)
    assert [r.objective_history for r in got] == \
        [r.objective_history for r in vmapped["l2"][1]]
    assert len(sweep.visits) == 2 * side.SWEEP_OUTER
    sweep.visits = []
    one = sweep.evaluate(configs[:1])
    assert not sweep.visits and len(one[0].descent.objective_history) == 4
    warm = sweep.evaluate(configs[:2], initial_model=one[0].model)
    assert not sweep.visits and len(warm) == 2


def test_compatible_refuses_structural_change(jax_results, data):
    sweep = _sweep(data, "l2")
    changed = json.loads(json.dumps(side.sweep_config_dict("l2")))
    changed["coordinates"]["fixed"]["optimization"]["optimizer"]["max_iterations"] = 7
    assert sweep.compatible(_cfg(side.candidate_dicts("l2", [3.0])[0])) == \
        bool(jax_results["compatible/weights"]) is True
    assert sweep.compatible(_cfg(changed)) == bool(jax_results["compatible/structural"]) \
        is False
    with pytest.raises(ValueError) as e:
        sweep.evaluate_config(_cfg(changed))
    assert str(e.value) == str(jax_results["compatible/error"])


def test_gaussian_process_search_over_game_fits_matches_jax(jax_results, data):
    train, val = data[False]
    fn = GameEstimatorEvaluationFunction(
        GameEstimator(_cfg(side.sweep_config_dict("l2")), **F64), train, val, ["AUC"])
    search = GaussianProcessSearch(side.GP_RANGES, fn, AUC, seed=side.GP_SEED)
    found = search.find(side.GP_ITERATIONS)
    got = np.stack([fn.vectorize_params(r) for r in found])
    want = jax_results["gp/candidates"]
    # the uniform draws are bit-equal; the GP's choices follow values that
    # agree to rounding
    n_uniform = len(side.GP_RANGES) + 1
    np.testing.assert_array_equal(got[:n_uniform], want[:n_uniform])
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL)
    assert _rel([fn.get_evaluation_value(r) for r in found], jax_results["gp/values"]) <= REL
    assert search.last_model is not None


def test_per_lane_elastic_net_matches_vmapped_solve(jax_results):
    """Lanes with their own lambda and mix in one OWLQN batch: each lane's
    orthant projection and pseudo-gradient use its own L1 weight."""
    x, y = side.mix_problem()
    en = RegularizationContext(RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5)
    rws = [RegWeights.from_context(en, w, elastic_net_alpha=a, dtype=torch.float64)
           for w, a in side.MIX_LANES]
    l1 = torch.stack([r.l1_weight for r in rws])
    l2 = torch.stack([r.l2_weight for r in rws])
    K = len(rws)
    oracle = FixedEffectLanes(LOGISTIC, torch.from_numpy(x), torch.from_numpy(y),
                              torch.zeros((K, len(y)), dtype=torch.float64), l2)
    res = batched.solve(oracle.value_and_gradient, torch.zeros((K, 8), dtype=torch.float64),
                        OptimizerConfig(), en, RegWeights(l1, l2))
    np.testing.assert_array_equal(res.iterations.numpy(), jax_results["mix/iterations"])
    np.testing.assert_array_equal(res.reason.numpy(), jax_results["mix/reason"])
    np.testing.assert_allclose(res.value.numpy(), jax_results["mix/value"], rtol=REL)
    np.testing.assert_allclose(res.x.numpy(), jax_results["mix/x"], rtol=1e-8, atol=1e-10)
