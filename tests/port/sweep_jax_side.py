"""The JAX side of the hyperparameter-sweep parity tests
(test_torch_sweep.py), run in a subprocess of its own:

    python tests/port/sweep_jax_side.py sweep OUT.npz

It runs the JAX package's SweepEvaluator (candidate lane, path lane,
eligibility and compatibility refusals; one candidate lane traced for
test_torch_telemetry.py), a GaussianProcessSearch over its
GameEstimatorEvaluationFunction, and jax.vmap of one solve over per-lane
RegWeights, on the CPU in float64, and writes the results to OUT.npz.
The vmapped GAME programs compile in this process, never in the test
process, where XLA state builds up toward the JAX suite's crash.  The
problem functions are numpy only, so the test imports them to make the
same inputs for the port.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

# a GLMix problem: a fixed effect on "global" (d = 6, intercept last) and a
# per-user random effect (40 users) on a 3-wide shard, row weights and base
# offsets, logistic labels (with a per-item effect the model leaves out);
# 900 rows split 80/20
SWEEP_ROWS, SWEEP_USERS, SWEEP_ITEMS, SWEEP_SEED = 900, 40, 25, 19
SWEEP_OUTER = 2
NUM_CANDIDATES = 5
# candidate-lane cases: name -> (how the base config differs, sparse FE)
VMAP_CASES = ("l2", "elastic_net", "tron", "normalized", "projection", "sparse")
# path-lane cases: name -> (config case, warm start)
PATH_CASES = {"l2_warm": ("l2", True), "l2_cold": ("l2", False),
              "factored_warm": ("factored", True)}
PATH_WEIGHTS = (1.0, 10.0, 0.1)          # the caller's order, not the path's
ELIGIBILITY_CASES = ("streamed", "downsampled", "factored")
# per-lane RegWeights of one elastic-net solve: (lambda, alpha) per lane
MIX_LANES = ((1.0, 0.5), (0.1, 0.9), (3.0, 0.1), (1.0, 0.0))
GP_RANGES, GP_SEED, GP_ITERATIONS = ((-2.0, 2.0),) * 2, 3, 5


def sweep_data(build_game_dataset, sparse: bool = False):
    """(train, validation) of the sweep problem in float64; pass either
    package's build_game_dataset.  `sparse` stores the global shard as
    scipy CSR (the fixed effect then trains on a PaddedSparse)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(SWEEP_SEED)
    n = SWEEP_ROWS
    xg = rng.normal(size=(n, 6))
    xg[:, 2] = np.where(rng.uniform(size=n) < 0.7, 0.0, xg[:, 2])
    xg[:, -1] = 1.0
    xu = rng.normal(size=(n, 3))
    xi = rng.normal(size=(n, 3))
    users = rng.integers(0, SWEEP_USERS, size=n)
    items = rng.integers(0, SWEEP_ITEMS, size=n)
    z = (xg @ rng.normal(size=6)
         + np.einsum("nd,nd->n", xu, rng.normal(size=(SWEEP_USERS, 3))[users])
         + 0.5 * np.einsum("nd,nd->n", xi, rng.normal(size=(SWEEP_ITEMS, 3))[items]))
    offsets = 0.1 * rng.normal(size=n)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(z + offsets)))).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=n)
    shards = {"global": sp.csr_matrix(xg) if sparse else xg,
              "per_user": xu, "per_item": xi}
    ds = build_game_dataset(y, shards, offsets=offsets, weights=weights,
                            entity_ids={"userId": users, "itemId": items})
    rows = np.arange(n)
    cut = int(0.8 * n)
    return ds.subset(rows[:cut]), ds.subset(rows[cut:])


def _opt(reg="l2", alpha=None, weight=1.0, optimizer="lbfgs", max_iterations=100,
         tolerance=None) -> dict:
    return {"optimizer": {"optimizer": optimizer, "max_iterations": max_iterations,
                          "tolerance": tolerance, "history": 10,
                          "max_cg_iterations": 20, "box_lower": None,
                          "box_upper": None, "constraints": None,
                          "track_coefficients": False},
            "regularization": {"type": reg, "alpha": alpha},
            "regularization_weight": weight, "downsampling_rate": None}


def sweep_config_dict(case: str) -> dict:
    """The base config of a case as GameTrainingConfig JSON: a fixed effect
    on "global" and a per-user random effect (LBFGS(100), L2 lambda 1, two
    outer iterations), varied per case:
      "elastic_net": both coordinates under elastic net (OWLQN), the mixes
                     0.5 and 0.3; "tron": TRON (15 iterations, tolerance
                     1e-5) everywhere; "normalized": the fixed effect
                     standardized; "projection": perUser on the
                     random_projection:2 projector; "sparse": as "l2" (the
                     dataset's global shard is CSR); "factored": the fixed
                     effect and a factored per-user coordinate (latent 2);
      "streamed"/"downsampled": the fixed effect streamed in 256-row chunks
                     / down-sampled at 0.5."""
    fe = {"kind": "fixed_effect", "feature_shard": "global",
          "normalization": "none", "shard_features": None, "memory_mode": None,
          "chunk_rows": None, "solver_schedule": None, "optimization": _opt()}
    user = {"kind": "random_effect", "random_effect_type": "userId",
            "feature_shard": "per_user", "active_data_upper_bound": 64,
            "passive_data_lower_bound": None, "features_to_samples_ratio": None,
            "projector": "index_map", "solver_schedule": None, "optimization": _opt()}
    coords = {"fixed": fe, "perUser": user}
    seq = ["fixed", "perUser"]
    if case == "elastic_net":
        for c, a in zip((fe, user), (0.5, 0.3)):
            c["optimization"] = _opt("elastic_net", a)
    elif case == "tron":
        for c in (fe, user):
            c["optimization"] = _opt(optimizer="tron", max_iterations=None)
    elif case == "normalized":
        fe["normalization"] = "standardization"
    elif case == "projection":
        user["projector"] = "random_projection:2"
    elif case == "factored":
        opt = _opt(max_iterations=50)
        coords = {"fixed": fe, "perUserMF": {
            "kind": "factored_random_effect", "random_effect_type": "userId",
            "feature_shard": "per_user", "latent_dim": 2, "num_inner_iterations": 1,
            "active_data_upper_bound": 64, "passive_data_lower_bound": None,
            "solver_schedule": None, "optimization": opt,
            "latent_optimization": dict(opt, regularization_weight=0.5)}}
        seq = ["fixed", "perUserMF"]
    elif case == "streamed":
        fe.update(memory_mode="streamed", chunk_rows=256)
    elif case == "downsampled":
        fe["optimization"] = dict(fe["optimization"], downsampling_rate=0.5)
    elif case not in ("l2", "sparse"):
        raise ValueError(case)
    return {"task_type": "logistic_regression", "coordinates": coords,
            "updating_sequence": seq, "num_outer_iterations": SWEEP_OUTER,
            "seed": SWEEP_SEED, "hbm_budget_bytes": None, "solver_schedule": None}


def candidate_dicts(case: str, fe_weights) -> list:
    """One config per fixed-effect weight: the random effects (and a
    factored coordinate's latent problem) at twice it."""
    out = []
    for w in fe_weights:
        d = json.loads(json.dumps(sweep_config_dict(case)))
        for name, c in d["coordinates"].items():
            c["optimization"]["regularization_weight"] = w if name == "fixed" else 2 * w
            if "latent_optimization" in c:
                c["latent_optimization"]["regularization_weight"] = 2 * w
        out.append(d)
    return out


def vmap_weights():
    return np.logspace(1.0, -1.0, NUM_CANDIDATES)


def mix_problem(seed: int = 4):
    """A [300 x 8] logistic problem with an intercept column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 8))
    x[:, -1] = 1.0
    y = (rng.uniform(size=300) < 1.0 / (1.0 + np.exp(-x @ rng.normal(size=8)))).astype(
        np.float64)
    return x, y


def store_result(out: dict, key: str, res) -> None:
    """A GameResult's histories, trackers and validation under key/..."""
    out[f"{key}/objective_history"] = np.asarray(res.objective_history)
    out[f"{key}/auc"] = np.asarray(res.validation["AUC"])
    for k, t in res.descent.trackers.items():
        out[f"{key}/iterations/{k}"] = np.asarray(t.iterations)
        out[f"{key}/reasons/{k}"] = np.asarray(json.dumps(t.reasons, sort_keys=True))


def _run_sweep(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.evaluation.evaluators import AUC
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.hyperparameter import (GameEstimatorEvaluationFunction,
                                              GaussianProcessSearch, SweepEvaluator)
    from photon_ml_tpu.ops import TASK_LOSSES, GLMObjective
    from photon_ml_tpu.optim import (OptimizerConfig, RegularizationContext,
                                     RegularizationType, RegWeights, solve)
    cfg = lambda d: GameTrainingConfig.from_dict(d)
    data = {False: sweep_data(build_game_dataset),
            True: sweep_data(build_game_dataset, sparse=True)}

    for case in VMAP_CASES:
        train, val = data[case == "sparse"]
        sweep = SweepEvaluator(GameEstimator(cfg(sweep_config_dict(case))), train, val,
                               ["AUC"])
        results = sweep.evaluate_vmapped(
            [cfg(d) for d in candidate_dicts(case, vmap_weights())])
        for k, res in enumerate(results):
            store_result(out, f"vmap/{case}/{k}", res)
    # the telemetry parity test's sweep: an "l2" candidate lane again under
    # an armed tracer (its programs are compiled by now)
    import telemetry_jax_side as tj
    out[tj.SWEEP_KEY] = np.asarray(tj.traced_record("sweep", None))

    for name, (case, warm) in PATH_CASES.items():
        train, val = data[False]
        sweep = SweepEvaluator(GameEstimator(cfg(sweep_config_dict(case))), train, val,
                               ["AUC"])
        results = sweep.evaluate_path([cfg(d) for d in candidate_dicts(case, PATH_WEIGHTS)],
                                      warm_start=warm)
        for k, res in enumerate(results):
            store_result(out, f"path/{name}/{k}", res)

    train, val = data[False]
    for case in ELIGIBILITY_CASES:
        sweep = SweepEvaluator(GameEstimator(cfg(sweep_config_dict(case))), train, val,
                               ["AUC"])
        ok, why = sweep.vmap_eligible()
        out[f"eligible/{case}"] = np.asarray(json.dumps([ok, why]))
    base = cfg(sweep_config_dict("l2"))
    sweep = SweepEvaluator(GameEstimator(base), train, val, ["AUC"])
    changed = json.loads(json.dumps(sweep_config_dict("l2")))
    changed["coordinates"]["fixed"]["optimization"]["optimizer"]["max_iterations"] = 7
    out["compatible/weights"] = np.asarray(sweep.compatible(cfg(candidate_dicts("l2", [3.0])[0])))
    out["compatible/structural"] = np.asarray(sweep.compatible(cfg(changed)))
    try:
        sweep.evaluate_config(cfg(changed))
        out["compatible/error"] = np.asarray("")
    except ValueError as e:
        out["compatible/error"] = np.asarray(str(e))

    fn = GameEstimatorEvaluationFunction(GameEstimator(base), train, val, ["AUC"])
    search = GaussianProcessSearch(GP_RANGES, fn, AUC, seed=GP_SEED)
    found = search.find(GP_ITERATIONS)
    out["gp/candidates"] = np.stack([fn.vectorize_params(r) for r in found])
    out["gp/values"] = np.asarray([fn.get_evaluation_value(r) for r in found])

    x, y = mix_problem()
    en = RegularizationContext(RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5)
    obj = GLMObjective(TASK_LOSSES["logistic_regression"], jnp.asarray(x), jnp.asarray(y))
    rws = [RegWeights.from_context(en, w, elastic_net_alpha=a) for w, a in MIX_LANES]
    stacked = RegWeights(jnp.stack([r.l1_weight for r in rws]),
                         jnp.stack([r.l2_weight for r in rws]))
    res = jax.vmap(lambda rw: solve(obj, jnp.zeros(8), OptimizerConfig(), en, rw))(stacked)
    for key in ("x", "value", "iterations", "reason"):
        out[f"mix/{key}"] = np.asarray(getattr(res, key))


def run_jax_side(what: str, out: Path) -> dict:
    """Run this script for `what` in a fresh process; its results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), what,
                           str(out)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# the sweep mode's results, shared by the two test modules that read them
# (one subprocess per test process)
_SWEEP_RESULTS: dict = {}


def sweep_results(out: Path) -> dict:
    if not _SWEEP_RESULTS:
        _SWEEP_RESULTS.update(run_jax_side("sweep", out))
    return _SWEEP_RESULTS


def main(argv) -> int:
    what, path = argv[1], argv[2]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out: dict = {}
    {"sweep": _run_sweep}[what](out)
    np.savez(path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
