"""The JAX side of the TRON, GLMix, sparse-training, factored, sampler,
model-persistence and command-line parity tests, run in a subprocess of
its own.

    python tests/port/game_jax_side.py \
        tron|solver|estimator|sparse|factored|samplers|prng|model_io|cli|containment|stream|bf16|
        bcoo|bf16x OUT.npz

The parity tests (test_torch_tron.py, test_torch_game_solver.py,
test_torch_game_estimator.py, test_torch_sparse_training.py,
test_torch_factored.py, test_torch_samplers.py, test_torch_prng.py,
test_torch_model_io.py, test_torch_cli.py, test_torch_containment.py,
test_torch_bf16.py, test_torch_bcoo.py; `bf16x`, shared by
test_torch_streaming.py and test_torch_lanes.py through `shared_results`)
start this once per test module, with JAX on the CPU in float64, and read
its results from OUT.npz (model_io, cli and containment also read and
write model directories, checkpoints and CLI outputs beside OUT.npz).  Compiling the JAX package's TRON, batched solver, GAME and
sparse training programs in a process of their own keeps their XLA compile
state out of the test process.  The problem
functions below are numpy only, so the tests import them to make the same
inputs for the port.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

# batched-solver problem: [E, S, d] with ragged lanes
SOLVER_E, SOLVER_S, SOLVER_D = 24, 16, 5
# TRON's gradient test at 1e-6 ends every lane while its steps still
# reduce f by more than float64 rounding: near the optimum ρ is rounding
# noise, and two summation orders would accept different steps
_TRON = {"optimizer": "tron", "tolerance": 1e-6}
_BOX = {"box_lower": (-0.3,) * SOLVER_D, "box_upper": (0.3,) * SOLVER_D}
SOLVER_CASES = {
    # name -> (loss, regularization, alpha, lambda, warm start, the
    # OptimizerConfig fields that differ from SOLVER_MAX_ITERATIONS and
    # SOLVER_TOLERANCE)
    "logistic_l2": ("logistic", "l2", None, 1.0, False, {}),
    "logistic_elastic_net": ("logistic", "elastic_net", 0.5, 3.0, False, {}),
    "squared_l2_warm": ("squared", "l2", None, 0.5, True, {}),
    "poisson_elastic_net_warm": ("poisson", "elastic_net", 0.3, 1.0, True, {}),
    "logistic_l2_tron": ("logistic", "l2", None, 1.0, False, _TRON),
    "poisson_l2_tron_warm": ("poisson", "l2", None, 0.5, True, _TRON),
    "squared_none_tron": ("squared", "none", None, 0.0, False, _TRON),
    "squared_l2_tron_warm": ("squared", "l2", None, 2.0, True, _TRON),
    "logistic_l2_tron_cg2": ("logistic", "l2", None, 0.3, False,
                             dict(_TRON, max_cg_iterations=2)),
    "logistic_l2_box": ("logistic", "l2", None, 0.2, False, _BOX),
    "poisson_l2_box_warm": ("poisson", "l2", None, 1.0, True, _BOX),
    "squared_l2_box": ("squared", "l2", None, 0.5, False, _BOX),
    "poisson_none_box": ("poisson", "none", None, 0.0, False, _BOX),
}
SOLVER_MAX_ITERATIONS, SOLVER_TOLERANCE = 60, 1e-8

# single TRON solves: [N, D] problems per loss, plain ("plain"); with
# weights, offsets and standardization ("wos"); with weights, offsets and
# a row mask whose padded rows carry huge offsets ("wom"); scaled by the
# columns' standard deviations, no shift ("scale"); and plain with at most
# 2 CG steps per outer step ("cg2").  train_glm with TRON on
# make_a1a_like(2, task, seed=42), a warm-started sweep, raw and
# standardized
TRON_N, TRON_D, TRON_L2 = 400, 12, 0.5
TRON_CASES = [f"{loss}_{variant}" for loss in ("logistic", "squared", "poisson")
              for variant in ("plain", "wos", "wom", "scale", "cg2")]
TRON_MAX_ITERATIONS, TRON_TOLERANCE = 15, 1e-8
TRON_NORMS = {"wos": "standardization", "scale": "scale_with_standard_deviation"}
TRAIN_TASKS = {"logistic_regression": "logistic", "poisson_regression": "poisson"}
TRAIN_CASES = [(task, norm) for task in TRAIN_TASKS for norm in ("raw", "standardization")]
TRAIN_LAMBDAS = (1.0, 10.0)

# estimator: BASELINE config 4's shape, cut to a few thousand rows
ESTIMATOR_ROWS, ESTIMATOR_SEED, ESTIMATOR_OUTER = 3000, 11, 2

# sparse: train_glm on a wide sparse logistic problem (bench config 6's
# generator, cut to [3,000 x 20,000] with 16 nonzeros per row), and a
# Yahoo-shaped GAME fit (bench config 7's, cut to 3,000 rows, 2,000 global
# columns, 50 users and 80 items) with a sparse fixed effect
SPARSE_N, SPARSE_D, SPARSE_NNZ, SPARSE_SEED = 3000, 20_000, 16, 5
SPARSE_LBFGS = {"max_iterations": 100, "tolerance": 1e-9}
# case -> (optimizer options, lambdas, normalization, column view, variances)
SPARSE_CASES = {
    "lbfgs": (SPARSE_LBFGS, (1.0, 10.0), None, False, True),
    "lbfgs_csc": (SPARSE_LBFGS, (1.0,), None, True, True),
    "lbfgs_standardization": (SPARSE_LBFGS, (1.0,), "standardization", True, False),
    "tron": ({"optimizer": "tron"}, (1.0,), None, False, True),
}
YAHOO_ROWS, YAHOO_D, YAHOO_USERS, YAHOO_ITEMS, YAHOO_SEED = 3000, 2000, 50, 80, 23

# bf16 feature storage: train_glm on a small a1a-shaped dense X and a small
# bench-config-6-shaped sparse X (values 1.0, as config 6's), features
# stored bf16, labels float64; OWLQN is LBFGS under L1
BF16_ROWS = 1200
BF16_SPARSE = dict(n=1500, d=3000, nnz=8, seed=6)
BF16_CASES = {
    # name -> (optimizer, regularization, lambda, tolerance); TRON's at
    # 1e-6, where its steps still reduce f by more than float64 rounding
    # (as _TRON above)
    "lbfgs": ("lbfgs", "l2", 1.0, 1e-9),
    "owlqn": ("lbfgs", "l1", 0.5, 1e-9),
    "tron": ("tron", "l2", 1.0, 1e-6),
}
BF16_MAX_ITERATIONS = 100

# sparse COO/CSR tensors, the port's counterpart of a BCOO: train_glm on a
# BCOO with duplicate entries and an empty row, LBFGS and TRON, L2; TRON's
# tolerance 1e-6, where its steps still reduce f by more than float64
# rounding (as BF16_CASES)
BCOO_N, BCOO_D, BCOO_SEED, BCOO_DUPLICATES = 300, 12, 8, 20
BCOO_CASES = {"lbfgs": ("lbfgs", 100, 1e-9), "tron": ("tron", 30, 1e-6)}

# a bf16 X on the streamed chunk (chunks of BF16X_CHUNK rows, a padded
# tail) and on the bootstrap's replica lanes
BF16X_N, BF16X_D, BF16X_CHUNK, BF16X_SEED = 300, 7, 128, 12
BF16X_EPOCHS, BF16X_PASS_SEED = 2, 3
BOOT_N, BOOT_D, BOOT_K, BOOT_SEED = 400, 6, 4, 3
BOOT_OPTIONS = {"max_iterations": 50, "tolerance": 1e-6}


_SHARED: dict = {}


def start(what: str, out: Path):
    """Start this script for `what` into `out` in a process of its own."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), what, str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def shared_results(what: str, tmp_path_factory) -> dict:
    """`what`'s results, run once per test process (the first caller
    starts the process and waits for it; later modules share them)."""
    if what not in _SHARED:
        out = tmp_path_factory.mktemp("jax") / f"{what}.npz"
        proc = start(what, out)
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the JAX side failed:\n{err[-4000:]}")
        with np.load(out) as z:
            _SHARED[what] = {k: z[k] for k in z.files}
    return _SHARED[what]


def solver_problem(case: str, seed: int = 5) -> dict:
    """Padded blocks like the data layer's: per-lane real-row counts 0
    (all-masked lanes), 1, and ragged up to S; padding cells carry x 0,
    label 0.5, weight 0 and offset 0.  Weights and offsets on every lane."""
    loss, _, _, _, warm, _ = SOLVER_CASES[case]
    rng = np.random.default_rng(seed)
    E, S, d = SOLVER_E, SOLVER_S, SOLVER_D
    counts = rng.integers(2, S + 1, size=E)
    counts[[0, 5]] = 0
    counts[[1, 7, 11]] = 1
    counts[2] = S
    mask = (np.arange(S)[None, :] < counts[:, None]).astype(np.float64)
    x = rng.normal(size=(E, S, d))
    x[:, :, -1] = 1.0
    x *= mask[:, :, None]
    w_true = rng.normal(size=(E, d))
    z = np.einsum("esd,ed->es", x, w_true)
    if loss == "logistic":
        y = (rng.uniform(size=(E, S)) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif loss == "squared":
        y = z + rng.normal(size=(E, S))
    else:
        y = rng.poisson(np.exp(0.3 * z)).astype(np.float64)
    labels = np.where(mask > 0, y, 0.5)
    weights = rng.uniform(0.5, 2.0, size=(E, S)) * mask
    offsets = rng.normal(size=(E, S)) * 0.3 * mask
    x0 = (rng.normal(size=(E, d)) * 0.2 if warm else np.zeros((E, d)))
    return dict(x=x, labels=labels, mask=mask, weights=weights,
                offsets=offsets, x0=x0)


def tron_problem(case: str, seed: int = 3) -> dict:
    """x [N, D] (intercept last), labels from a planted GLM; "wos" adds
    weights, offsets and the columns' mean and variance for
    standardization."""
    loss, variant = case.split("_")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRON_N, TRON_D))
    x[:, -1] = 1.0
    z = x @ (rng.normal(size=TRON_D) * (0.3 if loss == "poisson" else 1.0))
    if loss == "logistic":
        y = (rng.uniform(size=TRON_N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif loss == "squared":
        y = z + rng.normal(size=TRON_N)
    else:
        y = rng.poisson(np.exp(z)).astype(np.float64)
    p = dict(x=x, labels=y)
    if variant in ("wos", "wom"):
        p.update(weights=rng.uniform(0.5, 2.0, size=TRON_N),
                 offsets=rng.normal(size=TRON_N) * 0.2)
    if variant in TRON_NORMS:
        p.update(mean=x.mean(axis=0), variance=x.var(axis=0))
    if variant == "wom":
        p["mask"] = (rng.uniform(size=TRON_N) < 0.8).astype(np.float64)
        p["offsets"] = np.where(p["mask"] > 0, p["offsets"], 1e6)
    return p


def tron_solve_options(case: str) -> dict:
    """The TRON options of a single-solve case beyond the shared ones."""
    return {"max_cg_iterations": 2} if case.endswith("_cg2") else {}


def movielens_glmix(build_game_dataset, make_movielens_like, movielens_shards,
                    n_rows: int = ESTIMATOR_ROWS):
    """(train, validation) of config 4's shape at `n_rows` rows in float64,
    split 95/5 as bench.py's _game_setup splits them; pass either package's
    builders."""
    ml = make_movielens_like("1m", seed=ESTIMATOR_SEED, n_rows=n_rows)
    shards = {k: v.astype(np.float64) for k, v in movielens_shards(ml).items()
              if k != "per_item"}
    ds = build_game_dataset(ml.response.astype(np.float64), shards,
                            entity_ids={"userId": ml.user_ids})
    rng = np.random.default_rng(ESTIMATOR_SEED + 99)
    val_mask = rng.uniform(size=ds.num_rows) < 0.05
    return ds.subset(np.flatnonzero(~val_mask)), ds.subset(np.flatnonzero(val_mask))


def glmix_config_dict() -> dict:
    """Config 4's coordinates as GameTrainingConfig JSON: a fixed effect on
    "global" and a per-user random effect on "per_user" (cap 512), both
    LBFGS(100) with L2 lambda 1, two outer iterations."""
    opt = {"optimizer": {"optimizer": "lbfgs", "max_iterations": 100,
                         "tolerance": None, "history": 10,
                         "max_cg_iterations": 20, "box_lower": None,
                         "box_upper": None, "constraints": None,
                         "track_coefficients": False},
           "regularization": {"type": "l2", "alpha": None},
           "regularization_weight": 1.0, "downsampling_rate": None}
    return {"task_type": "logistic_regression",
            "coordinates": {
                "fixed": {"kind": "fixed_effect", "feature_shard": "global",
                          "normalization": "none", "shard_features": None,
                          "memory_mode": None, "chunk_rows": None,
                          "solver_schedule": None, "optimization": opt},
                "perUser": {"kind": "random_effect",
                            "random_effect_type": "userId",
                            "feature_shard": "per_user",
                            "active_data_upper_bound": 512,
                            "passive_data_lower_bound": None,
                            "features_to_samples_ratio": None,
                            "projector": "index_map", "solver_schedule": None,
                            "optimization": opt}},
            "updating_sequence": ["fixed", "perUser"],
            "num_outer_iterations": ESTIMATOR_OUTER, "seed": ESTIMATOR_SEED,
            "hbm_budget_bytes": None, "solver_schedule": None}


def variant_config_dict() -> dict:
    """Config 4 with the other ported paths turned on: a standardized fixed
    effect, and a random effect under elastic net (OWLQN) whose cap of 2
    rows bites (passive rows above, discarded rows at or below the lower
    bound of 1) with Pearson feature selection."""
    d = glmix_config_dict()
    d["coordinates"]["fixed"]["normalization"] = "standardization"
    re = d["coordinates"]["perUser"]
    re.update(active_data_upper_bound=2, passive_data_lower_bound=1,
              features_to_samples_ratio=0.5)
    re["optimization"] = dict(re["optimization"],
                              regularization={"type": "elastic_net", "alpha": 0.5},
                              regularization_weight=2.0)
    return d


def tron_config_dict() -> dict:
    """Config 4 with TRON on both coordinates, at its defaults (15
    iterations, tolerance 1e-5)."""
    d = glmix_config_dict()
    for coord in d["coordinates"].values():
        coord["optimization"] = dict(coord["optimization"], optimizer=dict(
            coord["optimization"]["optimizer"], optimizer="tron", max_iterations=None))
    return d


def tracked_config_dict() -> dict:
    """Config 4 with coefficient tracking on both coordinates (the
    random effect's batched solves record every lane's iterates)."""
    d = glmix_config_dict()
    for coord in d["coordinates"].values():
        coord["optimization"] = dict(coord["optimization"], optimizer=dict(
            coord["optimization"]["optimizer"], track_coefficients=True))
    return d


def sparse_problem(make_wide_sparse_logistic):
    """(x CSR, y) of the sparse train_glm cases in float64; pass either
    package's generator."""
    x, y = make_wide_sparse_logistic(SPARSE_N, d=SPARSE_D, nnz=SPARSE_NNZ,
                                     seed=SPARSE_SEED)
    return x.astype(np.float64), y.astype(np.float64)


def bf16_problem(kind: str, make_a1a_like, make_wide_sparse_logistic):
    """(x, y) of the bf16 train_glm cases in float64, every feature exact
    in bf16: "dense" the first BF16_ROWS rows of make_a1a_like(1) (0/1
    features), "sparse" a CSR from make_wide_sparse_logistic; pass either
    package's generators."""
    if kind == "dense":
        x, y = make_a1a_like(1, seed=42)
        x, y = x[:BF16_ROWS], y[:BF16_ROWS]
    else:
        x, y = make_wide_sparse_logistic(**BF16_SPARSE)
    return x.astype(np.float64), y.astype(np.float64)


def bcoo_problem(seed: int = BCOO_SEED):
    """(data [nnz], indices [nnz, 2], y) of a [BCOO_N, BCOO_D] sparse matrix
    in float64: ~30 % nonzeros, an intercept column, row 5 empty, and
    BCOO_DUPLICATES more entries at (row, column) pairs already stored,
    with values of their own (a BCOO sums them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BCOO_N, BCOO_D)) * (rng.uniform(size=(BCOO_N, BCOO_D)) < 0.3)
    x[:, 0] = 1.0
    x[5] = 0.0
    r, c = np.nonzero(x)
    data = x[r, c]
    pick = rng.choice(len(r), BCOO_DUPLICATES, replace=False)
    r, c = np.concatenate([r, r[pick]]), np.concatenate([c, c[pick]])
    data = np.concatenate([data, rng.normal(size=BCOO_DUPLICATES)])
    summed = np.zeros_like(x)
    np.add.at(summed, (r, c), data)
    beta = rng.normal(size=BCOO_D)
    y = (rng.uniform(size=BCOO_N) < 1.0 / (1.0 + np.exp(-summed @ beta))).astype(np.float64)
    return data, np.stack([r, c], axis=1), y


def bf16x_problem(seed: int = BF16X_SEED) -> dict:
    """The streamed bf16 chunk's inputs in float64 (each side rounds x to
    bf16, round to nearest even, so both hold the same bits): x, labels,
    weights, offsets, a coefficient vector and a direction."""
    rng = np.random.default_rng(seed)
    n, d = BF16X_N, BF16X_D
    return dict(x=rng.normal(size=(n, d)), y=(rng.uniform(size=n) < 0.4).astype(np.float64),
                w=rng.uniform(0.5, 2.0, size=n), o=rng.normal(size=n) * 0.1,
                c=rng.normal(size=d) * 0.3, v=rng.normal(size=d))


def bootstrap_problem(seed: int = BOOT_SEED):
    """(x, y) of the bf16 bootstrap in float64 (x rounded to bf16 by each
    side): an intercept column and logistic labels."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BOOT_N, BOOT_D))
    x[:, 0] = 1.0
    beta = rng.normal(size=BOOT_D)
    y = (rng.uniform(size=BOOT_N) < 1.0 / (1.0 + np.exp(-x @ beta))).astype(np.float64)
    return x, y


def yahoo_glmix(build_game_dataset, make_yahoo_like):
    """(train, validation) of bench config 7's shape at YAHOO_ROWS rows in
    float64, split 95/5 as bench.py's _yahoo_setup splits them; pass either
    package's builders."""
    yl = make_yahoo_like(YAHOO_ROWS, d_global=YAHOO_D, num_users=YAHOO_USERS,
                         num_items=YAHOO_ITEMS, seed=YAHOO_SEED)
    shards = {"global": yl.x_global.astype(np.float64),
              "per_user": yl.x_user.astype(np.float64),
              "per_item": yl.x_item.astype(np.float64)}
    ds = build_game_dataset(yl.response.astype(np.float64), shards,
                            entity_ids={"userId": yl.user_ids, "itemId": yl.item_ids})
    rng = np.random.default_rng(YAHOO_SEED + 99)
    val_mask = rng.uniform(size=ds.num_rows) < 0.05
    return ds.subset(np.flatnonzero(~val_mask)), ds.subset(np.flatnonzero(val_mask))


def yahoo_config_dict() -> dict:
    """bench.py's _yahoo_setup config: a fixed effect on the sparse
    "global" shard, per-user and per-item random effects (cap 512), all
    LBFGS(100) with L2 lambda 1, two outer iterations."""
    d = glmix_config_dict()
    fixed, re = d["coordinates"]["fixed"], d["coordinates"]["perUser"]
    d["coordinates"] = {
        "fixed": fixed, "perUser": re,
        "perItem": dict(re, random_effect_type="itemId", feature_shard="per_item")}
    d.update(updating_sequence=["fixed", "perUser", "perItem"], seed=YAHOO_SEED)
    return d


# factored: BASELINE config 5's shape (bench.py _game_setup, mode "full")
# cut to make_movielens_like("1m", seed=11, n_rows=3000), latent dim 3,
# cap 32, LBFGS(50) for both of the factored coordinate's problems
FACTORED_K, FACTORED_CAP, FACTORED_ITERATIONS = 3, 32, 50


def movielens_game(build_game_dataset, make_movielens_like, movielens_shards,
                   n_rows: int = ESTIMATOR_ROWS):
    """(train, validation) of config 5's shape (global, per_user and
    per_item shards; user and item ids) at `n_rows` rows in float64, split
    95/5 as bench.py's _game_setup splits them; pass either package's
    dataset functions."""
    ml = make_movielens_like("1m", seed=ESTIMATOR_SEED, n_rows=n_rows)
    shards = {k: v.astype(np.float64) for k, v in movielens_shards(ml).items()}
    ds = build_game_dataset(ml.response.astype(np.float64), shards,
                            entity_ids={"userId": ml.user_ids, "itemId": ml.item_ids})
    rng = np.random.default_rng(ESTIMATOR_SEED + 99)
    val_mask = rng.uniform(size=ds.num_rows) < 0.05
    return ds.subset(np.flatnonzero(~val_mask)), ds.subset(np.flatnonzero(val_mask))


def _factored_coordinate(inner: int = 1, latent_rate=None) -> dict:
    opt = glmix_config_dict()["coordinates"]["fixed"]["optimization"]
    opt = dict(opt, optimizer=dict(opt["optimizer"], max_iterations=FACTORED_ITERATIONS))
    return {"kind": "factored_random_effect", "random_effect_type": "userId",
            "feature_shard": "per_user", "latent_dim": FACTORED_K,
            "num_inner_iterations": inner, "active_data_upper_bound": FACTORED_CAP,
            "passive_data_lower_bound": None, "solver_schedule": None,
            "optimization": opt,
            "latent_optimization": dict(opt, downsampling_rate=latent_rate)}


def factored_config_dict(case: str) -> dict:
    """The factored parity cases as GameTrainingConfig JSON:
      "cold": the factored coordinate alone (its Gaussian projection is
              never replaced);
      "warm": config 5's full sequence, fixed + perUser + perItem +
              perUserMF (the projection comes from perUser's solution at
              the first visit);
      "sampled": fixed (down-sampled at 0.5) + perUserMF with two inner
              iterations and the latent refit down-sampled at 0.7;
      "random_projection": config 4 with the random effect on the
              random_projection:4 projector."""
    d = glmix_config_dict()
    fixed, re = d["coordinates"]["fixed"], d["coordinates"]["perUser"]
    item = dict(re, random_effect_type="itemId", feature_shard="per_item")
    if case == "cold":
        coords, seq = {"perUserMF": _factored_coordinate()}, ["perUserMF"]
    elif case == "warm":
        coords = {"fixed": fixed, "perUser": re, "perItem": item,
                  "perUserMF": _factored_coordinate()}
        seq = ["fixed", "perUser", "perItem", "perUserMF"]
    elif case == "sampled":
        fixed = dict(fixed, optimization=dict(fixed["optimization"], downsampling_rate=0.5))
        coords = {"fixed": fixed, "perUserMF": _factored_coordinate(2, 0.7)}
        seq = ["fixed", "perUserMF"]
    elif case == "random_projection":
        coords = {"fixed": fixed, "perUser": dict(re, projector="random_projection:4")}
        seq = ["fixed", "perUser"]
    else:
        raise ValueError(case)
    d.update(coordinates=coords, updating_sequence=seq)
    return d


FACTORED_CASES = ("cold", "warm", "sampled", "random_projection")


def samplers_config_dict(task: str) -> dict:
    """Config 4 with the fixed effect down-sampled at 0.5: logistic (the
    binary sampler) or poisson (the default sampler)."""
    d = glmix_config_dict()
    fixed = d["coordinates"]["fixed"]
    fixed["optimization"] = dict(fixed["optimization"], downsampling_rate=0.5)
    d["task_type"] = task
    return d


SAMPLER_TASKS = ("logistic_regression", "poisson_regression")


def kron_problem(seed: int = 4) -> dict:
    """Small inputs of the KroneckerDesign products and the factored
    helpers."""
    rng = np.random.default_rng(seed)
    n, d, k = 50, 6, 3
    E, S = 12, 8
    counts = rng.integers(0, S + 1, size=E)
    counts[0], counts[1] = S, 0
    mask = (np.arange(S)[None, :] < counts[:, None]).astype(np.float64)
    bx = rng.normal(size=(E, S, d)) * mask[:, :, None]
    bx[:, :, -1] = mask
    z = np.einsum("esd,ed->es", bx, rng.normal(size=(E, d)))
    return dict(
        x=rng.normal(size=(n, d)), factors=rng.normal(size=(n, k)),
        v=rng.normal(size=k * d), u=rng.normal(size=n),
        w=rng.normal(size=(40, d)),
        w_rank2=rng.normal(size=(40, 2)) @ rng.normal(size=(2, d)),
        block_x=bx, block_mask=mask,
        block_labels=np.where(mask > 0, (rng.uniform(size=(E, S)) < 1 / (1 + np.exp(-z))), 0.5
                              ).astype(np.float64),
        block_weights=rng.uniform(0.5, 2.0, size=(E, S)) * mask,
        block_offsets=rng.normal(size=(E, S)) * 0.3 * mask,
        latent=rng.normal(size=(E, k)) * 0.5,
        projection=rng.normal(size=(k, d)) * 0.3)


# prng: jax.random draws for test_torch_prng.py
PRNG_SEEDS = (0, 1, 7, 13, 2**31 - 1, 2**40 + 5)
PRNG_SHAPES = ((7,), (3, 5), (1001,), (2, 3, 4), (1,))
# jax.random.permutation(key, n): the stochastic lane's coordinate orders
PRNG_PERMUTATION_NS = (1, 2, 16, 48, 124, 2000)
PRNG_SPLITS = (2, 3, 5, (2, 3))
PRNG_FOLDS = (0, 1, 77, 2**32 - 1)
PRNG_NORMAL_SEEDS, PRNG_NORMAL_N = 5, 20_000


def erfinv_inputs(dtype) -> np.ndarray:
    """Edges (0, +-1, the smallest normal, the largest draws below 1) and
    50,000 uniform points of (-1, 1)."""
    fi = np.finfo(dtype)
    edge = np.array([0.0, 1.0, -1.0, fi.tiny, -fi.eps, 1 - fi.epsneg, -(1 - fi.epsneg),
                     0.5, -0.5, 0.9966, 0.99999988], dtype)
    rng = np.random.default_rng(3)
    return np.concatenate([edge, (rng.uniform(size=50_000) * 2 - 1).astype(dtype)])


# name -> JSON config of each estimator parity case
ESTIMATOR_CONFIGS = {"config4": glmix_config_dict, "variant": variant_config_dict,
                     "tron": tron_config_dict, "tracked": tracked_config_dict}
# batched-solver cases solved again with coefficient tracking: LBFGS,
# OWLQN, a box and TRON
TRACKED_SOLVER_CASES = ("logistic_l2", "logistic_elastic_net", "logistic_l2_box",
                        "logistic_l2_tron")


def _run_solver(out: dict) -> None:
    import jax.numpy as jnp
    from photon_ml_tpu.ops.losses import BY_NAME
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType)
    from photon_ml_tpu.parallel.random_effect import _cached_batched_solver
    runs = [(case, case, False) for case in SOLVER_CASES]
    runs += [(case, f"tracked/{case}", True) for case in TRACKED_SOLVER_CASES]
    for case, key, track in runs:
        loss, reg, alpha, lam, _, opt = SOLVER_CASES[case]
        p = solver_problem(case)
        opt = dict(opt)
        if "optimizer" in opt:
            opt["optimizer"] = OptimizerType(opt["optimizer"])
        solver = _cached_batched_solver(
            BY_NAME[loss],
            OptimizerConfig(**{"max_iterations": SOLVER_MAX_ITERATIONS,
                               "tolerance": SOLVER_TOLERANCE, **opt},
                            track_coefficients=track),
            RegularizationContext(RegularizationType(reg), alpha), True, True)
        res = solver(*(jnp.asarray(p[k]) for k in
                       ("x", "labels", "mask", "weights", "offsets", "x0")),
                     jnp.asarray(lam), None)
        _store(out, key, res)


def _store(out: dict, key: str, res) -> None:
    """A SolveResult's fields, those that are set, under key/field."""
    for field in ("x", "value", "iterations", "fg_count", "hv_count", "reason",
                  "loss_history", "coefficient_history"):
        if getattr(res, field) is not None:
            out[f"{key}/{field}"] = np.asarray(getattr(res, field))


def _run_tron(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from photon_ml_tpu.data.synthetic_bench import make_a1a_like
    from photon_ml_tpu.models.training import train_glm
    from photon_ml_tpu.ops.losses import BY_NAME
    from photon_ml_tpu.ops.normalization import build_normalization_context
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType)
    from photon_ml_tpu.optim.tron import tron
    for case in TRON_CASES:
        p = {k: jnp.asarray(v) for k, v in tron_problem(case).items()}
        variant = case.split("_")[1]
        norm = (None if variant not in TRON_NORMS else build_normalization_context(
            TRON_NORMS[variant], mean=p["mean"], variance=p["variance"],
            intercept_index=TRON_D - 1))
        obj = GLMObjective(BY_NAME[case.split("_")[0]], p["x"], p["labels"],
                           weights=p.get("weights"), offsets=p.get("offsets"),
                           mask=p.get("mask"), norm=norm, l2_weight=TRON_L2)
        res = jax.jit(lambda x0: tron(
            obj.value_and_gradient, obj.hessian_vector, x0,
            max_iterations=TRON_MAX_ITERATIONS, tolerance=TRON_TOLERANCE,
            **tron_solve_options(case)))(jnp.zeros(TRON_D))
        _store(out, case, res)
    for task, norm_name in TRAIN_CASES:
        x, y = make_a1a_like(2, TRAIN_TASKS[task], seed=42)
        x = x.astype(np.float64)
        norm = (None if norm_name == "raw" else build_normalization_context(
            norm_name, mean=jnp.asarray(x.mean(axis=0)),
            variance=jnp.asarray(x.var(axis=0)), intercept_index=x.shape[1] - 1))
        trained = train_glm(
            jnp.asarray(x), jnp.asarray(y, jnp.float64), task,
            optimizer_config=OptimizerConfig(optimizer=OptimizerType.TRON),
            regularization=RegularizationContext(RegularizationType.L2),
            regularization_weights=TRAIN_LAMBDAS, normalization=norm)
        for i, t in enumerate(trained):
            key = f"train/{task}/{norm_name}/{i}"
            _store(out, key, t.result)
            out[f"{key}/means"] = np.asarray(t.model.coefficients.means)


def _run_estimator(out: dict) -> None:
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.data.synthetic_bench import (make_movielens_like,
                                                    movielens_shards)
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    train, val = movielens_glmix(build_game_dataset, make_movielens_like,
                                 movielens_shards)
    for name, config_dict in ESTIMATOR_CONFIGS.items():
        cfg = GameTrainingConfig.from_dict(config_dict())
        res = GameEstimator(cfg).fit(train, val, ["AUC"], timing_mode="pipelined")
        out[f"{name}/objective_history"] = np.asarray(res.objective_history)
        out[f"{name}/auc_history"] = np.asarray(res.descent.validation_history["AUC"])
        out[f"{name}/auc"] = np.asarray(res.validation["AUC"])
        for key, t in res.descent.trackers.items():
            out[f"{name}/iterations/{key}"] = np.asarray(t.iterations)
        # the final model (the best one may be an earlier snapshot)
        fe = res.descent.model.coordinates["fixed"]
        re = res.descent.model.coordinates["perUser"]
        out[f"{name}/fixed/means"] = np.asarray(fe.glm.coefficients.means)
        out[f"{name}/perUser/coefficients"] = np.asarray(re.coefficients)
        out[f"{name}/perUser/entity_ids"] = np.asarray(re.entity_ids)
        out[f"{name}/perUser/projection"] = np.asarray(re.projection)
        out[f"{name}/perUser/global_dim"] = np.asarray(re.global_dim)
        out[f"{name}/val_scores"] = np.asarray(res.descent.model.score_dataset(val))


def _run_sparse(out: dict) -> None:
    import jax.numpy as jnp
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.data.stats import BasicStatisticalSummary
    from photon_ml_tpu.data.synthetic_bench import (make_wide_sparse_logistic,
                                                    make_yahoo_like)
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.models.training import train_glm
    from photon_ml_tpu.ops.features import PaddedSparse, as_feature_matrix
    from photon_ml_tpu.ops.normalization import build_normalization_context
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType)
    x, y = sparse_problem(make_wide_sparse_logistic)
    for case, (opt, lams, norm_name, csc, variances) in SPARSE_CASES.items():
        xs = (PaddedSparse.from_scipy(x, with_csc=True) if csc
              else as_feature_matrix(x, with_csc=True))
        assert xs.has_csc == csc
        norm = None
        if norm_name is not None:
            s = BasicStatisticalSummary.from_sparse(x)
            norm = build_normalization_context(
                norm_name, mean=jnp.asarray(s.mean), variance=jnp.asarray(s.variance),
                intercept_index=SPARSE_D - 1)
        opt = dict(opt)
        if "optimizer" in opt:
            opt["optimizer"] = OptimizerType(opt["optimizer"])
        trained = train_glm(xs, jnp.asarray(y), "logistic_regression",
                            optimizer_config=OptimizerConfig(**opt),
                            regularization=RegularizationContext(RegularizationType.L2),
                            regularization_weights=lams, normalization=norm,
                            compute_variances=variances)
        for i, t in enumerate(trained):
            _store(out, f"{case}/{i}", t.result)
            out[f"{case}/{i}/means"] = np.asarray(t.model.coefficients.means)
            if variances:
                out[f"{case}/{i}/variances"] = np.asarray(t.model.coefficients.variances)

    train, val = yahoo_glmix(build_game_dataset, make_yahoo_like)
    res = GameEstimator(GameTrainingConfig.from_dict(yahoo_config_dict())).fit(
        train, val, ["AUC"], timing_mode="strict")
    out["yahoo/objective_history"] = np.asarray(res.objective_history)
    out["yahoo/auc_history"] = np.asarray(res.descent.validation_history["AUC"])
    out["yahoo/auc"] = np.asarray(res.validation["AUC"])
    for key, t in res.descent.trackers.items():
        out[f"yahoo/iterations/{key}"] = np.asarray(t.iterations)
    final = res.descent.model.coordinates
    out["yahoo/fixed/means"] = np.asarray(final["fixed"].glm.coefficients.means)
    for name in ("perUser", "perItem"):
        out[f"yahoo/{name}/coefficients"] = np.asarray(final[name].coefficients)
    out["yahoo/val_scores"] = np.asarray(res.descent.model.score_dataset(val))


def _run_bf16(out: dict) -> None:
    import jax.numpy as jnp
    from photon_ml_tpu.data.synthetic_bench import make_a1a_like, make_wide_sparse_logistic
    from photon_ml_tpu.models.training import train_glm
    from photon_ml_tpu.ops.features import PaddedSparse
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType)
    for kind in ("dense", "sparse"):
        x, y = bf16_problem(kind, make_a1a_like, make_wide_sparse_logistic)
        if kind == "dense":
            xb = jnp.asarray(x, jnp.bfloat16)
        else:
            # as bench.py casts config 6's values (scipy cannot hold bf16)
            p = PaddedSparse.from_scipy(x, with_csc=True)
            xb = PaddedSparse(p.indices, p.values.astype(jnp.bfloat16), p.num_cols,
                              p.csc_row, p.csc_val.astype(jnp.bfloat16), p.csc_end)
        for case, (opt, reg, lam, tol) in BF16_CASES.items():
            t = train_glm(xb, jnp.asarray(y), "logistic_regression",
                          optimizer_config=OptimizerConfig(
                              optimizer=OptimizerType(opt), max_iterations=BF16_MAX_ITERATIONS,
                              tolerance=tol),
                          regularization=RegularizationContext(RegularizationType(reg)),
                          regularization_weights=(lam,))[0]
            _store(out, f"{kind}/{case}", t.result)
            out[f"{kind}/{case}/means"] = np.asarray(t.model.coefficients.means)


def _run_bcoo(out: dict) -> None:
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    from photon_ml_tpu.models.training import train_glm
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType)
    data, idx, y = bcoo_problem()
    x = jsparse.BCOO((jnp.asarray(data), jnp.asarray(idx)), shape=(BCOO_N, BCOO_D))
    for case, (opt, iters, tol) in BCOO_CASES.items():
        t = train_glm(x, jnp.asarray(y), "logistic_regression",
                      optimizer_config=OptimizerConfig(
                          optimizer=OptimizerType(opt), max_iterations=iters, tolerance=tol),
                      regularization=RegularizationContext(RegularizationType.L2),
                      regularization_weights=(1.0,))[0]
        _store(out, case, t.result)
        out[f"{case}/means"] = np.asarray(t.model.coefficients.means)


def _run_bf16x(out: dict) -> None:
    """The streamed chunk on a bf16 host X (ml_dtypes), and the bootstrap
    on a bf16 X; bf16 results are stored as float32 (exact)."""
    import jax.numpy as jnp
    import ml_dtypes
    from photon_ml_tpu.data.streaming import ChunkPlan
    from photon_ml_tpu.diagnostics.bootstrap import bootstrap_training
    from photon_ml_tpu.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu.ops.losses import LOGISTIC
    from photon_ml_tpu.optim import (OptimizerConfig, RegularizationContext,
                                     RegularizationType)
    p = bf16x_problem()
    obj = ChunkedGLMObjective(LOGISTIC, p["x"].astype(ml_dtypes.bfloat16), p["y"],
                              ChunkPlan.build(BF16X_N, chunk_rows=BF16X_CHUNK),
                              weights=p["w"], offsets=p["o"], l2_weight=1.0)
    c, v = jnp.asarray(p["c"]), jnp.asarray(p["v"])
    out["chunk/value"] = np.asarray(obj.value(c))
    out["chunk/vg_value"], out["chunk/vg_gradient"] = map(np.asarray, obj.value_and_gradient(c))
    out["chunk/hessian_vector"] = np.asarray(obj.hessian_vector(c, v))
    out["chunk/hessian_diagonal"] = np.asarray(obj.replace(offsets=None).hessian_diagonal(c))
    out["chunk/scores"] = np.asarray(obj.scores(c))
    c_out, entry = obj.stochastic_pass(c, local_epochs=BF16X_EPOCHS, seed=BF16X_PASS_SEED)
    out["chunk/stochastic_x"], out["chunk/stochastic_entry"] = np.asarray(c_out), np.asarray(entry)
    x, y = bootstrap_problem()
    rep = bootstrap_training(x.astype(ml_dtypes.bfloat16), y, "logistic_regression",
                             num_bootstrap_samples=BOOT_K,
                             optimizer_config=OptimizerConfig(**BOOT_OPTIONS),
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0)
    for j, cs in enumerate(rep.coefficient_summaries):
        for f in ("min", "q1", "median", "q3", "max", "mean", "std"):
            out[f"boot/coef/{j}/{f}"] = np.asarray(float(getattr(cs, f)))
    for name, ms in rep.metric_summaries.items():
        out[f"boot/metric/{name}"] = np.asarray(float(ms.mean))
    out["boot/significant"] = np.asarray(rep.significant_mask)


def _store_fit(out: dict, key: str, res, val) -> None:
    """A GAME fit's histories, trackers, final models and validation
    scores under key/..."""
    from photon_ml_tpu.models.game import FactoredRandomEffectModel, FixedEffectModel
    out[f"{key}/objective_history"] = np.asarray(res.objective_history)
    out[f"{key}/auc_history"] = np.asarray(res.descent.validation_history["AUC"])
    for k, t in res.descent.trackers.items():
        out[f"{key}/iterations/{k}"] = np.asarray(t.iterations)
    for name, m in res.descent.model.coordinates.items():
        if isinstance(m, FixedEffectModel):
            out[f"{key}/{name}/means"] = np.asarray(m.glm.coefficients.means)
        elif isinstance(m, FactoredRandomEffectModel):
            out[f"{key}/{name}/latent_coefficients"] = np.asarray(m.latent_coefficients)
            out[f"{key}/{name}/projection"] = np.asarray(m.projection)
            out[f"{key}/{name}/entity_ids"] = np.asarray(m.entity_ids)
            out[f"{key}/{name}/global_dim"] = np.asarray(m.global_dim)
            out[f"{key}/{name}/global_coefficients"] = np.asarray(m.global_coefficients())
        else:
            out[f"{key}/{name}/coefficients"] = np.asarray(m.coefficients)
            out[f"{key}/{name}/global_coefficients"] = np.asarray(m.global_coefficients())
            out[f"{key}/{name}/entity_ids"] = np.asarray(m.entity_ids)
            out[f"{key}/{name}/global_dim"] = np.asarray(m.global_dim)
            if m.projection is not None:
                out[f"{key}/{name}/projection"] = np.asarray(m.projection)
            if m.projection_matrix is not None:
                out[f"{key}/{name}/projection_matrix"] = np.asarray(m.projection_matrix)
    out[f"{key}/val_scores"] = np.asarray(res.descent.model.score_dataset(val))


def _run_factored(out: dict) -> None:
    import jax.numpy as jnp
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.data.synthetic_bench import (make_movielens_like,
                                                    movielens_shards)
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.ops import features as F
    from photon_ml_tpu.ops.losses import LOGISTIC
    from photon_ml_tpu.optim import (OptimizerConfig, RegularizationContext,
                                     RegularizationType)
    from photon_ml_tpu.parallel import factored as fac
    from photon_ml_tpu.parallel.random_effect import EntityBlocks
    p = {k: jnp.asarray(v) for k, v in kron_problem().items()}
    kd = F.KroneckerDesign(p["x"], p["factors"])
    out["kron/matvec"] = np.asarray(F.matvec(kd, p["v"]))
    out["kron/rmatvec"] = np.asarray(F.rmatvec(kd, p["u"]))
    out["kron/sq_rmatvec"] = np.asarray(F.sq_rmatvec(kd, p["u"]))
    padded = F.pad_rows(kd, 3)
    out["kron/pad_x"], out["kron/pad_factors"] = np.asarray(padded.x), np.asarray(padded.factors)
    out["kron/densify"] = np.asarray(F.densify(kd))
    for keep in (False, True):
        for k, d, seed in ((3, 6, 7), (8, 21, 13), (5, 2, 0)):
            out[f"gauss/{keep}/{k}/{d}/{seed}"] = np.asarray(
                fac.gaussian_projection_matrix(k, d, keep_intercept=keep, seed=seed,
                                               dtype=jnp.float64))
    fallback = jnp.asarray(np.asarray(fac.gaussian_projection_matrix(3, 6, seed=1,
                                                                      dtype=jnp.float64)))
    wide = jnp.asarray(np.asarray(fac.gaussian_projection_matrix(8, 6, seed=2,
                                                                 dtype=jnp.float64)))
    for name, w, fb in (("full", p["w"], fallback), ("k_above_d", p["w"], wide),
                        ("zero", jnp.zeros_like(p["w"]), fallback),
                        ("rank2", p["w_rank2"], fallback)):
        out[f"pss/{name}"] = np.asarray(fac.principal_subspace_projection(w, fb))
    blocks = EntityBlocks(x=p["block_x"], labels=p["block_labels"], mask=p["block_mask"],
                          weights=p["block_weights"], offsets=p["block_offsets"])
    out["project/x"] = np.asarray(fac.project_blocks(blocks, p["projection"]).x)
    reg = RegularizationContext(RegularizationType.L2)
    for rows in (False, True):
        rw = (None if not rows else
              jnp.asarray(np.random.default_rng(9).uniform(size=p["block_mask"].size)))
        P, res = fac.refit_latent_projection(
            blocks, p["latent"], p["projection"], LOGISTIC, None,
            OptimizerConfig(max_iterations=30), reg, 1.0, row_weights=rw)
        out[f"refit/{rows}/P"] = np.asarray(P)
        _store(out, f"refit/{rows}", res)
    res = fac.fit_factored_random_effects(
        blocks, LOGISTIC, None, latent_coefficients=jnp.zeros_like(p["latent"]),
        projection=p["projection"], num_inner_iterations=2,
        re_config=OptimizerConfig(max_iterations=30), re_reg=reg, re_reg_weight=1.0,
        latent_config=OptimizerConfig(max_iterations=30), latent_reg=reg,
        latent_reg_weight=1.0)
    out["alternation/C"] = np.asarray(res.latent_coefficients)
    out["alternation/P"] = np.asarray(res.projection)
    train, val = movielens_game(build_game_dataset, make_movielens_like, movielens_shards)
    for case in FACTORED_CASES:
        res = GameEstimator(GameTrainingConfig.from_dict(factored_config_dict(case))).fit(
            train, val, ["AUC"], timing_mode="strict")
        _store_fit(out, case, res, val)


def _run_samplers(out: dict) -> None:
    import jax.numpy as jnp
    from photon_ml_tpu.data import samplers
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.data.synthetic_bench import (make_movielens_like,
                                                    movielens_shards)
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    import jax
    rng = np.random.default_rng(8)
    labels = (rng.uniform(size=997) < 0.3).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=997)
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        for name in ("binary_classification_downsample", "default_downsample"):
            for w in (None, weights):
                for dt in (jnp.float32, jnp.float64):
                    m, ww = getattr(samplers, name)(
                        key, jnp.asarray(labels, dt), None if w is None else jnp.asarray(w, dt),
                        0.35)
                    tag = f"draw/{seed}/{name}/{w is None}/{jnp.dtype(dt).name}"
                    out[f"{tag}/mask"], out[f"{tag}/weights"] = np.asarray(m), np.asarray(ww)
    train, val = movielens_glmix(build_game_dataset, make_movielens_like, movielens_shards)
    for task in SAMPLER_TASKS:
        res = GameEstimator(GameTrainingConfig.from_dict(samplers_config_dict(task))).fit(
            train, val, ["AUC"], timing_mode="strict")
        _store_fit(out, task, res, val)


def _run_prng(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    out["partitionable"] = np.asarray(jax.config.jax_threefry_partitionable)
    for seed in PRNG_SEEDS:
        k = jax.random.PRNGKey(seed)
        out[f"{seed}/key"] = np.asarray(k)
        for num in PRNG_SPLITS:
            out[f"{seed}/split/{num}"] = np.asarray(jax.random.split(k, num))
        for data in PRNG_FOLDS:
            out[f"{seed}/fold_in/{data}"] = np.asarray(jax.random.fold_in(k, data))
        chain = k
        for i in range(4):
            chain, sub = jax.random.split(chain)
            out[f"{seed}/chain/{i}"] = np.asarray(sub)
        for shape in PRNG_SHAPES:
            tag = f"{seed}/{shape}"
            out[f"{tag}/bits32"] = np.asarray(jax.random.bits(k, shape, jnp.uint32))
            out[f"{tag}/bits64"] = np.asarray(jax.random.bits(k, shape, jnp.uint64))
            for dt in (jnp.float32, jnp.float64):
                name = jnp.dtype(dt).name
                out[f"{tag}/uniform/{name}"] = np.asarray(jax.random.uniform(k, shape, dt))
                out[f"{tag}/uniform_range/{name}"] = np.asarray(
                    jax.random.uniform(k, shape, dt, minval=-3.3, maxval=5.7))
                out[f"{tag}/normal/{name}"] = np.asarray(jax.random.normal(k, shape, dt))
    for dt in (jnp.float32, jnp.float64):
        name = jnp.dtype(dt).name
        for seed in range(PRNG_NORMAL_SEEDS):
            out[f"normal/{seed}/{name}"] = np.asarray(
                jax.random.normal(jax.random.PRNGKey(seed), (PRNG_NORMAL_N,), dt))
        out[f"erfinv/{name}"] = np.asarray(
            jax.lax.erf_inv(jnp.asarray(erfinv_inputs(np.dtype(name)))))
    out["normal_f32_4x9_seed11"] = np.asarray(
        jax.random.normal(jax.random.PRNGKey(11), (4, 9), dtype=jnp.float32))
    for seed in PRNG_SEEDS:
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 2), 5)
        for n in PRNG_PERMUTATION_NS:
            out[f"{seed}/permutation/{n}"] = np.asarray(jax.random.permutation(key, n))


# model persistence: one small dataset and one model of each kind the port
# has, built from the same numpy arrays by either package
MODEL_IO_KINDS = ("fe", "re", "re_matrix", "factored", "mf")
MODEL_IO_FORMATS = ("npz", "avro", "reference")
MODEL_IO_N = 60


def model_io_arrays(seed: int = 9) -> dict:
    """The dataset's columns (string entity ids, as Avro gives them) and
    every model's parameters; feature names for the index maps.  Some
    coefficients are exactly zero (the Avro layouts drop them) and one
    user and one item are unseen by the models (they score 0)."""
    rng = np.random.default_rng(seed)
    n = MODEL_IO_N
    a = {"response": (rng.uniform(size=n) < 0.5).astype(np.float64),
         "global": rng.normal(size=(n, 6)), "per_user": rng.normal(size=(n, 4)),
         "per_item": rng.normal(size=(n, 3)),
         "userId": np.asarray([f"u{v}" for v in rng.integers(0, 8, n)]),
         "itemId": np.asarray([f"i{v}" for v in rng.integers(0, 5, n)])}
    for shard in ("global", "per_user", "per_item"):
        a[shard][:, -1] = 1.0
    a["fe_means"] = rng.normal(size=6)
    a["fe_means"][2] = 0.0
    a["fe_variances"] = rng.uniform(0.1, 1.0, size=6)
    a["re_ids"] = np.asarray([f"u{v}" for v in range(7)], dtype=object)
    a["re_coefficients"] = rng.normal(size=(7, 3))
    a["re_coefficients"][1, 0] = 0.0
    a["re_variances"] = rng.uniform(0.1, 1.0, size=(7, 3))
    proj = np.tile(np.asarray([0, 1, 3]), (7, 1))
    proj[2] = [1, 3, -1]
    a["re_projection"] = proj
    a["re_matrix_coefficients"] = rng.normal(size=(7, 2))
    a["re_matrix_projection"] = rng.normal(size=(2, 4))
    a["latent_coefficients"] = rng.normal(size=(7, 2))
    a["latent_projection"] = rng.normal(size=(2, 4))
    a["mf_row_ids"] = a["re_ids"]
    a["mf_row_factors"] = rng.normal(size=(7, 3))
    a["mf_col_ids"] = np.asarray([f"i{v}" for v in range(4)], dtype=object)
    a["mf_col_factors"] = rng.normal(size=(4, 3))
    return a


MODEL_IO_FEATURES = {"global": [(f"g{j}", "x") for j in range(5)],
                     "per_user": [(f"u{j}", "") for j in range(3)],
                     "per_item": [(f"i{j}", "") for j in range(2)]}


def model_io_dataset(build_game_dataset, build_index_map, a: dict):
    """The scoring dataset, with index maps; pass either package's
    dataset functions."""
    return build_game_dataset(
        a["response"], {s: a[s] for s in ("global", "per_user", "per_item")},
        entity_ids={"userId": a["userId"], "itemId": a["itemId"]},
        index_maps={s: build_index_map(f) for s, f in MODEL_IO_FEATURES.items()})


def model_io_model(kind: str, a: dict, put, game, model_for_task, Coefficients):
    """The GameModel of `kind` built with either package's classes (`game`
    its models.game module, `put` its host-array-to-device function)."""
    fe = game.FixedEffectModel(model_for_task("logistic_regression", Coefficients(
        put(a["fe_means"]), put(a["fe_variances"]))), "global")
    coords = {"fixed": fe}
    common = dict(random_effect_type="userId", feature_shard="per_user",
                  task_type="logistic_regression", entity_ids=a["re_ids"], global_dim=4)
    if kind == "re":
        coords["perUser"] = game.RandomEffectModel(
            coefficients=put(a["re_coefficients"]), projection=a["re_projection"],
            variances=put(a["re_variances"]), **common)
    elif kind == "re_matrix":
        coords["perUser"] = game.RandomEffectModel(
            coefficients=put(a["re_matrix_coefficients"]), projection=None,
            projection_matrix=put(a["re_matrix_projection"]), **common)
    elif kind == "factored":
        coords["perUserMF"] = game.FactoredRandomEffectModel(
            latent_coefficients=put(a["latent_coefficients"]),
            projection=put(a["latent_projection"]), **common)
    elif kind == "mf":
        coords["mf"] = game.MatrixFactorizationModel(
            row_effect_type="userId", col_effect_type="itemId",
            row_factors=put(a["mf_row_factors"]), row_ids=a["mf_row_ids"],
            col_factors=put(a["mf_col_factors"]), col_ids=a["mf_col_ids"])
    return game.GameModel(coords, "logistic_regression")


def _run_model_io(out: dict, root: Path) -> None:
    """Write each kind in each layout under root/jax_models/<kind>/<format>;
    score the in-memory models and every directory the port wrote under
    root/port_models/<kind>/<format>."""
    import jax.numpy as jnp
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.data.index_map import build_index_map
    from photon_ml_tpu.game.config import GameTrainingConfig
    from photon_ml_tpu.models import game
    from photon_ml_tpu.models.coefficients import Coefficients
    from photon_ml_tpu.models.glm import model_for_task
    from photon_ml_tpu.models.io import load_game_model, save_game_model
    a = model_io_arrays()
    ds = model_io_dataset(build_game_dataset, build_index_map, a)
    config = GameTrainingConfig.from_dict(glmix_config_dict())
    for kind in MODEL_IO_KINDS:
        model = model_io_model(kind, a, jnp.asarray, game, model_for_task, Coefficients)
        out[f"scores/{kind}"] = np.asarray(model.score_dataset(ds))
        for fmt in MODEL_IO_FORMATS:
            d = str(root / "jax_models" / kind / fmt)
            try:
                save_game_model(model, d, config=config, index_maps=ds.index_maps,
                                format=fmt)
            except ValueError:
                out[f"refused/{kind}/{fmt}"] = np.asarray(True)
            port_dir = root / "port_models" / kind / fmt
            if (port_dir / "model-metadata.json").exists():
                loaded, cfg = load_game_model(str(port_dir))
                out[f"port_loaded/{kind}/{fmt}"] = np.asarray(loaded.score_dataset(ds))
                out[f"port_config/{kind}/{fmt}"] = np.asarray(
                    cfg is not None and cfg.to_dict() == config.to_dict())


# the command-line parity: the same jobs through either package's CLI
CLI_SHARD_MAP = '{"global": ["globalFeatures"], "per_user": ["userFeatures"]}'


def cli_jobs(root: Path) -> list:
    """(name, CLI module, argv) of each parity job over the inputs under
    `root` (made by the test before the JAX side runs), in order: later
    jobs read earlier jobs' output.  Each package's run adds its own
    output prefix and device flags."""
    d = lambda *p: str(root.joinpath(*p))
    common = ["--mesh", "none", "--no-compile-cache", "--x64"]
    return [
        ("legacy_npz", "train", ["--train-data", d("train.npz"),
                                 "--validation-data", d("val.npz"),
                                 "--reg-weights", "0.1,1,10", "--evaluators", "AUC",
                                 "--max-iterations", "100", "--tolerance", "1e-9",
                                 *common]),
        ("legacy_libsvm", "train", ["--train-data", d("a1a.libsvm"),
                                    "--regularization", "elastic_net",
                                    "--elastic-net-alpha", "0.5", "--reg-weights", "0.5",
                                    "--model-format", "avro", *common]),
        ("game_npz", "train", ["--train-data", d("train.npz"),
                               "--validation-data", d("val.npz"),
                               "--config", d("config.json"), "--evaluators", "AUC",
                               *common]),
        # out of core: the fixed effect's 0.71 MB shard streams under a
        # 0.6 MB budget; the legacy path streams its one coordinate
        ("game_npz_hbm", "train", ["--train-data", d("train.npz"),
                                   "--validation-data", d("val.npz"),
                                   "--config", d("config.json"), "--evaluators", "AUC",
                                   "--hbm-budget", "0.6MB",
                                   *common]),
        ("legacy_npz_hbm", "train", ["--train-data", d("train.npz"),
                                     "--validation-data", d("val.npz"),
                                     "--reg-weights", "1", "--evaluators", "AUC",
                                     "--hbm-budget", "500KB", *common]),
        # hyperparameter tuning after the fit: random search, and the GP
        # search warm-started from the best model with a pinned seed
        ("game_tuning_random", "train", ["--train-data", d("train.npz"),
                                         "--validation-data", d("val.npz"),
                                         "--config", d("config.json"), "--evaluators", "AUC",
                                         "--tuning", "random", "--tuning-iterations", "3",
                                         *common]),
        ("game_tuning_bayesian", "train", ["--train-data", d("train.npz"),
                                           "--validation-data", d("val.npz"),
                                           "--config", d("config.json"),
                                           "--evaluators", "AUC", "--tuning", "bayesian",
                                           "--tuning-iterations", "4", "--warm-start",
                                           "--sweep-seed", "7", *common]),
        ("index", "index", ["--data", d("avro", "train"),
                            "--feature-shard-map", CLI_SHARD_MAP]),
        ("game_avro", "train", ["--train-data", d("avro", "train"),
                                "--validation-data", d("avro", "val"),
                                "--config", d("config.json"),
                                "--feature-shard-map", CLI_SHARD_MAP,
                                "--id-columns", "userId", "--evaluators", "AUC",
                                "--model-format", "reference", *common]),
        ("score_npz", "score", ["--data", d("val.npz"), "--evaluators", "AUC,RMSE",
                                "--predict", "--mesh", "none", "--no-compile-cache"]),
        ("score_avro", "score", ["--data", d("avro", "val"), "--format", "avro",
                                 "--feature-shard-map", CLI_SHARD_MAP,
                                 "--id-columns", "userId", "--evaluators", "AUC",
                                 "--mesh", "none", "--no-compile-cache"]),
    ]


def cli_job_argv(name: str, kind: str, argv: list, out: Path) -> list:
    """A job's argv with its outputs under `out` (the package's own)."""
    o = lambda *p: str(out.joinpath(*p))
    if kind == "train":
        extra = ["--output-dir", o(name)]
        if name == "game_avro":
            extra += ["--index-map-dir", o("index")]
        return argv + extra
    if kind == "index":
        return argv + ["--output", o("index")]
    model = {"score_npz": "game_npz", "score_avro": "game_avro"}[name]
    ext = "avro" if name == "score_avro" else "npz"
    return argv + ["--model-dir", o(model, "best"), "--output", o(f"{name}.{ext}")]


def _run_cli(out: dict, root: Path) -> None:
    """Run every cli_jobs job through the JAX package's CLIs in this
    process, outputs under root/jax_out; their printed JSON lines."""
    import contextlib
    import io
    from photon_ml_tpu.cli import index, score, train
    from photon_ml_tpu.data import avro_game
    # the JAX CLI's Avro ingest keeps float32 features, which its float64
    # (--x64) LBFGS refuses (a float32 carry against float64 gradients);
    # widen them to float64 here: the float32-rounded values the port
    # computes with under --x64
    read = avro_game.read_game_examples

    def read_widened(*args, **kwargs):
        res = read(*args, **kwargs)
        res.dataset.feature_shards = {s: x.astype(np.float64) for s, x in
                                      res.dataset.feature_shards.items()}
        return res
    avro_game.read_game_examples = read_widened
    modules = {"train": train, "index": index, "score": score}
    for name, kind, argv in cli_jobs(root):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = modules[kind].main(cli_job_argv(name, kind, argv, root / "jax_out"))
        out[f"{name}/rc"] = np.asarray(rc)
        out[f"{name}/json"] = np.asarray(buf.getvalue().strip().splitlines()[-1])


# containment: solver schedules, iteration caps, the quarantine and
# checkpoints, on tests/test_faults.py's _glmix shape (900 rows, 30 users,
# d = 8 and 4), split 90/10, LBFGS(15) with L2 lambda 1
CONT_ROWS, CONT_USERS, CONT_SEED, CONT_ITERATIONS = 900, 30, 7, 15
CONT_SCHEDULE = {"initial_iterations": 3, "iteration_growth": 2.0,
                 "initial_tolerance_factor": 1000.0, "tolerance_decay": 0.1}
# single solves under a cap: (optimizer options, regularization); batched
# lanes under a cap: SOLVER_CASES entries
CAPS = (3, 0)
CAP_SINGLE = {"lbfgs": ({"max_iterations": 60, "tolerance": 1e-9}, "l2"),
              "owlqn": ({"max_iterations": 60, "tolerance": 1e-9}, "l1"),
              "tron": ({"optimizer": "tron", "max_iterations": 15, "tolerance": 1e-9}, "l2")}
CAP_BATCHED = ("logistic_l2", "logistic_elastic_net", "logistic_l2_tron", "logistic_l2_box")
POISON_PLAN = {"seed": 0, "faults": [{"site": "solve.poison", "action": "poison",
                                      "hits": [2], "match": {"coordinate": "perUser"}}]}
FREEZE_PLAN = {"seed": 0, "faults": [{"site": "solve.poison", "action": "poison",
                                      "hits": [2, 3, 4, 5],
                                      "match": {"coordinate": "perUser"}}]}


def cap_problem(seed: int = 4) -> dict:
    """A [300 x 8] logistic problem with an intercept column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 8))
    x[:, -1] = 1.0
    z = x @ rng.normal(size=8)
    y = (rng.uniform(size=300) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return {"x": x, "y": y}


def containment_glmix(build_game_dataset):
    """(train, validation) of the containment shape in float64; pass either
    package's build_game_dataset."""
    rng = np.random.default_rng(CONT_SEED)
    n = CONT_ROWS
    xg = rng.normal(size=(n, 8))
    xg[:, -1] = 1.0
    xu = rng.normal(size=(n, 4))
    xu[:, -1] = 1.0
    users = np.arange(n) % CONT_USERS
    z = xg @ rng.normal(size=8)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    ds = build_game_dataset(y, {"g": xg, "u": xu},
                            entity_ids={"userId": np.asarray([f"u{i:04d}" for i in users])})
    val_mask = np.random.default_rng(CONT_SEED + 99).uniform(size=n) < 0.1
    return ds.subset(np.flatnonzero(~val_mask)), ds.subset(np.flatnonzero(val_mask))


def containment_config_dict(outer: int = 3, schedule=None, factored: bool = False) -> dict:
    """A fixed effect on "g" and a per-user random effect on "u"
    (identity projector), with `factored` a per-user factored coordinate
    (latent dim 2) after them; `schedule` the training-level
    SolverSchedule JSON."""
    opt = glmix_config_dict()["coordinates"]["fixed"]["optimization"]
    opt = dict(opt, optimizer=dict(opt["optimizer"], max_iterations=CONT_ITERATIONS))
    coords = {"fixed": {"kind": "fixed_effect", "feature_shard": "g",
                        "normalization": "none", "shard_features": None,
                        "memory_mode": None, "chunk_rows": None,
                        "solver_schedule": None, "optimization": opt},
              "perUser": {"kind": "random_effect", "random_effect_type": "userId",
                          "feature_shard": "u", "active_data_upper_bound": None,
                          "passive_data_lower_bound": None,
                          "features_to_samples_ratio": None, "projector": "identity",
                          "solver_schedule": None, "optimization": opt}}
    seq = ["fixed", "perUser"]
    if factored:
        coords["perUserMF"] = {"kind": "factored_random_effect",
                               "random_effect_type": "userId", "feature_shard": "u",
                               "latent_dim": 2, "num_inner_iterations": 1,
                               "active_data_upper_bound": None,
                               "passive_data_lower_bound": None, "solver_schedule": None,
                               "optimization": opt, "latent_optimization": opt}
        seq.append("perUserMF")
    return {"task_type": "logistic_regression", "coordinates": coords,
            "updating_sequence": seq, "num_outer_iterations": outer, "seed": CONT_SEED,
            "hbm_budget_bytes": None, "solver_schedule": schedule}


# name -> (config, timing mode, fault plan) of each containment fit, run
# with validation AUC
CONTAINMENT_FITS = {
    "straight": (lambda: containment_config_dict(3), "pipelined", None),
    "scheduled": (lambda: containment_config_dict(4, CONT_SCHEDULE), "pipelined", None),
    "scheduled_strict": (lambda: containment_config_dict(4, CONT_SCHEDULE), "strict", None),
    "scheduled_factored": (lambda: containment_config_dict(3, CONT_SCHEDULE, True),
                           "pipelined", None),
    "poison_pipelined": (lambda: containment_config_dict(4), "pipelined", POISON_PLAN),
    "poison_strict": (lambda: containment_config_dict(4), "strict", POISON_PLAN),
    "freeze": (lambda: containment_config_dict(5), "pipelined", FREEZE_PLAN),
}


def containment_cli_runs(root: Path) -> list:
    """(name, argv, fault plan) of the checkpointed CLI runs over the
    files under `root`: a 2-iteration fit with a poisoned perUser solve,
    then the same command at 3 iterations resuming from its checkpoint.
    Each package adds its own output paths and device flags."""
    d = lambda *p: str(root.joinpath(*p))
    common = ["--train-data", d("cont_train.npz"), "--validation-data", d("cont_val.npz"),
              "--evaluators", "AUC", "--mesh", "none", "--no-compile-cache", "--x64"]
    return [("poisoned", common + ["--config", d("cont_config2.json")], POISON_PLAN),
            ("resumed", common + ["--config", d("cont_config3.json")], None)]


def containment_cli_argv(argv: list, plan, out: Path) -> list:
    """A CLI run's argv with its outputs under `out` (the package's own)."""
    extra = ["--output-dir", str(out / "cli"), "--checkpoint-dir", str(out / "cli_ckpt")]
    if plan is not None:
        import json
        extra += ["--fault-plan", json.dumps(plan)]
    return argv + extra


def _run_containment(out: dict, root: Path) -> None:
    """Capped solves, the containment fits, a 1-iteration checkpoint
    (root/jax_ckpt) and a resume from the port's (root/port_ckpt), and the
    checkpointed CLI runs (outputs under root/jax_out)."""
    import contextlib
    import io
    import json
    import jax.numpy as jnp
    from photon_ml_tpu.cli import train as train_cli
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.ops.losses import BY_NAME
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType,
                                     SolveBudget, solve)
    from photon_ml_tpu.parallel.random_effect import _cached_batched_solver
    from photon_ml_tpu.utils import faults
    p = cap_problem()
    obj = GLMObjective(BY_NAME["logistic"], jnp.asarray(p["x"]), jnp.asarray(p["y"]))
    for kind, (opt, reg) in CAP_SINGLE.items():
        opt = dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs")))
        for cap in CAPS:
            res = solve(obj, jnp.zeros(p["x"].shape[1]), OptimizerConfig(**opt),
                        RegularizationContext(RegularizationType(reg)), 1.0,
                        budget=SolveBudget.make(cap, opt["tolerance"]))
            _store(out, f"caps/{kind}/{cap}", res)
    for case in CAP_BATCHED:
        loss, reg, alpha, lam, _, opt = SOLVER_CASES[case]
        q = solver_problem(case)
        opt = dict(opt)
        if "optimizer" in opt:
            opt["optimizer"] = OptimizerType(opt["optimizer"])
        cfg = OptimizerConfig(**{"max_iterations": SOLVER_MAX_ITERATIONS,
                                 "tolerance": SOLVER_TOLERANCE, **opt})
        solver = _cached_batched_solver(BY_NAME[loss], cfg,
                                        RegularizationContext(RegularizationType(reg), alpha),
                                        True, True)
        for cap in CAPS:
            res = solver(*(jnp.asarray(q[k]) for k in
                           ("x", "labels", "mask", "weights", "offsets", "x0")),
                         jnp.asarray(lam), SolveBudget.make(cap, cfg.resolved().tolerance))
            _store(out, f"caps/{case}/{cap}", res)

    train, val = containment_glmix(build_game_dataset)
    for name, (make, mode, plan) in CONTAINMENT_FITS.items():
        est = GameEstimator(GameTrainingConfig.from_dict(make()))
        if plan is None:
            res = est.fit(train, val, ["AUC"], timing_mode=mode)
        else:
            with faults.injected(faults.FaultPlan.from_dict(plan)):
                res = est.fit(train, val, ["AUC"], timing_mode=mode)
        _store_containment(out, name, res)
    GameEstimator(GameTrainingConfig.from_dict(containment_config_dict(1))).fit(
        train, val, ["AUC"], checkpoint_dir=str(root / "jax_ckpt"))
    res = GameEstimator(GameTrainingConfig.from_dict(containment_config_dict(3))).fit(
        train, val, ["AUC"], checkpoint_dir=str(root / "port_ckpt"))
    _store_containment(out, "resumed_from_port", res)
    out["resumed_from_port/recovery"] = np.asarray(json.dumps(res.checkpoint_recovery))

    for name, argv, plan in containment_cli_runs(root):
        faults.install_plan(None)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(containment_cli_argv(argv, plan, root / "jax_out"))
        out[f"cli/{name}/rc"] = np.asarray(rc)
        out[f"cli/{name}/json"] = np.asarray(buf.getvalue().strip().splitlines()[-1])
    faults.install_plan(None)


def _store_containment(out: dict, key: str, res) -> None:
    """A containment fit's objective and AUC histories, per-coordinate
    iteration caps and containment counts, and its events (JSON)."""
    import json
    out[f"{key}/objective_history"] = np.asarray(res.objective_history)
    out[f"{key}/auc_history"] = np.asarray(res.descent.validation_history["AUC"])
    diag = res.descent.solver_diagnostics()
    out[f"{key}/diagnostics"] = np.asarray(json.dumps(
        {c: {"iteration_caps": d["iteration_caps"], "containment": d["containment"],
             "iterations": d["iterations"]} for c, d in diag.items()}))
    out[f"{key}/events"] = np.asarray(json.dumps(res.descent.containment_events))
    out[f"{key}/frozen"] = np.asarray(json.dumps(res.descent.frozen_coordinates))


# out of core (the "stream" mode): the chunked oracle, the streamed
# solvers, the stochastic lane and streamed GLMix fits under a budget, all
# in float64
ORACLE_N, ORACLE_D, ORACLE_CHUNK, ORACLE_SEED = 3000, 12, 512, 21
# case -> (loss, weights + offsets, user row mask, standardization shifts)
ORACLE_CASES = {"plain": ("logistic", False, False, False),
                "wo": ("logistic", True, False, False),
                "mask": ("logistic", False, True, False),
                "shift": ("logistic", False, False, True),
                "all": ("logistic", True, True, True),
                "poisson_all": ("poisson", True, True, True),
                "squared_mask": ("squared", True, True, False)}
SOLVE_N, SOLVE_D, SOLVE_CHUNK, SOLVE_SEED = 2000, 10, 256, 5
# case -> (optimizer options, regularization, lambda)
STREAM_SOLVES = {"lbfgs": ({"max_iterations": 60, "tolerance": 1e-9}, "l2", 1.0),
                 "owlqn": ({"max_iterations": 60, "tolerance": 1e-9}, "l1", 0.5),
                 # TRON's gradient test at 1e-6, as _TRON's above
                 "tron": ({"optimizer": "tron", "max_iterations": 15,
                           "tolerance": 1e-6}, "l2", 1.0)}
STREAM_CAPS = (None, 3, 0)
# bench.py --stoch --smoke's out-of-core leg: n 16,384, d 16, 2 passes of 6
# local epochs, LBFGS(80) polish; plus Poisson (the step clip) and a
# standardized objective at a smaller size
STOCH_N, STOCH_D, STOCH_SEED, STOCH_PASSES, STOCH_EPOCHS = 16384, 16, 7, 2, 6
# case -> (loss, rows, d, merge, standardized)
STOCH_CASES = {"sequential": ("logistic", STOCH_N, STOCH_D, "sequential", False),
               "average": ("logistic", STOCH_N, STOCH_D, "average", False),
               "poisson": ("poisson", 4096, 8, "sequential", False),
               "standardized": ("logistic", 4096, 8, "sequential", True)}
# bench.py --stream --smoke: n 6,000, d_global 24, 300 users, d_user 4,
# 2 outer iterations of LBFGS(8), seed 17; the budget is half the resident
# footprint, floored at the largest coordinate + the flat vectors
RES_N, RES_DG, RES_USERS, RES_DU, RES_OUTER, RES_ITERS, RES_SEED = \
    6000, 24, 300, 4, 2, 8, 17
RES_SCHEDULE = {"stochastic_passes": 2, "stochastic_local_epochs": 6,
                "stochastic_seed": 17}


def oracle_problem(case: str) -> dict:
    """The chunked-oracle problem of `case`: x [3000, 12] with an intercept,
    labels of the case's loss, and the case's weights, offsets, row mask
    (about 30% zeros) and standardization (factors, shifts)."""
    loss, wo, mask, shift = ORACLE_CASES[case]
    rng = np.random.default_rng(ORACLE_SEED)
    n, d = ORACLE_N, ORACLE_D
    x = rng.normal(size=(n, d)) + 0.5
    x[:, -1] = 1.0
    z = x @ (rng.normal(size=d) * 0.3)
    if loss == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.3 * z)).astype(float)
    else:
        y = z + rng.normal(size=n)
    out = {"x": x, "y": y, "c": rng.normal(size=d) * 0.2,
           "v": rng.normal(size=d),
           "w": rng.uniform(0.5, 2.0, size=n) if wo else None,
           "o": rng.normal(size=n) * 0.2 if wo else None,
           "m": (rng.uniform(size=n) > 0.3).astype(float) if mask else None,
           "f": None, "s": None}
    if shift:
        mean, std = x.mean(axis=0), x.std(axis=0)
        std[-1] = 1.0
        out["f"], out["s"] = 1.0 / std, mean
        out["s"][-1] = 0.0
    return out


def solve_problem() -> tuple:
    rng = np.random.default_rng(SOLVE_SEED)
    x = rng.normal(size=(SOLVE_N, SOLVE_D))
    x[:, -1] = 1.0
    y = (rng.uniform(size=SOLVE_N) < 1 / (1 + np.exp(-(x @ rng.normal(size=SOLVE_D)))))
    return x, y.astype(float)


def stoch_problem(case: str) -> tuple:
    """bench.py's _stoch_problem (logistic) at the case's size; Poisson
    labels from the same draws for the Poisson case."""
    loss, n, d, _, _ = STOCH_CASES[case]
    rng = np.random.default_rng(STOCH_SEED)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(size=d) * 0.5
    if loss == "poisson":
        y = rng.poisson(np.exp(0.5 * (x @ w))).astype(float)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    return x, y


def stoch_norm(x) -> tuple:
    mean, std = x.mean(axis=0), x.std(axis=0)
    std[-1], mean[-1] = 1.0, 0.0
    return 1.0 / std, mean


def stream_config_dict(budget, schedule=None) -> dict:
    """bench.py's _stream_config(RES_OUTER, RES_ITERS, budget, seed=RES_SEED)
    as GameTrainingConfig JSON, with an optional solver schedule."""
    opt = {"optimizer": {"optimizer": "lbfgs", "max_iterations": RES_ITERS},
           "regularization": {"type": "l2"}, "regularization_weight": 1.0}
    return {"task_type": "logistic_regression",
            "coordinates": {
                "fixed": {"kind": "fixed_effect", "feature_shard": "global",
                          "optimization": opt},
                "perUser": {"kind": "random_effect", "random_effect_type": "userId",
                            "feature_shard": "per_user", "projector": "identity",
                            "optimization": opt}},
            "updating_sequence": ["fixed", "perUser"],
            "num_outer_iterations": RES_OUTER, "seed": RES_SEED,
            "hbm_budget_bytes": budget, "solver_schedule": schedule}


def stream_budget(acct: dict) -> int:
    """bench.py _stream_entry's budget from a resident fit's accounting."""
    resident_total = acct["resident_block_total"] + acct["flat_vector_bytes"]
    floor = int((max(acct["resident_block_bytes"].values())
                 + acct["flat_vector_bytes"]) * 1.05)
    return max(int(resident_total * 0.5), floor)


# streamed GLMix fits: name -> (budgeted, timing mode, schedule)
RES_FITS = {"resident": (False, "pipelined", None),
            "streamed": (True, "pipelined", None),
            "streamed_strict": (True, "strict", None),
            "stochastic": (True, "pipelined", RES_SCHEDULE)}


def _run_stream(out: dict) -> None:
    import json
    import jax.numpy as jnp
    from photon_ml_tpu.data.streaming import ChunkPlan
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu.ops.losses import BY_NAME
    from photon_ml_tpu.ops.normalization import NormalizationContext
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType,
                                     RegularizationContext, RegularizationType,
                                     SolveBudget, StochasticPlan, solve_streamed,
                                     solve_stochastic)
    j = lambda a: None if a is None else jnp.asarray(a)
    for case, (loss, *_rest) in ORACLE_CASES.items():
        p = oracle_problem(case)
        norm = (None if p["f"] is None
                else NormalizationContext(j(p["f"]), j(p["s"]), ORACLE_D - 1))
        obj = ChunkedGLMObjective(BY_NAME[loss], p["x"], p["y"],
                                  ChunkPlan.build(ORACLE_N, chunk_rows=ORACLE_CHUNK),
                                  weights=p["w"], offsets=p["o"], mask=p["m"],
                                  norm=norm, l2_weight=0.5)
        c = j(p["c"])
        v, g = obj.value_and_gradient(c)
        out[f"oracle/{case}/value"] = np.asarray(obj.value(c))
        out[f"oracle/{case}/vg_value"], out[f"oracle/{case}/grad"] = np.asarray(v), np.asarray(g)
        out[f"oracle/{case}/hv"] = np.asarray(obj.hessian_vector(c, j(p["v"])))
        if norm is None:
            out[f"oracle/{case}/hd"] = np.asarray(obj.hessian_diagonal(c))
        out[f"oracle/{case}/scores"] = np.asarray(obj.scores(c))
        out[f"oracle/{case}/stats"] = np.asarray(json.dumps(obj.stats.snapshot()))

    x, y = solve_problem()
    for case, (opt, reg, lam) in STREAM_SOLVES.items():
        opt = dict(opt, optimizer=OptimizerType(opt.get("optimizer", "lbfgs")))
        cfg = OptimizerConfig(**opt)
        for cap in STREAM_CAPS:
            obj = ChunkedGLMObjective(BY_NAME["logistic"], x, y,
                                      ChunkPlan.build(SOLVE_N, chunk_rows=SOLVE_CHUNK))
            budget = None if cap is None else SolveBudget.make(cap, cfg.tolerance)
            res = solve_streamed(obj, jnp.zeros(SOLVE_D), cfg,
                                 RegularizationContext(RegularizationType(reg)), lam,
                                 budget=budget)
            _store(out, f"solve/{case}/{cap}", res)
            out[f"solve/{case}/{cap}/passes"] = np.asarray(obj.stats.passes)

    for case, (loss, n, d, merge, standardized) in STOCH_CASES.items():
        x, y = stoch_problem(case)
        norm = None
        if standardized:
            f, s_ = stoch_norm(x)
            norm = NormalizationContext(j(f), j(s_), d - 1)
        obj = ChunkedGLMObjective(BY_NAME[loss], x, y,
                                  ChunkPlan.build(n, chunk_rows=max(n // 8, 256)),
                                  norm=norm)
        plan = StochasticPlan(passes=STOCH_PASSES, local_epochs=STOCH_EPOCHS,
                              seed=STOCH_SEED, merge=merge)
        cfg = OptimizerConfig(max_iterations=80, tolerance=1e-9)
        l2 = RegularizationContext(RegularizationType.L2)
        coarse = solve_streamed(obj, jnp.zeros(d), cfg, l2, 1.0, stochastic=plan)
        polish = solve_streamed(obj, coarse.x, cfg, l2, 1.0)
        out[f"stoch/{case}/x"] = np.asarray(coarse.x)
        out[f"stoch/{case}/loss_history"] = np.asarray(coarse.loss_history)
        _store(out, f"stoch/{case}/polish", polish)
        out[f"stoch/{case}/stats"] = np.asarray(json.dumps(obj.stats.snapshot()))

    import sys as _sys
    _sys.path.insert(0, str(ROOT))
    from bench import _pipeline_dataset
    train, val = _pipeline_dataset(RES_N, RES_DG, RES_USERS, RES_DU, RES_SEED)
    budget = None
    for name, (budgeted, mode, schedule) in RES_FITS.items():
        cfg = GameTrainingConfig.from_dict(
            stream_config_dict(budget if budgeted else None, schedule))
        res = GameEstimator(cfg).fit(train, val, ["AUC"], timing_mode=mode)
        if name == "resident":
            budget = stream_budget(res.residency)
            out["res/budget"] = np.asarray(budget)
        out[f"res/{name}/objective_history"] = np.asarray(res.objective_history)
        out[f"res/{name}/auc_history"] = np.asarray(res.descent.validation_history["AUC"])
        out[f"res/{name}/accounting"] = np.asarray(json.dumps(res.residency))
        out[f"res/{name}/diagnostics"] = np.asarray(json.dumps(
            res.descent.solver_diagnostics()))
        out[f"res/{name}/trackers"] = np.asarray(json.dumps(
            {k: t.stream for k, t in res.descent.trackers.items()}))
    # the telemetry parity test's streamed fit: the streamed fit again
    # under an armed tracer (its programs are compiled by now)
    import telemetry_jax_side as tj
    out[tj.STREAMED_KEY] = np.asarray(tj.traced_record("streamed", None, budget))


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


# the stream mode's results, shared by the three test modules that read them
# (one subprocess per test process)
_STREAM_RESULTS: dict = {}


def stream_results(out: Path) -> dict:
    if not _STREAM_RESULTS:
        _STREAM_RESULTS.update(run_jax_side("stream", out))
    return _STREAM_RESULTS


def main(argv) -> int:
    what, path = argv[1], argv[2]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out: dict = {}
    if what == "model_io":
        _run_model_io(out, Path(path).parent)
    elif what == "cli":
        _run_cli(out, Path(path).parent)
    elif what == "containment":
        _run_containment(out, Path(path).parent)
    else:
        {"tron": _run_tron, "solver": _run_solver, "estimator": _run_estimator,
         "sparse": _run_sparse, "factored": _run_factored,
         "samplers": _run_samplers, "prng": _run_prng,
         "stream": _run_stream, "bf16": _run_bf16, "bcoo": _run_bcoo,
         "bf16x": _run_bf16x}[what](out)
    np.savez(path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
