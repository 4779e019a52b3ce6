"""The JAX side of the mesh, multi-process and ADMM parity tests
(test_torch_mesh.py, test_torch_multihost.py, test_torch_admm.py), run in
a subprocess of its own, one per test module, with JAX on the CPU in
float64 over 8 virtual devices:

    python tests/port/mesh_jax_side.py mesh DxF|sparse DxF|mstream|multihost|admm ROOT

`mesh DxF` fits the GLMix problem below through the JAX package's
GameEstimator on that mesh, then the fixed effect with a factored random
effect (one process per mesh shape, so their compiles run side by side);
`sparse DxF` fits the sparse fixed effect on that mesh (the JAX package
drops the column view there, the port keeps one per shard); `mstream`
runs streaming over a mesh (the mesh-streamed GLMix fit on
MSTREAM_SHAPES, the stochastic lane on 8 x 1), a process
of the `mesh` mode beside the others; `admm` runs
the consensus ADMM
for a fixed number of iterations on each case and mesh; `multihost` runs
the JAX package's cli.train as a two-process pair (jax.distributed, gloo)
writing a checkpoint under ROOT/jax_pair, and resumes the port pair's
checkpoint (ROOT/port_pair, written first by the test) in one JAX
process.  Results go to ROOT/<mode>[-DxF].pkl.  The problem functions are numpy
only, so the port side (mesh_port_side.py) makes the same inputs.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import game_jax_side as side

ROOT = Path(__file__).resolve().parents[2]

# GLMix (config 4's shape) and a fixed effect + factored random effect, cut
# to GLMIX_ROWS rows, GLMIX_ITERATIONS LBFGS iterations and GLMIX_CAP
# samples per user (two S-buckets: each bucket compiles its own batched
# solver in the JAX package, for each mesh)
GLMIX_ROWS, GLMIX_ITERATIONS, GLMIX_CAP = 1200, 20, 2
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))
# a fixed effect with a factored random effect on the same meshes, and a
# sparse fixed effect (bench config 7's generator, cut) on 2 x 1
FACTORED_SHAPES = MESH_SHAPES
SPARSE_SHAPE = (2, 1)

# ADMM: bench.py's _admm_problem at ADMM_N x ADMM_D, ADMM_ITERATIONS
# iterations with tolerance 0 (every iteration runs)
ADMM_N, ADMM_D, ADMM_ITERATIONS = 384, 14, 40
ADMM_SHAPES = ((1, 2), (2, 2))
# case -> (loss, regularization, weight)
ADMM_CASES = {"logistic_l2": ("logistic", "l2", 0.3),
              "squared_l2": ("squared", "l2", 0.3),
              "logistic_l1": ("logistic", "l1", 30.0)}

# the multi-process CLI runs: a dense fixed effect (bench.py's
# _mh_write_inputs at MH_N x MH_D) for MH_OUTER outer iterations
MH_N, MH_D, MH_OUTER, MH_SHORT = 256, 6, 5, 2

# streaming over a mesh: tests/test_mesh_residency.py's mesh-streamed GLMix
# fit (its _glmix at n 2,400, d_global 96, 80 users x 4, LBFGS 6, two outer
# iterations, its budget rule) on MSTREAM_SHAPES; and
# tests/test_stochastic.py's stochastic lane on a data mesh (n 4,096, d 10,
# chunks of 1,024 rows, row multiple 8, 2 passes of 3 local epochs), which
# the JAX side runs on 8 x 1, the port on STOCH_MESHES
MSTREAM_SHAPES = ((2, 1), (2, 2))
MSTREAM_N, MSTREAM_DG, MSTREAM_USERS, MSTREAM_DU, MSTREAM_ITERS = 2400, 96, 80, 4, 6
STOCH_N, STOCH_D, STOCH_CHUNK, STOCH_MULTIPLE = 4096, 10, 1024, 8
STOCH_PASSES, STOCH_EPOCHS = 2, 3
STOCH_MESHES = ((2, 1), (4, 1))
STOCH_MERGES = ("sequential", "average")


# a bf16 design matrix: the monolithic mesh lane (fit_fixed_effect on
# BF16_SHAPE, LBFGS with L2; labels, weights and the solve in float64, x0's
# dtype) and the consensus-ADMM lane on BF16_ADMM_SHAPE, which raises in
# both packages (no bfloat16 eigh); a process of the `sparse` part
BF16_N, BF16_D, BF16_SEED, BF16_ITERATIONS = 601, 9, 13, 30
BF16_SHAPE, BF16_ADMM_SHAPE = (2, 1), (1, 2)


def bf16_mesh_problem(seed: int = BF16_SEED):
    """(x, y, w) in float64 (each side rounds x to bf16, to nearest even):
    an intercept column, logistic labels, weights; an odd n, so a rank's
    block has a padded row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BF16_N, BF16_D))
    x[:, 0] = 1.0
    beta = rng.normal(size=BF16_D) * 0.5
    y = (rng.uniform(size=BF16_N) < 1.0 / (1.0 + np.exp(-x @ beta))).astype(np.float64)
    return x, y, rng.uniform(0.5, 2.0, size=BF16_N)


def glmix_config_dict(factored: bool = False) -> dict:
    """Config 4's coordinates at GLMIX_ITERATIONS iterations; `factored`
    puts a factored random effect (latent dimension 2) after the fixed
    effect in place of the plain one."""
    d = side.glmix_config_dict()
    for c in d["coordinates"].values():
        c["optimization"]["optimizer"]["max_iterations"] = GLMIX_ITERATIONS
    d["coordinates"]["perUser"]["active_data_upper_bound"] = GLMIX_CAP
    if factored:
        opt = d["coordinates"]["fixed"]["optimization"]
        d["coordinates"]["perUserMF"] = {
            "kind": "factored_random_effect", "random_effect_type": "userId",
            "feature_shard": "per_user", "latent_dim": 2,
            "num_inner_iterations": 1, "active_data_upper_bound": GLMIX_CAP,
            "passive_data_lower_bound": None, "solver_schedule": None,
            "optimization": opt, "latent_optimization": dict(
                opt, regularization_weight=0.5)}
        del d["coordinates"]["perUser"]
        d["updating_sequence"] = ["fixed", "perUserMF"]
    return d


def glmix_data(build_game_dataset, make_movielens_like, movielens_shards):
    return side.movielens_glmix(build_game_dataset, make_movielens_like,
                                movielens_shards, n_rows=GLMIX_ROWS)


def sparse_data(build_game_dataset, make_yahoo_like):
    return side.yahoo_glmix(build_game_dataset, make_yahoo_like)


def sparse_config_dict() -> dict:
    d = side.yahoo_config_dict()
    for c in d["coordinates"].values():
        c["optimization"]["optimizer"]["max_iterations"] = GLMIX_ITERATIONS
    return d


def mstream_data(build_game_dataset):
    """tests/test_mesh_residency.py's _glmix(default_rng(7), n=2400,
    d_global=96, num_users=80, d_user=4): (train, validation), 90/10."""
    rng = np.random.default_rng(7)
    n = MSTREAM_N
    xg = rng.normal(size=(n, MSTREAM_DG)); xg[:, -1] = 1.0
    xu = rng.normal(size=(n, MSTREAM_DU)); xu[:, -1] = 1.0
    users = np.arange(n) % MSTREAM_USERS
    z = xg @ rng.normal(size=MSTREAM_DG) + np.einsum(
        "nd,nd->n", xu, rng.normal(size=(MSTREAM_USERS, MSTREAM_DU))[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    ds = build_game_dataset(y, {"global": xg, "per_user": xu},
                            entity_ids={"userId": np.asarray(
                                [f"u{u:03d}" for u in users])})
    rows = np.arange(n)
    cut = int(n * 0.9)
    return ds.subset(rows[:cut]), ds.subset(rows[cut:])


def mstream_config_dict(budget=None) -> dict:
    """tests/test_mesh_residency.py's _config(iters=6, budget=budget)."""
    opt = {"optimizer": {"optimizer": "lbfgs", "max_iterations": MSTREAM_ITERS},
           "regularization": {"type": "l2"}, "regularization_weight": 1.0}
    return {"task_type": "logistic_regression",
            "coordinates": {
                "fixed": {"kind": "fixed_effect", "feature_shard": "global",
                          "optimization": opt},
                "perUser": {"kind": "random_effect", "random_effect_type": "userId",
                            "feature_shard": "per_user", "projector": "identity",
                            "optimization": opt}},
            "updating_sequence": ["fixed", "perUser"],
            "num_outer_iterations": 2, "hbm_budget_bytes": budget}


def mstream_budget(acct: dict, data_devices: int) -> int:
    """The per-device budget of tests/test_mesh_residency.py (bench.py's
    _mesh_stream_leg rule) from a resident fit's accounting: 2.2 x (flat
    vectors + the random effects' blocks / D)."""
    re_b = sum(b for c, b in acct["resident_block_bytes"].items() if c != "fixed")
    return int((acct["flat_vector_bytes"] + -(-re_b // data_devices)) * 2.2)


def stoch_problem():
    """tests/test_stochastic.py's _problem(default_rng(7), n=4096, d=10)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(STOCH_N, STOCH_D))
    x[:, -1] = 1.0
    w = rng.normal(size=STOCH_D) * 0.5
    y = (rng.uniform(size=STOCH_N) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    return x, y


def admm_problem(loss: str, seed: int = 7):
    """bench.py's _admm_problem: Gaussian features with an intercept
    column, labels drawn from the loss's model."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ADMM_N, ADMM_D))
    x[:, -1] = 1.0
    w = rng.normal(size=ADMM_D) * 0.5
    z = x @ w
    if loss == "logistic":
        y = (rng.uniform(size=ADMM_N) < 1 / (1 + np.exp(-z))).astype(float)
    else:
        y = z + 0.1 * rng.normal(size=ADMM_N)
    return x, y


def mh_write_inputs(root: Path, build_game_dataset, save_game_dataset,
                    outer: int = MH_OUTER):
    """bench.py's _mh_write_inputs: data.npz and game-<outer>.json."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(MH_N, MH_D))
    w = rng.normal(size=MH_D)
    y = (rng.uniform(size=MH_N) < 1.0 / (1.0 + np.exp(-x @ w))).astype(np.float64)
    data = root / "data.npz"
    if not data.exists():
        save_game_dataset(build_game_dataset(y, {"global": x}), str(data))
    config = root / f"game-{outer}.json"
    config.write_text(json.dumps({
        "task_type": "logistic_regression",
        "coordinates": {"fixed": {
            "kind": "fixed_effect", "feature_shard": "global",
            "optimization": {"optimizer": {"optimizer": "lbfgs",
                                           "max_iterations": 3},
                             "regularization": {"type": "l2"},
                             "regularization_weight": 1.0}}},
        "updating_sequence": ["fixed"], "num_outer_iterations": outer}))
    return data, config


# -- the JAX runs -------------------------------------------------------------

def _fit_record(res) -> dict:
    coords = {}
    for name, m in res.model.coordinates.items():
        if hasattr(m, "glm"):
            coords[name] = np.asarray(m.glm.coefficients.means)
        elif hasattr(m, "latent_coefficients"):
            coords[name] = (np.asarray(m.latent_coefficients),
                            np.asarray(m.projection))
        else:
            coords[name] = np.asarray(m.coefficients)
    return {"history": list(res.objective_history),
            "validation": dict(res.descent.validation_history),
            "coefficients": coords}


def _run_mesh(out: dict, shape) -> None:
    import jax
    from photon_ml_tpu.data import build_game_dataset
    from photon_ml_tpu.data.synthetic_bench import (
        make_movielens_like, movielens_shards)
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.parallel import make_mesh
    mesh = lambda d, f: make_mesh(d, f, devices=jax.devices()[:d * f])
    train, val = glmix_data(build_game_dataset, make_movielens_like,
                            movielens_shards)
    for kind, factored in (("glmix", False), ("factored", True)):
        if shape not in {"glmix": MESH_SHAPES, "factored": FACTORED_SHAPES}[kind]:
            continue
        cfg = GameTrainingConfig.from_dict(glmix_config_dict(factored))
        res = GameEstimator(cfg, mesh=mesh(*shape)).fit(train, val, ["AUC"])
        out[(kind, shape)] = _fit_record(res)


def _run_sparse(out: dict, shape) -> None:
    import jax
    from photon_ml_tpu.data import build_game_dataset
    from photon_ml_tpu.data.synthetic_bench import make_yahoo_like
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.parallel import make_mesh
    train, val = sparse_data(build_game_dataset, make_yahoo_like)
    cfg = GameTrainingConfig.from_dict(sparse_config_dict())
    mesh = make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    res = GameEstimator(cfg, mesh=mesh).fit(train, val, ["AUC"])
    out[("sparse", shape)] = _fit_record(res)
    _run_bf16(out)


def _run_bf16(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from photon_ml_tpu.ops.losses import LOGISTIC
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.optim import (ADMMConfig, OptimizerConfig,
                                     RegularizationContext, RegularizationType)
    from photon_ml_tpu.parallel import make_mesh
    from photon_ml_tpu.parallel.fixed_effect import (fit_fixed_effect,
                                                     fit_fixed_effect_admm)
    x, y, w = bf16_mesh_problem()
    xb = x.astype(ml_dtypes.bfloat16)
    mesh = lambda d, f: make_mesh(d, f, devices=jax.devices()[:d * f])
    l2 = RegularizationContext(RegularizationType.L2)
    res = fit_fixed_effect(
        GLMObjective(LOGISTIC, jnp.asarray(xb), jnp.asarray(y), weights=jnp.asarray(w)),
        jnp.zeros(BF16_D), mesh(*BF16_SHAPE),
        OptimizerConfig(max_iterations=BF16_ITERATIONS, tolerance=1e-9), l2, 1.0,
        residency_key=("jax-bf16", BF16_SHAPE))
    k = int(res.iterations)
    out[("bf16", BF16_SHAPE)] = {"iterations": k, "x": np.asarray(res.x),
                                 "dtype": str(res.x.dtype), "reason": int(res.reason),
                                 "loss_history": np.asarray(res.loss_history)[:k + 1]}
    try:
        fit_fixed_effect_admm(GLMObjective(LOGISTIC, xb, y), np.zeros(BF16_D),
                              mesh(*BF16_ADMM_SHAPE), ADMMConfig(max_iterations=2),
                              reg=l2, reg_weight=1.0,
                              residency_key=("jax-bf16-admm", BF16_ADMM_SHAPE))
        out[("bf16_admm", BF16_ADMM_SHAPE)] = {"error": None}
    except Exception as e:  # noqa: BLE001 -- recorded for the test
        chain = []
        while e is not None:
            chain.append(f"{type(e).__name__}: {e}")
            e = e.__cause__
        out[("bf16_admm", BF16_ADMM_SHAPE)] = {"error": chain}


def _run_mstream(out: dict) -> None:
    """The mesh-streamed GLMix fit on MSTREAM_SHAPES (each with its own
    budget from the resident fit) and the stochastic lane on 8 x 1, both
    merges.  A shape the JAX package refuses records its error."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from photon_ml_tpu.data import build_game_dataset
    from photon_ml_tpu.data.streaming import ChunkPlan
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu.ops.losses import LOGISTIC
    from photon_ml_tpu.optim import StochasticPlan, solve_stochastic
    from photon_ml_tpu.parallel import make_mesh
    train, val = mstream_data(build_game_dataset)
    cfg = GameTrainingConfig.from_dict(mstream_config_dict())
    resident = GameEstimator(cfg).fit(train, val)
    out[("mstream", None)] = dict(_fit_record(resident),
                                  residency=resident.residency)
    for shape in MSTREAM_SHAPES:
        budget = mstream_budget(resident.residency, shape[0])
        mesh = make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
        try:
            res = GameEstimator(dataclasses.replace(cfg, hbm_budget_bytes=budget),
                                mesh=mesh).fit(train, val)
        except Exception as e:  # noqa: BLE001 -- recorded for the test
            out[("mstream", shape)] = {"error": f"{type(e).__name__}: {e}"}
            continue
        out[("mstream", shape)] = dict(_fit_record(res), budget=budget,
                                       residency=res.residency)
    x, y = stoch_problem()
    plan = lambda: ChunkPlan.build(STOCH_N, chunk_rows=STOCH_CHUNK,
                                   row_multiple=STOCH_MULTIPLE)
    for merge in STOCH_MERGES:
        splan = StochasticPlan(passes=STOCH_PASSES, local_epochs=STOCH_EPOCHS,
                               merge=merge)
        res = solve_stochastic(
            ChunkedGLMObjective(LOGISTIC, x, y, plan(), l2_weight=1.0,
                                mesh=make_mesh(8, 1)), jnp.zeros(STOCH_D), splan)
        out[("stoch", merge, (8, 1))] = {"loss_history": np.asarray(res.loss_history),
                                         "x": np.asarray(res.x)}


def _run_admm(out: dict) -> None:
    import jax
    from photon_ml_tpu.ops.losses import LOGISTIC, SQUARED
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.optim import (ADMMConfig, RegularizationContext,
                                     RegularizationType)
    from photon_ml_tpu.parallel import make_mesh
    from photon_ml_tpu.parallel.fixed_effect import fit_fixed_effect_admm
    losses = {"logistic": LOGISTIC, "squared": SQUARED}
    for case, (loss, reg, weight) in ADMM_CASES.items():
        x, y = admm_problem(loss)
        for shape in ADMM_SHAPES:
            mesh = make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
            res = fit_fixed_effect_admm(
                GLMObjective(losses[loss], x, y), np.zeros(ADMM_D), mesh,
                ADMMConfig(max_iterations=ADMM_ITERATIONS, tolerance=0.0,
                           polish=False),
                reg=RegularizationContext(RegularizationType(reg)),
                reg_weight=weight, residency_key=("jax-admm", case, shape))
            k = int(res.iterations)
            out[(case, shape)] = {
                "iterations": k, "x": np.asarray(res.x),
                "loss_history": np.asarray(res.loss_history)[:k + 1],
                "gnorm_history": np.asarray(res.gnorm_history)[:k + 1]}


def _jax_cli(root: Path, data, config, out_dir: Path, extra=()) -> list:
    return [sys.executable, "-m", "photon_ml_tpu.cli.train", "--train-data",
            str(data), "--config", str(config), "--x64", "--no-compile-cache",
            "--checkpoint-dir", str(out_dir / "ckpt"), "--output-dir",
            str(out_dir), *extra]


def _jax_env(devices: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    for k in ("PHOTON_COORDINATOR", "PHOTON_NUM_PROCESSES", "PHOTON_PROCESS_ID"):
        env.pop(k, None)
    return env


def _state(ckpt: Path) -> dict:
    with open(ckpt / "state.json") as f:
        return json.load(f)


def _run_multihost(out: dict, root: Path) -> None:
    """The JAX pair writes a MH_SHORT-iteration checkpoint (process 0
    owns it); one JAX process resumes the port pair's MH_SHORT-iteration
    checkpoint to MH_OUTER iterations."""
    from photon_ml_tpu.data import build_game_dataset
    from photon_ml_tpu.data.game_data import save_game_dataset
    import socket
    data, config = mh_write_inputs(root, build_game_dataset, save_game_dataset)
    _, short = mh_write_inputs(root, build_game_dataset, save_game_dataset,
                               MH_SHORT)
    pair = root / "jax_pair"
    shutil.rmtree(pair, ignore_errors=True)
    pair.mkdir()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        _jax_cli(root, data, short, pair, (
            "--mesh", "auto", "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--process-id", str(pid))),
        cwd=ROOT, env=_jax_env(1), stdout=subprocess.DEVNULL,
        stderr=open(pair / f"err{pid}.txt", "w")) for pid in (0, 1)]
    # the resume of the port pair's record runs beside the JAX pair
    resumed = root / "jax_resume"
    shutil.rmtree(resumed, ignore_errors=True)
    shutil.copytree(root / "port_pair", resumed)
    proc = subprocess.Popen(_jax_cli(root, data, config, resumed, ("--mesh", "none")),
                            cwd=ROOT, env=_jax_env(1), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    codes = [p.wait(timeout=300) for p in procs]
    out["jax_pair_codes"] = codes
    out["jax_pair_state"] = _state(pair / "ckpt") if codes == [0, 0] else None
    _, err = proc.communicate(timeout=300)
    out["jax_resume_code"] = proc.returncode
    out["jax_resume_state"] = (_state(resumed / "ckpt")
                               if proc.returncode == 0 else err[-3000:])


def _parts(mode: str) -> list:
    """The processes of a mode: for `mesh`, one per mesh shape and one
    for the sparse fixed effect."""
    if mode == "mesh":
        return ([["mesh", f"{d}x{f}"] for d, f in MESH_SHAPES]
                + [["sparse", "x".join(map(str, SPARSE_SHAPE))], ["mstream"]])
    return [[mode]]


def run_jax_side(mode: str, root: Path) -> list:
    """Start this script's processes for `mode` (the caller waits with
    `read_results`)."""
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), *part, str(root)],
        cwd=ROOT, env=_jax_env(8), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part in _parts(mode)]


def read_results(procs: list, mode: str, root: Path) -> dict:
    """Every process's results, merged."""
    out = {}
    for proc, part in zip(procs, _parts(mode)):
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the JAX side failed:\n{err[-4000:]}")
        with open(root / f"{'-'.join(part)}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


def main(argv) -> int:
    part, root = argv[1:-1], Path(argv[-1])
    mode = part[0]
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except AttributeError:
        pass
    jax.config.update("jax_enable_x64", True)
    out: dict = {}
    if mode == "multihost":
        _run_multihost(out, root)
    elif mode in ("mesh", "sparse"):
        d, f = part[1].split("x")
        (_run_mesh if mode == "mesh" else _run_sparse)(out, (int(d), int(f)))
    elif mode == "mstream":
        _run_mstream(out)
    else:
        _run_admm(out)
    with open(root / f"{'-'.join(part)}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
