"""The JAX side of the mesh, multi-process and ADMM parity tests
(test_torch_mesh.py, test_torch_multihost.py, test_torch_admm.py), run in
a subprocess of its own, one per test module, with JAX on the CPU in
float64 over 8 virtual devices:

    python tests/port/mesh_jax_side.py mesh DxF|sparse DxF|multihost|admm ROOT

`mesh DxF` fits the GLMix problem below through the JAX package's
GameEstimator on that mesh, then the fixed effect with a factored random
effect (one process per mesh shape, so their compiles run side by side);
`sparse DxF` fits the sparse fixed effect on that mesh (the JAX package
drops the column view there, the port keeps one per shard); `admm` runs
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
                + [["sparse", "x".join(map(str, SPARSE_SHAPE))]])
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
    else:
        _run_admm(out)
    with open(root / f"{'-'.join(part)}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
