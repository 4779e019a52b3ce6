"""The port side of the mesh and ADMM parity tests (test_torch_mesh.py,
test_torch_admm.py): one rank of a gloo group on the CPU, float64.

    python tests/port/mesh_port_side.py mesh|admm ROOT RANK WORLD PORT

The test module starts WORLD of these at once (`start_ranks`); every rank
joins the group at 127.0.0.1:PORT, runs every scenario of its mode on the
meshes of mesh_jax_side.py (a mesh narrower than the world is made over
its first ranks, the others skip it) and writes its results to
ROOT/port_<mode>_<RANK>.pkl, so the test can hold the ranks equal to each
other as well as to the JAX package.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import mesh_jax_side as mj

ROOT = Path(__file__).resolve().parents[2]
WORLD = 4


def _record(res) -> dict:
    coords = {}
    for name, m in res.model.coordinates.items():
        if hasattr(m, "glm"):
            coords[name] = m.glm.coefficients.means.numpy()
        elif hasattr(m, "latent_coefficients"):
            coords[name] = (m.latent_coefficients.numpy(), m.projection.numpy())
        else:
            coords[name] = m.coefficients.numpy()
    trackers = {k: {"staged": t.staged_bytes, "fg_count": t.fg_count,
                    "iterations": t.iterations}
                for k, t in res.descent.trackers.items()}
    return {"history": list(res.objective_history),
            "validation": dict(res.descent.validation_history),
            "coefficients": coords, "trackers": trackers,
            "mesh_transfer": res.mesh_transfer}


def _warm_bounds(est, train, mesh):
    """bench.py's _warm_operand_bound for THIS rank: the coefficients and
    residual offsets of its blocks (f64), with 50 % slack; and each
    entity-keyed coordinate's bucket count."""
    D, item = mesh.num_data, 8
    per_rank = lambda v: -(-int(v) // D)
    bounds, buckets = {}, {}
    for name, c in est._build_coordinates(train).items():
        if hasattr(c, "red"):
            cells = sum(per_rank(b.num_entities) * (b.samples_per_entity + b.dim)
                        for b in c.red.buckets)
            buckets[name] = len(c.red.buckets)
        else:
            cells = per_rank(train.num_rows) + c.dim
        bounds[name] = int(cells * item * 1.5)
    return bounds, buckets


def _run_mesh(out: dict, rank: int) -> None:
    import torch
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.data.synthetic_bench import (
        make_movielens_like, make_yahoo_like, movielens_shards)
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu_torch.parallel import make_mesh
    f64 = torch.float64

    def fit(cfg, shape, train, val, bounds=False):
        mesh = make_mesh(*shape, device="cpu",
                         ranks=list(range(shape[0] * shape[1])))
        if mesh is None:
            return None
        est = GameEstimator(cfg, dtype=f64, mesh=mesh)
        t0 = time.perf_counter()
        calls0 = mesh.stats.snapshot()
        rec = _record(est.fit(train, val, ["AUC"]))
        rec["seconds"] = time.perf_counter() - t0
        rec["collectives"] = mesh.stats.delta(calls0, mesh.stats.snapshot())
        if bounds:
            rec["warm_bounds"], rec["buckets"] = _warm_bounds(est, train, mesh)
        return rec

    train, val = mj.glmix_data(build_game_dataset, make_movielens_like,
                               movielens_shards)
    for factored, shapes in ((False, mj.MESH_SHAPES), (True, mj.FACTORED_SHAPES)):
        cfg = GameTrainingConfig.from_dict(mj.glmix_config_dict(factored))
        kind = "factored" if factored else "glmix"
        for shape in shapes:
            out[(kind, shape)] = fit(cfg, shape, train, val, bounds=not factored)
        if rank == 0:
            out[(kind, None)] = _record(GameEstimator(cfg, device="cpu", dtype=f64)
                                        .fit(train, val, ["AUC"]))
    strain, sval = mj.sparse_data(build_game_dataset, make_yahoo_like)
    scfg = GameTrainingConfig.from_dict(mj.sparse_config_dict())
    out[("sparse", mj.SPARSE_SHAPE)] = fit(scfg, mj.SPARSE_SHAPE, strain, sval)
    if rank == 0:
        out[("sparse", None)] = _record(GameEstimator(scfg, device="cpu", dtype=f64)
                                        .fit(strain, sval, ["AUC"]))
    # mesh 1 x 1 against no mesh, on rank 0 alone
    cfg = GameTrainingConfig.from_dict(mj.glmix_config_dict())
    out[("glmix", (1, 1))] = fit(cfg, (1, 1), train, val)


def _run_admm(out: dict, rank: int) -> None:
    import torch
    from photon_ml_tpu_torch.ops.losses import LOGISTIC, SQUARED
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim.admm import ADMMConfig
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType, solve)
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.parallel.fixed_effect import fit_fixed_effect_admm
    losses = {"logistic": LOGISTIC, "squared": SQUARED}
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)

    def run(case, shape, config, key):
        loss, reg, weight = mj.ADMM_CASES[case]
        x, y = mj.admm_problem(loss)
        mesh = make_mesh(*shape, device="cpu",
                         ranks=list(range(shape[0] * shape[1])))
        if mesh is None:
            return None
        calls0 = mesh.stats.snapshot()
        res = fit_fixed_effect_admm(
            GLMObjective(losses[loss], x, f64(y)), torch.zeros(mj.ADMM_D, dtype=torch.float64),
            mesh, config, reg=RegularizationContext(RegularizationType(reg)),
            reg_weight=weight, residency_key=key)
        k = res.iterations
        return {"iterations": k, "x": res.x.numpy(),
                "loss_history": res.loss_history[:k + 1].numpy(),
                "gnorm_history": res.gnorm_history[:k + 1].numpy(),
                "collectives": mesh.stats.delta(calls0, mesh.stats.snapshot()),
                "n_local": mesh.block(mj.ADMM_N)[1] - mesh.block(mj.ADMM_N)[0],
                "block_width": -(-mj.ADMM_D // mesh.num_feature)}

    fixed = ADMMConfig(max_iterations=mj.ADMM_ITERATIONS, tolerance=0.0,
                       polish=False)
    for case in mj.ADMM_CASES:
        for shape in mj.ADMM_SHAPES:
            out[("fixed", case, shape)] = run(case, shape, fixed,
                                              ("port-admm", case, shape))
    # converged solves against the monolithic host-stepped solver
    converged = ADMMConfig(max_iterations=800, tolerance=1e-10, polish=False)
    for case in mj.ADMM_CASES:
        out[("converged", case)] = run(case, (2, 2), converged,
                                       ("port-admm-converged", case))
        if rank == 0:
            loss, reg, weight = mj.ADMM_CASES[case]
            x, y = mj.admm_problem(loss)
            mono = solve(GLMObjective(losses[loss], f64(x), f64(y)),
                         torch.zeros(mj.ADMM_D, dtype=torch.float64),
                         OptimizerConfig(max_iterations=500, tolerance=1e-12),
                         RegularizationContext(RegularizationType(reg)), weight)
            out[("monolithic", case)] = mono.x.numpy()


def start_ranks(mode: str, root: Path, world: int = WORLD) -> list:
    """Start the `world` ranks of `mode` (the caller waits with
    `read_ranks`)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), mode, str(root),
         str(r), str(world), str(port)], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def read_ranks(procs: list, mode: str, root: Path) -> list:
    errs = [p.communicate(timeout=600)[1] for p in procs]
    bad = [(r, p.returncode, e[-3000:]) for r, (p, e) in enumerate(zip(procs, errs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"port ranks failed: {bad}")
    out = []
    for r in range(len(procs)):
        with open(root / f"port_{mode}_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv) -> int:
    mode, root, rank, world, port = (argv[1], Path(argv[2]), int(argv[3]),
                                     int(argv[4]), int(argv[5]))
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from photon_ml_tpu_torch.parallel import multihost
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                         timeout_s=120)
    out: dict = {}
    try:
        {"mesh": _run_mesh, "admm": _run_admm}[mode](out, rank)
    finally:
        multihost.shutdown()
    with open(root / f"port_{mode}_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
