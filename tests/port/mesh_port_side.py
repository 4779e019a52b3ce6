"""The port side of the mesh and ADMM parity tests (test_torch_mesh.py,
test_torch_mesh_streaming.py, test_torch_admm.py): one rank of a gloo
group on the CPU, float64.

    python tests/port/mesh_port_side.py mesh|mstream|admm ROOT RANK WORLD PORT

The test module starts WORLD of these at once (`start_ranks`); every rank
joins the group at 127.0.0.1:PORT, runs every scenario of its mode on the
meshes of mesh_jax_side.py (a mesh narrower than the world is made over
its first ranks, the others skip it) and writes its results to
ROOT/port_<mode>_<RANK>.pkl, so the test can hold the ranks equal to each
other as well as to the JAX package.  `mesh` runs the streaming-over-a-mesh
scenarios (`mstream`) last; `mesh_results` runs the mode once per test
process for the two modules that read it.
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
                    "iterations": t.iterations, "stream": t.stream}
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
    _run_bf16(out)
    _run_mstream(out, rank)


def _run_bf16(out: dict) -> None:
    """A bf16 X on the monolithic mesh lane (ranks 0-1 of the group) and on
    the ADMM lane, which raises on every rank before any collective."""
    import torch
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim.admm import ADMMConfig
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType)
    from photon_ml_tpu_torch.parallel import make_mesh
    from photon_ml_tpu_torch.parallel.fixed_effect import (
        fit_fixed_effect, fit_fixed_effect_admm)
    x, y, w = mj.bf16_mesh_problem()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    f64 = lambda a: torch.from_numpy(a)
    l2 = RegularizationContext(RegularizationType.L2)
    mesh = make_mesh(*mj.BF16_SHAPE, device="cpu", ranks=[0, 1])
    if mesh is not None:
        calls0 = mesh.stats.snapshot()
        res = fit_fixed_effect(
            GLMObjective(LOGISTIC, xb, f64(y), weights=f64(w)),
            torch.zeros(mj.BF16_D, dtype=torch.float64), mesh,
            OptimizerConfig(max_iterations=mj.BF16_ITERATIONS, tolerance=1e-9), l2, 1.0,
            residency_key=("port-bf16", mj.BF16_SHAPE))
        k = res.iterations
        from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
        staged = default_residency().stage_static(("port-bf16", mj.BF16_SHAPE), "rows",
                                                  mesh, xb, 0.0, dtype=torch.float64)
        out[("bf16", mj.BF16_SHAPE)] = {
            "iterations": k, "x": res.x.numpy(), "dtype": str(res.x.dtype),
            "reason": int(res.reason), "loss_history": res.loss_history[:k + 1].numpy(),
            "staged_dtype": str(staged.dtype), "staged_rows": staged.shape[0],
            "collectives": mesh.stats.delta(calls0, mesh.stats.snapshot())}
    mesh = make_mesh(*mj.BF16_ADMM_SHAPE, device="cpu", ranks=[0, 1])
    if mesh is not None:
        try:
            fit_fixed_effect_admm(GLMObjective(LOGISTIC, xb, f64(y)),
                                  torch.zeros(mj.BF16_D, dtype=torch.float64), mesh,
                                  ADMMConfig(max_iterations=2), reg=l2, reg_weight=1.0,
                                  residency_key=("port-bf16-admm", mj.BF16_ADMM_SHAPE))
            out[("bf16_admm", mj.BF16_ADMM_SHAPE)] = {"error": None}
        except NotImplementedError as e:
            out[("bf16_admm", mj.BF16_ADMM_SHAPE)] = {"error": [str(e)]}


def _stream_bytes_per_pass(plan, train, mesh) -> int:
    """Bytes one value+gradient pass stages on this rank over `plan`
    (the fixed effect's leaves), with `mesh` or alone."""
    import torch
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    obj = ChunkedGLMObjective(LOGISTIC, train.feature_shards["global"],
                              train.response, plan, mesh=mesh, device="cpu",
                              dtype=torch.float64)
    obj.value_and_gradient(torch.zeros(obj.dim, dtype=torch.float64))
    return obj.stats.total_bytes


def _run_mstream(out: dict, rank: int) -> None:
    """Streaming over a mesh: the mesh-streamed GLMix fit on
    mj.MSTREAM_SHAPES (and 1 x 1 against the streamed fit without a mesh,
    on rank 0), and the stochastic lane on mj.STOCH_MESHES, both merges."""
    import dataclasses
    import torch
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.data.streaming import ChunkPlan
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu_torch.ops.chunked import ChunkedGLMObjective
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.schedule import StochasticPlan
    from photon_ml_tpu_torch.optim.stochastic import solve_stochastic
    from photon_ml_tpu_torch.parallel import make_mesh
    f64 = torch.float64
    mesh_of = lambda shape: make_mesh(*shape, device="cpu",
                                      ranks=list(range(shape[0] * shape[1])))
    train, val = mj.mstream_data(build_game_dataset)
    cfg = GameTrainingConfig.from_dict(mj.mstream_config_dict())
    # every rank needs the budgets: each fits the resident reference
    resident = GameEstimator(cfg, device="cpu", dtype=f64).fit(train, val)
    if rank == 0:
        out[("mstream", None)] = dict(_record(resident),
                                      residency=resident.residency)
    streamed = lambda budget: dataclasses.replace(cfg, hbm_budget_bytes=budget)
    for shape in mj.MSTREAM_SHAPES + ((1, 1),):
        mesh = mesh_of(shape)
        if mesh is None:
            out[("mstream", shape)] = None
            continue
        D = shape[0]
        budget = mj.mstream_budget(resident.residency, D)
        calls0 = mesh.stats.snapshot()
        res = GameEstimator(streamed(budget), dtype=f64, mesh=mesh).fit(train, val)
        rec = dict(_record(res), budget=budget, residency=res.residency,
                   collectives=mesh.stats.delta(calls0, mesh.stats.snapshot()))
        # the fixed effect's plan (game/coordinates.py's rule): one pass on
        # this rank's blocks against one pass of a single rank over it
        plan = ChunkPlan.build(train.num_rows, hbm_budget_bytes=(budget // 2) * D,
                               bytes_per_row=(mj.MSTREAM_DG + 4) * 8,
                               row_multiple=D)
        rec["pass_bytes"] = (_stream_bytes_per_pass(plan, train, mesh),
                             _stream_bytes_per_pass(plan, train, None))
        rec["plan"] = (plan.num_chunks, plan.chunk_rows)
        out[("mstream", shape)] = rec
    if rank == 0:
        # the streamed fit without a mesh, at the 1 x 1 mesh's budget
        budget = mj.mstream_budget(resident.residency, 1)
        out[("mstream", "none")] = _record(GameEstimator(
            streamed(budget), device="cpu", dtype=f64).fit(train, val))
    x, y = mj.stoch_problem()
    plan = ChunkPlan.build(mj.STOCH_N, chunk_rows=mj.STOCH_CHUNK,
                           row_multiple=mj.STOCH_MULTIPLE)
    for merge in mj.STOCH_MERGES:
        splan = StochasticPlan(passes=mj.STOCH_PASSES,
                               local_epochs=mj.STOCH_EPOCHS, merge=merge)
        for shape in mj.STOCH_MESHES:
            mesh = mesh_of(shape)
            if mesh is None:
                out[("stoch", merge, shape)] = None
                continue
            obj = ChunkedGLMObjective(LOGISTIC, x, y, plan, l2_weight=1.0,
                                      mesh=mesh, device="cpu", dtype=f64)
            calls0 = mesh.stats.snapshot()
            res = solve_stochastic(obj, torch.zeros(mj.STOCH_D, dtype=f64), splan)
            out[("stoch", merge, shape)] = {
                "loss_history": res.loss_history.numpy(), "x": res.x.numpy(),
                "chunks": plan.num_chunks,
                "collectives": mesh.stats.delta(calls0, mesh.stats.snapshot())}


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


_MESH_RESULTS: dict = {}


def mesh_results(tmp_path_factory) -> tuple:
    """(the JAX side's results, each port rank's) of the `mesh` mode: the
    JAX processes and the four ranks start together, once per test
    process, shared by test_torch_mesh.py and
    test_torch_mesh_streaming.py."""
    if not _MESH_RESULTS:
        root = tmp_path_factory.mktemp("mesh")
        jax_procs = mj.run_jax_side("mesh", root)
        port = read_ranks(start_ranks("mesh", root), "mesh", root)
        _MESH_RESULTS["results"] = (mj.read_results(jax_procs, "mesh", root), port)
    return _MESH_RESULTS["results"]


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
        {"mesh": _run_mesh, "mstream": _run_mstream,
         "admm": _run_admm}[mode](out, rank)
    finally:
        multihost.shutdown()
    with open(root / f"port_{mode}_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
