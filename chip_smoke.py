#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (photon_ml_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON object per line on stdout:
  1. device: the card's name, and name + power limit from nvidia-smi;
  2. build: every CUDA kernel of the port, compiled from csrc/ with nvcc;
  3. checks: each kernel against its plain PyTorch version on the card,
     for all four losses, plain and with weights+offsets, at the small
     shapes SMALL (ragged widths, a view whose base is not 16-byte
     aligned, n = 1 and 3, d = 2048 and D_MAX) and at the a1a config's
     full [1,643,520 x 124], and for logistic at [200,000 x 2048] (the
     Pallas kernel's second measured shape); tolerances rtol 1e-5 on the
     value and rtol 1e-4 (atol 1e-4) on the gradient, in float32;
  4. timing at the full size and at [200,000 x 2048]: median over REPS
     reps of CUDA-event times of 10 back-to-back calls, each with a
     perturbed coefficient vector, enqueued behind a sleep kernel so that
     only device time counts, for the kernel, its plain version and the
     library call (two torch.mv products), with the bound, the share of it
     the kernel reaches (hbm_share) and kernel / library;
  5. main path: train_glm on make_a1a_like(1024, "logistic", seed=42) in
     float32 on cuda, L2 lambda=1, LBFGS(max_iterations=100, tol=1e-9);
     kernel launches during the solve must equal its fg_count, and the
     float64 objective of the solution must be within 1e-5 relative of the
     scipy reference optimum stored in bench_ref_cache.json; then a second,
     warm solve (not counted) for the steady-state solve time;
  6. profile: the main path once more under torch.profiler, for the
     device's busy and idle time and the largest device and host items;
     the kernel must show one device launch per value+gradient pass;
  7. glmix: BASELINE config 4 at full size through GameEstimator.fit on
     cuda in float32: make_movielens_like("1m", seed=11, 1,000,209 rows),
     95/5 split, a fixed effect on "global" (d = 31) and a per-user random
     effect on "per_user" (d = 19, cap 512), LBFGS(100) with L2 lambda 1,
     two outer iterations, validation AUC.  Kernel launches during the fit
     must equal the fixed-effect solves' summed fg_count, and the final
     objective must be within 1e-4 relative of the float64 reference in
     bench_ref_cache.json; prints the fit wall, examples/s, the spans, each
     random-effect bucket's [E, S, d], iterations and solve time;
  8. glmix warm: the same fit again (blocks memoized), for the steady
     state and to see that it repeats bit for bit; then the kernel against
     its plain version and timed at the fixed effect's shape with the
     residual scores as offsets;
  9. glmix profile: one outer iteration under torch.profiler (device idle
     share, kernel time, the largest items);
 10. the kernels line, nvidia-smi's line, and the final result line.
Exits non-zero, before printing any result, when CUDA is absent or when
the port's package is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REF_KEY = ("scipy:logistic_regression:seed42:1643520x124:l1=0.0:l2=1.0:"
           "box=None:fp=g2-2b97329fcd05d34d")
# BASELINE config 4 (bench.py: _game_setup, bench_config4) and its float64
# reference objective
GLMIX_REF_KEY = "1m:1000209:11:glmix:v=g2"
GLMIX_ROWS, GLMIX_SEED, GLMIX_OUTER = 1_000_209, 11, 2
GLMIX_RTOL = 1e-4
LAMBDA = 1.0
REPS = 30
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-4
NLL_RTOL = 1e-5
# ~5 ms at the H100's clock: longer than the host takes to enqueue one rep
SLEEP_CYCLES = 10_000_000
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# (name, n, d, rows skipped at the front of a contiguous [n + skip, d] X)
SMALL = (("700x37", 700, 37, 0), ("700x37_misaligned", 700, 37, 1),
         ("3x124", 3, 124, 0), ("1x37", 1, 37, 0), ("20000x2048", 20_000, 2048, 0),
         ("64xD_MAX", 64, None, 0))
WIDE = (200_000, 2048)
DESIGN = ("persistent grid (one block per SM, ~48 KB row tiles dealt out in turn); "
          "ring of cp.async.bulk (TMA) stages with full/empty mbarriers fed by "
          "one producer thread; margins and gradient from shared memory, "
          "gradient in registers; one launch per pass (ticketed last-block sum)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """[(entry function, registers, spill bytes, static smem bytes)] from
    nvcc's -Xptxas -v report."""
    return re.findall(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers.*?(\d+) bytes smem", log, re.S)


def cuda_ms(fn) -> float:
    """Device ms of what fn() enqueues.  A sleep kernel goes first, so the
    host enqueues all of fn's launches while the device sleeps and the
    events time them back to back: the host's own time per call (the
    wrapper's checks, the ctypes call) does not count, even where it is
    longer than a short kernel."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def compare(hk, loss, x, y, c, w, o):
    """Kernel vs plain on the same inputs -> (ok, max abs err, value's
    relative error, largest gradient error over its tolerance)."""
    import torch
    v_k, g_k = hk.fused_value_and_gradient(loss, x, y, c, w, o)
    v_p, g_p = hk.fused_value_and_gradient_plain(loss, x, y, c, w, o)
    torch.cuda.synchronize()
    v_k, v_p = v_k.item(), v_p.item()
    g_k, g_p = g_k.double().cpu().numpy(), g_p.double().cpu().numpy()
    v_err = abs(v_k - v_p)
    g_err = np.abs(g_k - g_p)
    ok = (np.isfinite(v_k) and np.all(np.isfinite(g_k))
          and v_err <= VALUE_RTOL * abs(v_p)
          and bool(np.all(g_err <= GRAD_ATOL + GRAD_RTOL * np.abs(g_p))))
    return ok, max(v_err, float(g_err.max())), v_err / max(abs(v_p), 1e-30), \
        float((g_err / (GRAD_ATOL + GRAD_RTOL * np.abs(g_p))).max())


def wide(d: int) -> bool:
    """Above d = 124 the check data is shaped like a1a's: features >= 0
    (uniform), 25 % positive labels, coefficients N(0, 0.09 / d).  With
    centred features and balanced labels some gradient elements cancel to
    near zero, and no f32 sum of 10^4-10^5 O(1) terms, in any order, is
    within atol 1e-4 of the exact one."""
    return d > 124


def run_checks(hk, losses, x_full, y_full, x_wide, y_wide, seed=0):
    """All four losses x {plain, w+o} at the SMALL shapes and the full
    shape; logistic x {plain, w+o} at the WIDE shape.  Returns the largest
    abs error at the full shape."""
    import torch
    rng = np.random.default_rng(seed)
    cases = []
    for name, n, d, skip in SMALL:
        d = d or hk.D_MAX
        m = n + skip
        x = rng.uniform(size=(m, d)) if wide(d) else rng.normal(size=(m, d))
        x = torch.from_numpy(x.astype(np.float32)).cuda()[skip:]
        y = rng.uniform(size=m) < (0.25 if wide(d) else 0.5)
        y = torch.from_numpy(y.astype(np.float32)).cuda()[skip:]
        cases.append((name, x, y, losses, skip))
    cases.append(("full", x_full, y_full, losses, 0))
    cases.append(("200000x2048", x_wide, y_wide, losses[:1], 0))
    full_err = 0.0
    failures = []
    for size, x, y, case_losses, skip in cases:
        n, d = x.shape
        if skip and x.data_ptr() % 16 == 0:
            raise SystemExit(f"{size}: the view's base is 16-byte aligned")
        scale = 0.3 * d ** -0.5 if wide(d) else 0.1
        c = torch.from_numpy((rng.normal(size=d) * scale).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.uniform(0.5, 2.0, size=n + skip).astype(np.float32)).cuda()[skip:]
        o = torch.from_numpy((rng.normal(size=n + skip) * 0.1).astype(np.float32)).cuda()[skip:]
        for loss in case_losses:
            for tag, ww, oo in (("plain", None, None), ("w+o", w, o)):
                ok, abs_err, v_rel, g_rel = compare(hk, loss, x, y, c, ww, oo)
                emit({"phase": "check", "size": size, "loss": loss.name,
                      "inputs": tag, "ok": ok, "max_abs_err": abs_err,
                      "value_rel_err": v_rel, "grad_err_over_tol": g_rel})
                if not ok:
                    failures.append(f"{size}/{loss.name}/{tag}")
                if size == "full":
                    full_err = max(full_err, abs_err)
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return full_err


def time_full(hk, loss, x, y, o=None):
    """Median over REPS reps of the mean ms per call of the kernel, its
    plain version and the library call, in turns.  A rep is `batch` calls
    back to back between two CUDA events, behind a sleep kernel (so the
    host's enqueue time does not count), each call with its own perturbed
    coefficients.  `o`: the offsets, passed to all three."""
    import torch
    n, d = x.shape
    base = torch.linspace(-0.1, 0.1, d, device="cuda", dtype=torch.float32)
    u = torch.linspace(-1.0, 1.0, n, device="cuda", dtype=torch.float32)
    batch = 10
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    calls = {
        "ms": lambda c: hk.fused_value_and_gradient(loss, x, y, c, None, o),
        "plain_ms": lambda c: hk.fused_value_and_gradient_plain(loss, x, y, c, None, o),
        "library_ms": lambda c: (torch.mv(x, c) if o is None else torch.addmv(o, x, c),
                                 torch.mv(x.T, u)),
    }
    for r in range(REPS + 2):  # the first two rounds warm up
        cs = [base + 1e-6 * (r * batch + i + 1) for i in range(batch)]
        for key, call in calls.items():
            ms = cuda_ms(lambda: [call(c) for c in cs]) / batch
            if r >= 2:
                times[key].append(ms)
    med = {k: statistics.median(v) for k, v in times.items()}
    # least the card could take: read X, y (o) and c once, write value+grad
    # once; 4*n*d flops (margin and gradient multiply-adds) at the f32 peak
    nbytes = 4 * (n * d + n + d + d + 1 + (0 if o is None else n))
    flops = 4 * n * d
    bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_F32_FLOPS * 1e3
    med["bound_ms"] = max(bound_bytes_ms, bound_ops_ms)
    med["bound_by"] = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    med["min_ms"] = min(times["ms"])
    med["max_ms"] = max(times["ms"])
    med["hbm_share"] = med["bound_ms"] / med["ms"]
    med["ms_over_library"] = med["ms"] / med["library_ms"]
    return med


def profile_call(fn):
    """Run fn() once under torch.profiler -> (its result, where the time
    went).  Device busy time is the sum of the kernels' device times (one
    stream, so they do not overlap); the rest of the wall clock the device
    sits idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    fused = [e for e in dev if "fvg_" in e.key]
    top = lambda evs, attr: [
        {"name": e.key[:80], "count": e.count, "ms": getattr(e, attr) / 1e3}
        for e in sorted(evs, key=lambda e: -getattr(e, attr))[:8]]
    return out, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": sum(e.count for e in dev),
        "fused_kernel_ms": sum(e.self_device_time_total for e in fused) / 1e3,
        "fused_kernel_launches": sum(e.count for e in fused),
        "device_top": top(dev, "self_device_time_total"),
        "host_top": top(cpu, "self_cpu_time_total")}


def profile_run(train) -> dict:
    """Where the main path's time goes: one more run of it under
    torch.profiler (its launches are not the counted run's)."""
    trained, stats = profile_call(train)
    return {"fg_count": trained[0].result.fg_count, **stats}


def host_objective(x, y, w, lam) -> float:
    """float64 sum softplus(-yy*z) + lam/2 |w|^2 on the host (bench.py's
    np_objective_value for the logistic task)."""
    w = np.asarray(w, np.float64)
    total = 0.0
    step = 1 << 18
    for i in range(0, x.shape[0], step):
        z = x[i:i + step].astype(np.float64) @ w
        yy = np.where(y[i:i + step] > 0.5, 1.0, -1.0)
        total += float(np.logaddexp(0.0, -yy * z).sum())
    return total + 0.5 * lam * float(w @ w)


def glmix_setup():
    """Config 4's (train, validation, config) as bench.py's _game_setup
    builds them for its float32 run."""
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinateConfig, GameTrainingConfig, GLMOptimizationConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType,
    )
    ml = make_movielens_like("1m", seed=GLMIX_SEED, n_rows=GLMIX_ROWS)
    shards = {k: v.astype(np.float32) for k, v in movielens_shards(ml).items()
              if k != "per_item"}
    ds = build_game_dataset(ml.response.astype(np.float32), shards,
                            entity_ids={"userId": ml.user_ids})
    rng = np.random.default_rng(GLMIX_SEED + 99)
    val_mask = rng.uniform(size=ds.num_rows) < 0.05
    train = ds.subset(np.flatnonzero(~val_mask))
    val = ds.subset(np.flatnonzero(val_mask))
    opt = GLMOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=100),
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1.0)
    cfg = GameTrainingConfig(
        task_type="logistic_regression",
        coordinates={"fixed": FixedEffectCoordinateConfig("global", opt),
                     "perUser": RandomEffectCoordinateConfig(
                         "userId", "per_user", opt, active_data_upper_bound=512)},
        updating_sequence=["fixed", "perUser"],
        num_outer_iterations=GLMIX_OUTER, seed=GLMIX_SEED)
    return train, val, cfg


def fe_passes(descent) -> int:
    """Value+gradient passes of the fit's fixed-effect solves."""
    return sum(t.fg_count for k, t in descent.trackers.items()
               if k.endswith("/fixed"))


def glmix_report(result, fit_s, n_train, launches, ref_nll) -> dict:
    """The glmix phase's line: the fit's numbers and its checks."""
    import torch
    d = result.descent
    final = float(d.objective_history[-1])
    model = d.model.coordinates
    finite = (len(d.objective_history) == 2 * GLMIX_OUTER
              and all(np.isfinite(d.objective_history))
              and tuple(model["fixed"].glm.coefficients.means.shape) == (31,)
              and model["perUser"].coefficients.shape[1] == 19
              and bool(torch.isfinite(model["fixed"].glm.coefficients.means).all())
              and bool(torch.isfinite(model["perUser"].coefficients).all()))
    return {
        "n_train": n_train, "outer_iterations": GLMIX_OUTER, "fit_s": fit_s,
        "examples_per_s": n_train * GLMIX_OUTER / fit_s,
        "objective_history": d.objective_history, "final_objective": final,
        "ref_nll": ref_nll, "nll_rel_gap": (final - ref_nll) / abs(ref_nll),
        "validation_auc": result.validation["AUC"],
        "auc_history": d.validation_history["AUC"],
        "kernel_launches": launches, "fe_fg_count": fe_passes(d),
        "finite": finite,
        "spans_s": dict(d.timings), "host_blocked_s": d.timings.host_blocked_total(),
        "solves": {k: {"iterations": t.iterations, "fg_count": t.fg_count,
                       "wall_s": t.wall_s, "reasons": t.reasons,
                       "buckets": None if t.buckets is None else [
                           {"E_S_d": list(b.shape), "max_iterations": b.max_iterations,
                            "total_iterations": b.total_iterations, "rounds": b.rounds,
                            "seconds": b.seconds}
                           for b in t.buckets]}
                   for k, t in d.trackers.items()},
        "random_effect_entities": int(model["perUser"].coefficients.shape[0]),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import photon_ml_tpu_torch
    if Path(photon_ml_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: photon_ml_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import _build
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    from photon_ml_tpu_torch.ops.losses import BY_NAME, LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig, RegularizationContext, RegularizationType,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    ref_cache = json.loads((ROOT / "bench_ref_cache.json").read_text())
    ref_nll = ref_cache[REF_KEY]["ref_nll"]
    glmix_ref = ref_cache[GLMIX_REF_KEY]["ref_nll"]
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = {name: ptxas_summary(_build.library_path(name).with_suffix(".log").read_text())
             for name in _build.SIGNATURES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": compiled, "ptxas": ptxas})

    t0 = time.perf_counter()
    x_np, y_np = make_a1a_like(1024, "logistic", seed=42)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    n, d = x.shape
    emit({"phase": "data", "n": n, "d": d, "seconds": time.perf_counter() - t0})

    gen = torch.Generator(device="cuda").manual_seed(7)
    x_wide = torch.rand(WIDE, generator=gen, device="cuda")
    y_wide = (torch.rand(WIDE[0], generator=gen, device="cuda") < 0.25).float()
    losses = [BY_NAME[k] for k in ("logistic", "squared", "poisson", "smoothed_hinge")]
    max_abs_err = run_checks(hk, losses, x, y, x_wide, y_wide)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the main shape last: its numbers go in the kernels line
    for xt, yt in ((x_wide, y_wide), (x, y)):
        timing = time_full(hk, LOGISTIC, xt, yt)
        plan = dataclasses.asdict(hk.plan_fused(*xt.shape, sms))
        emit({"phase": "timing", "shape": list(xt.shape), "loss": "logistic", "reps": REPS,
              "device": kind, "nvidia_smi": smi, "plan": plan, "kernel_ms": timing["ms"],
              **timing})
    del x_wide, y_wide

    def train():
        return train_glm(
            x, y, "logistic_regression",
            optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-9),
            regularization=RegularizationContext(RegularizationType.L2),
            regularization_weights=(LAMBDA,), device="cuda")

    hk.LAUNCHES = 0
    trained = train()
    launches = hk.LAUNCHES
    res = trained[0].result
    coef = trained[0].model.coefficients.means
    if tuple(coef.shape) != (d,) or not bool(torch.isfinite(coef).all()):
        raise SystemExit(f"bad coefficients: shape {tuple(coef.shape)}")
    nll = host_objective(x_np, y_np, coef.double().cpu().numpy(), LAMBDA)
    rel_gap = (nll - ref_nll) / abs(ref_nll)
    wall = trained[0].wall_s
    # the counted run is the process's first solve: it also pays the lazy
    # loading of every small kernel the solver uses; a second, warm run
    # (not counted) gives the steady-state solve time
    warm = train()[0]
    emit({"phase": "main_path", "entry": "photon_ml_tpu_torch.models.training.train_glm",
          "n": n, "d": d, "iterations": res.iterations, "fg_count": res.fg_count,
          "reason": res.reason, "kernel_launches": launches, "wall_s": wall,
          "examples_per_s": n * res.fg_count / wall,
          "warm_wall_s": warm.wall_s, "warm_fg_count": warm.result.fg_count,
          "warm_examples_per_s": n * warm.result.fg_count / warm.wall_s,
          "final_nll_f64": nll, "ref_nll": ref_nll, "nll_rel_gap": rel_gap,
          "loss_history": res.loss_history[:res.iterations + 1].tolist(),
          "device": kind, "nvidia_smi": smi})
    if not (launches == res.fg_count and launches > 0):
        raise SystemExit(f"kernel launches {launches} != fg_count {res.fg_count}")
    if not abs(rel_gap) <= NLL_RTOL:
        raise SystemExit(f"objective {nll} is {rel_gap:.3e} from the reference {ref_nll}")
    prof = profile_run(train)
    emit({"phase": "profile", "device": kind, "nvidia_smi": smi, **prof})
    if prof["fused_kernel_launches"] != prof["fg_count"]:
        raise SystemExit(f"profiled {prof['fused_kernel_launches']} device launches of the "
                         f"kernel for {prof['fg_count']} passes; expected one per pass")

    # --- GLMix: BASELINE config 4 through GameEstimator.fit -------------------
    from photon_ml_tpu_torch.game import GameEstimator
    t0 = time.perf_counter()
    g_train, g_val, g_cfg = glmix_setup()
    emit({"phase": "glmix_data", "n_train": g_train.num_rows, "n_val": g_val.num_rows,
          "seconds": time.perf_counter() - t0})
    hk.LAUNCHES = 0
    t0 = time.perf_counter()
    g_result = GameEstimator(g_cfg, device="cuda").fit(g_train, g_val, ["AUC"])
    torch.cuda.synchronize()
    g_fit_s = time.perf_counter() - t0
    g_launches = hk.LAUNCHES
    g = glmix_report(g_result, g_fit_s, g_train.num_rows, g_launches, glmix_ref)
    emit({"phase": "glmix", "entry": "photon_ml_tpu_torch.game.GameEstimator.fit",
          "config": "BASELINE config 4 (bench.py bench_config4)", "device": kind,
          "nvidia_smi": smi, **g})
    if not g["finite"]:
        raise SystemExit("glmix: non-finite or misshapen objective or coefficients")
    if not (g_launches == g["fe_fg_count"] and g_launches > 0):
        raise SystemExit(f"glmix: kernel launches {g_launches} != fixed-effect "
                         f"fg_count {g['fe_fg_count']}")
    if not abs(g["nll_rel_gap"]) <= GLMIX_RTOL:
        raise SystemExit(f"glmix: objective {g['final_objective']} is "
                         f"{g['nll_rel_gap']:.3e} from the reference {glmix_ref}")
    if not 0.5 < g["validation_auc"] < 1.0:
        raise SystemExit(f"glmix: validation AUC {g['validation_auc']}")

    # the same fit again, warm (random-effect blocks and device shards are
    # memoized on the datasets, so build/coordinates is near zero): the
    # steady-state descent, and whether the fit repeats bit for bit
    t0 = time.perf_counter()
    g_warm = GameEstimator(g_cfg, device="cuda").fit(g_train, g_val, ["AUC"])
    torch.cuda.synchronize()
    emit({"phase": "glmix_warm", "fit_s": time.perf_counter() - t0,
          "spans_s": dict(g_warm.descent.timings),
          "same_objective_history": g_warm.objective_history == g_result.objective_history,
          "device": kind, "nvidia_smi": smi})

    # the kernel at the fixed effect's shape, offsets = the residual scores
    final = g_result.descent.model.coordinates
    gx = g_train.device_shard("global", "cuda", torch.float32)
    gy = torch.as_tensor(g_train.response, dtype=torch.float32, device="cuda")
    go = final["perUser"].score_dataset(g_train).contiguous()
    gc = final["fixed"].glm.coefficients.means
    ok, g_err, v_rel, g_rel = compare(hk, LOGISTIC, gx, gy, gc, None, go)
    emit({"phase": "check", "size": "glmix_fixed_effect", "shape": list(gx.shape),
          "loss": "logistic", "inputs": "offsets", "ok": ok, "max_abs_err": g_err,
          "value_rel_err": v_rel, "grad_err_over_tol": g_rel})
    if not ok:
        raise SystemExit("kernel disagrees with its plain version at the glmix shape")
    g_timing = time_full(hk, LOGISTIC, gx, gy, go)
    emit({"phase": "timing", "shape": list(gx.shape), "loss": "logistic",
          "inputs": "offsets", "reps": REPS, "device": kind, "nvidia_smi": smi,
          "plan": dataclasses.asdict(hk.plan_fused(*gx.shape, sms)),
          "kernel_ms": g_timing["ms"], **g_timing})
    del gx, gy, go

    # one outer iteration under the profiler (random-effect blocks and
    # device shards are memoized on the datasets, so this is the descent)
    g_cfg1 = dataclasses.replace(g_cfg, num_outer_iterations=1)
    g_res1, g_prof = profile_call(
        lambda: GameEstimator(g_cfg1, device="cuda").fit(g_train, g_val, ["AUC"]))
    g_prof["fe_fg_count"] = fe_passes(g_res1.descent)
    g_prof["spans_s"] = dict(g_res1.descent.timings)
    emit({"phase": "glmix_profile", "outer_iterations": 1, "device": kind,
          "nvidia_smi": smi, **g_prof})
    if g_prof["fused_kernel_launches"] != g_prof["fe_fg_count"]:
        raise SystemExit(f"glmix profile: {g_prof['fused_kernel_launches']} device "
                         f"launches of the kernel for {g_prof['fe_fg_count']} passes")

    emit({"kernels": [{
        "name": "fused_value_and_gradient",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/csrc/fused_value_and_gradient.cu",
        "replaces": "photon_ml_tpu/ops/pallas_kernels.py:150",
        "launches": launches + g_launches,
        "launches_by_path": {"train_glm": launches, "glmix": g_launches},
        "max_abs_err": max_abs_err,
        "tolerance": f"value rtol {VALUE_RTOL}, gradient rtol {GRAD_RTOL} atol {GRAD_ATOL}",
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "hbm_share": timing["hbm_share"],
        "ms_over_library": timing["ms_over_library"],
        "design": DESIGN,
        "launches_per_call": prof["fused_kernel_launches"] / prof["fg_count"],
        "at_glmix_shape": {k: g_timing[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "hbm_share",
            "ms_over_library")} | {"shape": [g_train.num_rows, 31],
                                   "max_abs_err": g_err},
    }], "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
