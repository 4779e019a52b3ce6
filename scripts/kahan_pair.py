#!/usr/bin/env python3
"""The fused kernel's compensated sums against plain ones, paired on one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/kahan_pair.py [--pairs 3]

It builds the kernel source (photon_ml_tpu_torch/csrc/fused_value_and_gradient.cu)
as it stands and as a variant whose KahanSum adds plainly (the same
layout, signature and order of terms), into build/kahan_pair/, then in
turns (plain, compensated, compensated, plain, ...) runs BASELINE config 1
through train_glm (make_a1a_like(1024), L2 1, LBFGS(100, 1e-9), f32) with
each library behind the wrapper, and times each kernel at that shape.  One
JSON object per line, the card's name and power limit first: value+gradient
passes, iterations, the solve's wall (a second, warm solve), the float64
objective's gap to the scipy optimum in bench_ref_cache.json, and the
kernel's device ms per call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KAHAN = """  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }"""
PLAIN = """  __device__ __forceinline__ void add(float v) { s += v; }"""


def build(sources: dict) -> dict:
    from photon_ml_tpu_torch.ops import _build
    out_dir = ROOT / "build" / "kahan_pair"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES["fused_value_and_gradient"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kahan_pair: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
    from photon_ml_tpu_torch.models.training import train_glm
    from photon_ml_tpu_torch.ops import _build
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, RegularizationContext,
                                                  RegularizationType)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    src = (ROOT / "photon_ml_tpu_torch" / "csrc" / "fused_value_and_gradient.cu").read_text()
    assert src.count(KAHAN) == 1, "KahanSum::add changed; update this script"
    libs = build({"compensated": src, "plain": src.replace(KAHAN, PLAIN)})
    ref = json.loads((ROOT / "bench_ref_cache.json").read_text())[chip_smoke.REF_KEY]["ref_nll"]
    x_np, y_np = make_a1a_like(1024, "logistic", seed=42)
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()

    def solve():
        return train_glm(x, y, "logistic_regression",
                         optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-9),
                         regularization=RegularizationContext(RegularizationType.L2),
                         regularization_weights=(chip_smoke.LAMBDA,), device="cuda")[0]

    order = [name for _ in range(args.pairs)
             for name in ("plain", "compensated", "compensated", "plain")]
    for name in order:
        _build.load_library = lambda _name, lib=libs[name]: lib
        solve()                                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = trained.result
        coef = trained.model.coefficients.means.double().cpu().numpy()
        nll = chip_smoke.host_objective(x_np, y_np, coef, chip_smoke.LAMBDA)
        timing = chip_smoke.time_full(hk, LOGISTIC, x, y)
        print(json.dumps({"kernel": name, "fg_count": res.fg_count,
                          "iterations": res.iterations, "solve_wall_s": wall,
                          "nll_rel_gap": (nll - ref) / abs(ref), "kernel_ms": timing["ms"],
                          "hbm_share": timing["hbm_share"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
