#!/usr/bin/env python3
"""Design sweep of the candidate-lanes kernel on one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/lanes_sweep.py [--shapes 950051x31x16,1643520x124x16] [--reps 20]
                                   [--no-sweep]

It builds the kernel source (photon_ml_tpu_torch/csrc/
fused_value_and_gradient_lanes.cu) three times, into build/lanes_sweep/,
with -DLANES_PHASES=1, 2 and 3:
  copies          the ring alone: the producer's bulk copies, the consumers
                  waiting for each tile and releasing it;
  copies_margins  the ring, the margins on the tensor cores and the loss
                  step (no gradient);
  full            the whole pass, as shipped.
For each shape n x d x K (logistic, random normal X, offsets O [K, n]) it
times each build at the plan ops/hopper_kernels.plan_lanes chooses, then
(unless --no-sweep) full and copies at other plans: tile rows, ring stages
and blocks per SM.  Beside them: torch.sum(X) (one read of X by a library
reduction, the rate the card reaches in practice) and the library call
(torch.matmul of X and C^T plus O, the loss on [n, K], torch.matmul of X^T
and w l').  Times are CUDA-event medians over --reps of 10 back-to-back
calls, each with its own perturbed coefficients.  One JSON object per line,
the card's name and power limit first.  The ablations' outputs are wrong by
construction: they are for finding where the time goes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NAME = "fused_value_and_gradient_lanes"
PHASES = {"copies": 1, "copies_margins": 2, "full": 3}
PEAK_BYTES_PER_S = 3.35e12


def build() -> dict:
    from photon_ml_tpu_torch.ops import _build
    out_dir = ROOT / "build" / "lanes_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / f"{NAME}.cu"
    procs = {}
    for name, phases in PHASES.items():
        so = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DLANES_PHASES={phases}",
               "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES[NAME].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def sweep_shape(libs, n, d, lanes, reps, sweep, sms) -> None:
    import torch
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((n, d), generator=gen, device="cuda")
    y = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    o = 0.1 * torch.randn((lanes, n), generator=gen, device="cuda")
    base = torch.linspace(-0.1, 0.1, lanes * d, device="cuda").reshape(lanes, d) / d ** 0.5
    out = torch.empty((lanes, d + 2), device="cuda")
    partial = torch.empty(2 * sms * lanes * (d + 2), device="cuda")
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = 4 * (n * d + n + lanes * n + lanes * d + lanes * (d + 2))
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3

    def timed(call, batch=10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for r in range(reps + 2):  # the first two rounds warm up
            cs = [base + 1e-6 * (r * batch + i + 1) for i in range(batch)]
            start.record()
            for c in cs:
                call(c)
            end.record()
            end.synchronize()
            if r >= 2:
                times.append(start.elapsed_time(end) / batch)
        return statistics.median(times), min(times), max(times)

    def report(case, med, lo, hi, **extra):
        print(json.dumps({"case": case, "shape": [n, d], "lanes": lanes, "ms": med,
                          "min_ms": lo, "max_ms": hi, "bound_ms": bound_ms,
                          "share_of_bound": bound_ms / med, **extra}), flush=True)

    def launch(lib, plan):
        def call(c):
            err = lib.pmt_fused_value_and_gradient_lanes(
                LOGISTIC.kernel_id, 4, x.data_ptr(), y.data_ptr(), None, o.data_ptr(), None, None,
                None,
                c.data_ptr(), partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, d,
                lanes, plan.rows_per_tile, plan.stages, plan.grid, plan.slots,
                plan.layout.bytes, stream)
            if err:
                raise RuntimeError(f"launch failed ({err}) for {plan}")
        return call

    def library(c):
        z = torch.matmul(x, c.T) + o.T
        l, dl = LOGISTIC.loss_and_dz(z, y[:, None])
        return l.sum(0), torch.matmul(x.T, dl), dl.sum(0)

    report("torch.sum(X)", *timed(lambda c: torch.sum(x)))
    report("library", *timed(library))
    default = hk.plan_lanes(n, d, lanes, sms)
    for name, lib in libs.items():
        report(name, *timed(launch(lib, default)), rows=default.rows_per_tile,
               stages=default.stages, grid=default.grid, slots=default.slots,
               smem=default.layout.bytes)
    if not sweep:
        return
    for bps in (1, 2):
        for rows in hk.LANES_ROWS:
            for stages in (2, 3, 4):
                try:
                    plan = hk.plan_lanes(n, d, lanes, sms, rows=rows, stages=stages,
                                         blocks_per_sm=bps)
                except ValueError:
                    continue
                if bps * (plan.layout.bytes + 1024) > 228 * 1024:
                    continue
                for name in ("full", "copies"):
                    report(f"{name}/sweep", *timed(launch(libs[name], plan)), rows=rows,
                           stages=stages, blocks_per_sm=bps, grid=plan.grid,
                           slots=plan.slots, smem=plan.layout.bytes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="950051x31x16,1643520x124x16",
                    help="comma-separated n x d x K")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-sweep", action="store_true", help="time the default plan only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lanes_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    libs = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in args.shapes.split(","):
        n, d, lanes = (int(v) for v in shape.split("x"))
        sweep_shape(libs, n, d, lanes, args.reps, not args.no_sweep, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
