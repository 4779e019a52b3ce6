#!/usr/bin/env python3
"""Design sweep of the fused value+gradient kernel on one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/fvg_sweep.py [--n 1643520] [--d 124] [--reps 20]

It builds the kernel source (photon_ml_tpu_torch/csrc/fused_value_and_gradient.cu)
as it stands and in variants with phases cut out, into build/fvg_sweep/,
then times each with CUDA events (median over reps of 10 back-to-back
calls, logistic, random uniform X of the given shape) at the plan that
ops/hopper_kernels.plan_fused chooses and at other tile sizes, stage
counts and blocks per SM.  Beside them it times torch.sum(X), one read of
X by a library reduction, as the rate the card reaches in practice.
Variants:
  full         the kernel as shipped;
  no_loss      with the loss replaced by two adds;
  no_gradient  without the gradient phase (margins, loss, ring);
  margins_only without the gradient phase and the loss;
  stream_only  the ring alone: consumers wait for each stage and release it;
  compute_only, margins_compute_only: full and margins_only without the
               copies (the consumers work on whatever the stages hold).
One JSON object per line; the card's name and power limit first.  Numbers
from the variants are for finding where the time goes, not results: their
outputs are wrong by construction.
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

MARGINS = "      // margins, then the loss on each row's first thread\n"
GRADIENT = "      // gradient: registers over fixed columns\n"
RELEASE = "      // our generic writes to the stage happen before the next bulk copy into it\n"


def variants(src: str) -> dict:
    for marker in (MARGINS, GRADIENT, RELEASE):
        assert src.count(marker) == 1, marker
    cut = lambda s, a, b: s.replace(a, "#if 0\n" + a).replace(b, "#endif\n" + b)
    loss = "          loss_and_dz<LOSS>(z, by[r], l, dl);\n"
    assert src.count(loss) == 1
    no_loss = src.replace(loss, "          l = z + by[r];\n          dl = z;\n")
    issue = "        if (bytes == 0) {\n"
    assert src.count(issue) == 1
    no_copy = lambda s: s.replace(issue, "        if (true) {\n")
    return {"full": src,
            "compute_only": no_copy(src),
            "margins_compute_only": no_copy(cut(no_loss, GRADIENT, RELEASE)),
            "no_loss": no_loss,
            "no_gradient": cut(src, GRADIENT, RELEASE),
            "margins_only": cut(no_loss, GRADIENT, RELEASE),
            "stream_only": cut(src, MARGINS, RELEASE)}


def build(sources: dict) -> dict:
    from photon_ml_tpu_torch.ops import _build
    out_dir = ROOT / "build" / "fvg_sweep"
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


def plan_for(hk, n, d, rows, stages, blocks_per_sm, sms):
    return dict(rows=rows, stages=stages, grid=max(1, min(sms * blocks_per_sm, -(-n // rows))),
                layout=hk.smem_layout(d, rows, stages))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_643_520)
    ap.add_argument("--d", type=int, default=124)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, help="tile rows for the variants (default: the plan's)")
    ap.add_argument("--stages", type=int, help="ring stages for the variants")
    ap.add_argument("--no-sweep", action="store_true", help="time the variants only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fvg_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)

    src = (ROOT / "photon_ml_tpu_torch" / "csrc" / "fused_value_and_gradient.cu").read_text()
    libs = build(variants(src))
    n, d = args.n, args.d
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((n, d), generator=gen, device="cuda")
    y = (torch.rand(n, generator=gen, device="cuda") < 0.25).float()
    base = torch.linspace(-0.1, 0.1, d, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    acc = hk.plan_fused(n, d, sms).acc_per_thread
    partial = torch.empty(2 * sms * (d + 2), device="cuda")
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty(d + 2, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bound_ms = 4 * (n * d + n + 2 * d + 1) / 3.35e12 * 1e3

    def timed(call, batch=10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for r in range(args.reps + 2):
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
        print(json.dumps({"case": case, "ms": med, "min_ms": lo, "max_ms": hi,
                          "hbm_share": bound_ms / med, "shape": [n, d], **extra}), flush=True)

    report("torch.sum(X)", *timed(lambda c: torch.sum(x)))

    def launch(lib, p):
        def call(c):
            err = lib.pmt_fused_value_and_gradient(
                0, 4, x.data_ptr(), y.data_ptr(), None, None, None, None, c.data_ptr(),
                partial.data_ptr(),
                ticket.data_ptr(), out.data_ptr(), n, d, p["rows"], p["stages"], p["grid"],
                acc, p["layout"].bytes, stream)
            if err:
                raise RuntimeError(f"launch failed ({err}) for {p}")
        return call

    default = hk.plan_fused(n, d, sms)
    dp = plan_for(hk, n, d, args.rows or default.rows_per_tile,
                  args.stages or default.stages, 1, sms)
    for name, lib in libs.items():
        report(name, *timed(launch(lib, dp)), rows=dp["rows"], stages=dp["stages"],
               grid=dp["grid"], smem=dp["layout"].bytes)
    for bps in () if args.no_sweep else (1, 2):
        for kb in (16, 32, 48, 64, 96):
            rows = max(1, kb * 1024 // (4 * d))
            rows -= rows % 4 if rows >= 4 else 0
            for stages in (2, 3, 4, 6):
                p = plan_for(hk, n, d, rows, stages, bps, sms)
                if p["layout"].bytes * bps > 228 * 1024 - bps * 2048 or p["layout"].bytes > hk.MAX_SMEM:
                    continue
                for name in ("full", "stream_only"):
                    report(f"{name}/sweep", *timed(launch(libs[name], p)), rows=rows,
                           stages=stages, blocks_per_sm=bps, grid=p["grid"],
                           smem=p["layout"].bytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
