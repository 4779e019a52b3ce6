#!/usr/bin/env python3
"""Plan sweep of sparse kernel A (ell_margin_loss, csrc/ell_sparse.cu) on
one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 scripts/margin_sweep.py [--reps 20]

At bench config 6's shape ([200,000 x 250,000], k = 65, make_wide_sparse_
logistic as bench.py makes it) and config 7's fixed-effect shard
([285,135 x 14,983], k = 25, chip_smoke.yahoo_setup's training rows), it
times kernel A in loss mode (logistic; random offsets at config 7, as
its fit passes the residual scores) under the plan that
sparse_kernels.plan_margins chooses and under variants of that plan,
beside cuSPARSE SpMV through torch's CSR tensors (X c) and A's gather
floor (torch.index_select(c, 0, indices.reshape(-1))), all with
chip_smoke.cuda_ms (median over reps of 10 back-to-back calls with
perturbed c, device time only), interleaved within each rep.  Variants:
  plan        the plan as shipped;
  rows128x2   (where the plan stages rows and c) tiles of <= 128 rows
              (fewer when 2 stages of them and c would not fit half an
              SM), two blocks per SM;
  lanes32     (there too) a warp per row with c from L2 instead;
  lanes16     (where the plan takes lanes per row) 16 lanes per row.
Each variant is first held against the plain version.  One JSON object
per line; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# two blocks per SM: each gets half of the SM's 228 KB, less 1 KB each
HALF_SM_SMEM = 233_472 // 2 - 1024


def variants(sk, n, k, d, sms) -> dict:
    plan = sk.plan_margins(n, k, d, sms)
    lanes = lambda p: sk.MarginPlan(p, sk.THREADS // p, 0, max(1, min(
        sk.BLOCKS_PER_SM * sms, -(-n // (sk.THREADS // p)))), 0)
    out = {"plan": plan}
    if plan.c_in_smem:
        rows = min(128, plan.rows)
        while sk.margin_smem_bytes(k, rows, 2, d) > HALF_SM_SMEM:
            rows -= 1
        out["rows128x2"] = sk.MarginPlan(1, rows, 2, max(1, min(2 * sms, -(-n // rows))),
                                         sk.margin_smem_bytes(k, rows, 2, d))
        out["lanes32"] = lanes(32)
    else:
        out["lanes16"] = lanes(16)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("margin_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from photon_ml_tpu_torch.data.synthetic_bench import make_wide_sparse_logistic
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.ops.features import PaddedSparse
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    smi = cs.nvidia_smi()
    cs.emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x6, y6 = make_wide_sparse_logistic(cs.CONFIG6_N, d=cs.CONFIG6_D, nnz=cs.CONFIG6_NNZ,
                                       seed=cs.CONFIG6_SEED)
    train, _, _ = cs.yahoo_setup()
    x7 = train.device_shard("global", "cuda", torch.float32)
    shapes = {"config6": (PaddedSparse.from_scipy(x6, device="cuda"),
                          torch.from_numpy(y6).cuda(), None),
              "config7_fixed_effect": (
                  x7, torch.as_tensor(train.response, dtype=torch.float32, device="cuda"),
                  torch.linspace(-0.5, 0.5, x7.shape[0], device="cuda"))}
    planner = sk.plan_margins
    for name, (x, y, o) in shapes.items():
        n, d = x.shape
        k = x.indices.shape[1]
        idx, val = x.indices, x.values
        flat = idx.reshape(-1)
        rows_of = torch.repeat_interleave(torch.arange(n, device="cuda"), k)
        keep = val.reshape(-1) != 0
        crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
        crow[1:] = torch.cumsum(torch.bincount(rows_of[keep], minlength=n), 0)
        x_csr = torch.sparse_csr_tensor(crow, flat[keep].long(), val.reshape(-1)[keep],
                                        size=(n, d))
        plans = variants(sk, n, k, d, sms)

        def call(plan):
            def run(c):
                sk.plan_margins = lambda *a: plan
                try:
                    return sk.ell_margin_loss(LOGISTIC, idx, val, c, y, None, o)
                finally:
                    sk.plan_margins = planner
            return run

        c0 = torch.linspace(-0.1, 0.1, d, device="cuda")
        v_p, u_p = sk.ell_margin_loss_plain(LOGISTIC, idx, val, c0, y, None, o)
        for vn, plan in plans.items():
            v, u = call(plan)(c0)
            ok = (abs(v.item() - v_p.item()) <= cs.VALUE_RTOL * abs(v_p.item())
                  and cs.over_tol(u, u_p, cs.GRAD_ATOL + cs.GRAD_RTOL * u_p.abs()) <= 1.0)
            if not ok:
                raise SystemExit(f"{name}/{vn}: kernel A disagrees with plain under {plan}")
        timed = {vn: call(plan) for vn, plan in plans.items()}
        timed["cusparse"] = lambda c: x_csr @ c
        timed["gather_floor"] = lambda c: torch.index_select(c, 0, flat)
        times = {key: [] for key in timed}
        batch = 10
        for r in range(args.reps + 2):
            cs_ = [c0 + 1e-6 * (r * batch + i + 1) for i in range(batch)]
            for key, fn in timed.items():
                ms = cs.cuda_ms(lambda: [fn(c) for c in cs_]) / batch
                if r >= 2:
                    times[key].append(ms)
        a_bytes = 8 * n * k + 4 * n * (2 if o is not None else 1) + 4 * d + 4 * n + 4
        for key, ts in times.items():
            row = {"shape": name, "n": n, "d": d, "k": k, "variant": key,
                   "ms": statistics.median(ts), "min_ms": min(ts), "max_ms": max(ts),
                   "bound_ms": a_bytes / cs.PEAK_BYTES_PER_S * 1e3, "nvidia_smi": smi}
            if key in plans:
                row["plan"] = dataclasses.asdict(plans[key])
                row["ptxas"] = cs.margin_ptxas(plans[key], LOGISTIC.kernel_id)
            cs.emit(row)
        del x_csr
    return 0


if __name__ == "__main__":
    sys.exit(main())
