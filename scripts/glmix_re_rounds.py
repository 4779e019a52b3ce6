#!/usr/bin/env python3
"""Where config 4's random-effect solve spends its rounds: one per-user
update of BASELINE config 4, in float32 and in float64, on one device.

    python3 scripts/glmix_re_rounds.py [--rows N] [--device cuda|cpu]

Builds config 4 as chip_smoke.py does (make_movielens_like("1m", seed=11),
95/5 split), fits the fixed effect once in float32 for the residual
offsets, then runs the per-user coordinate's update from zero in each
dtype from the same offsets.  Prints one JSON line per dtype: per S-bucket
its [E, S, d], the largest lane iteration count (the host steps), the
batch's value+gradient rounds (each evaluates every lane: a step costs one
round plus one per backtracking round of any lane), and the wall seconds
(ended by a readback).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_209)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import chip_smoke
    from photon_ml_tpu_torch.game.coordinates import (
        FixedEffectCoordinate, RandomEffectCoordinate)

    chip_smoke.GLMIX_ROWS = args.rows
    train, _, cfg = chip_smoke.glmix_setup()
    fe = FixedEffectCoordinate("fixed", train, cfg.coordinates["fixed"],
                               cfg.task_type, device=args.device)
    model, _ = fe.update(fe.initial_model(),
                         torch.zeros(train.num_rows, device=fe.device))
    offsets = fe.score(model)
    for dtype in (torch.float32, torch.float64):
        re = RandomEffectCoordinate("perUser", train, cfg.coordinates["perUser"],
                                    cfg.task_type, device=args.device, dtype=dtype,
                                    seed=cfg.seed)
        for rep in range(2):  # the first pays the device's warm-up
            t0 = time.perf_counter()
            _, res = re.update(re.initial_model(), offsets.to(dtype))
            seconds = time.perf_counter() - t0
        print(json.dumps({
            "dtype": str(dtype), "device": str(re.device), "rows": train.num_rows,
            "update_s": seconds, "rounds": res.rounds,
            "lane_iterations": int(res.iterations.sum()),
            "lane_fg_count": int(res.fg_count.sum()),
            "objective": float(res.value.double().sum()),
            "buckets": [{"E_S_d": list(b.shape), "steps": b.max_iterations,
                         "rounds": b.rounds, "seconds": b.seconds}
                        for b in re.last_buckets]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
