"""Diagnostics CLI (port of photon_ml_tpu/cli/diagnose.py): trained model +
data -> JSON/markdown/HTML quality report, on one CUDA device unless
`--device cpu` is given; `--x64` computes in float64.

reference: the legacy Driver's DIAGNOSED stage (photon-client/.../
Driver.scala:468-607), which assembles metrics, Hosmer-Lemeshow, bootstrap,
feature importance, and fitting diagnostics into an HTML report.  Here the
same analyses emit report.json + report.md + a self-contained report.html,
equal to the JAX CLI's for the same model and data.  The model scores on
the device and its margins are read back once; the bootstrap's replicas run
as the masked lanes of the lanes kernel, the learning curves' solves
through the single fused kernel (diagnostics/bootstrap.py, fitting.py), both
over the scoring's device copy of the fixed effect's shard.

  python -m photon_ml_tpu_torch.cli.diagnose --model-dir out/best \
      --data d.npz --output-dir diag/ [--coordinate fixed]
      [--bootstrap-samples 10] [--skip-fitting] [--skip-bootstrap]
      [--device cuda|cpu] [--x64]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# the last run's report, its phases' walls and the kernel launches of its
# bootstrap and learning curves, for a caller in the same process
LAST_RUN: dict = {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-diagnose")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--data", required=True,
                   help=".npz GameDataset, .libsvm, or Avro input (file, "
                        "directory, or glob; resolved in the MODEL's "
                        "feature/entity spaces like cli.score)")
    p.add_argument("--feature-shard-map", default=None,
                   help="Avro inputs: JSON (inline or @file) shard -> bags "
                        "merge map (see cli.train)")
    p.add_argument("--id-columns", default=None,
                   help="Avro inputs: comma-separated id tags to extract")
    p.add_argument("--input-columns", default=None,
                   help="Avro inputs: JSON remap of response/offset/weight/"
                        "uid column names (see cli.train)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--coordinate", default=None,
                   help="fixed-effect coordinate to analyze in depth "
                        "(default: the first fixed-effect coordinate)")
    p.add_argument("--bootstrap-samples", type=int, default=10)
    p.add_argument("--skip-bootstrap", action="store_true")
    p.add_argument("--skip-fitting", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; without CUDA "
                        "the run exits non-zero unless --device cpu)")
    p.add_argument("--x64", action="store_true",
                   help="compute in float64 (float32 otherwise)")
    return p


def fe_solve_options(config, fe_name) -> dict:
    """The bootstrap's and the learning curves' solve options: the fixed
    effect's saved optimizer, regularization and weight where the model
    records its config, the functions' defaults otherwise."""
    from photon_ml_tpu_torch.game.config import FixedEffectCoordinateConfig
    opt = None
    if config is not None and fe_name in config.coordinates:
        c = config.coordinates[fe_name]
        if isinstance(c, FixedEffectCoordinateConfig):
            opt = c.optimization
    kw = dict(
        optimizer_config=opt.optimizer if opt else None,
        regularization=opt.regularization if opt else None,
        regularization_weight=opt.regularization_weight if opt else 0.0)
    return {k: v for k, v in kw.items() if v is not None}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from photon_ml_tpu_torch.cli.score import _load_scoring_data, require_fully_labeled
    from photon_ml_tpu_torch.cli.train import resolve_cli_device
    from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_ml_tpu_torch.diagnostics import (
        DiagnosticReport, bootstrap_training, evaluate_scores,
        feature_importance, fitting_diagnostic, hosmer_lemeshow,
        kendall_tau_analysis, render_html, render_markdown,
    )
    from photon_ml_tpu_torch.models.game import FixedEffectModel
    from photon_ml_tpu_torch.models.io import load_game_model
    from photon_ml_tpu_torch.ops import TASK_LOSSES
    from photon_ml_tpu_torch.ops import hopper_kernels as hk

    device = resolve_cli_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    walls, launches = {}, {}
    LAST_RUN.clear()
    t0 = time.perf_counter()
    model, config = load_game_model(args.model_dir, device=device, dtype=dtype)
    # Avro inputs resolve in the MODEL's feature/entity spaces (the scoring
    # loader pins index maps and errors when the model records none —
    # misaligned columns would silently corrupt every diagnostic)
    ds, _uids = _load_scoring_data(args, model, args.model_dir)
    require_fully_labeled(ds, "diagnostics")
    task = model.task_type
    loss = TASK_LOSSES[task]
    walls["load"] = time.perf_counter() - t0

    # full-model metrics from the composite score (margins + offsets), the
    # margins read back once, the mean function in float64 on the host
    t0 = time.perf_counter()
    margins = model.score_dataset(ds).detach().cpu().numpy().astype(np.float64)
    if ds.offsets is not None:
        margins = margins + ds.offsets
    preds = loss.mean(torch.from_numpy(margins)).numpy()
    walls["score"] = time.perf_counter() - t0

    # the in-depth single-GLM analyses run on a fixed-effect coordinate
    fe_name, fe_model = None, None
    for name, m in model.coordinates.items():
        if isinstance(m, FixedEffectModel) and (
                args.coordinate is None or name == args.coordinate):
            fe_name, fe_model = name, m
            break
    if args.coordinate is not None and fe_name != args.coordinate:
        raise SystemExit(f"no fixed-effect coordinate {args.coordinate!r}")

    coefs = (fe_model.glm.coefficients.means.detach().cpu().numpy()
             if fe_model is not None else None)
    metrics = evaluate_scores(task, preds, margins, ds.response,
                              coefficients=coefs)
    report = DiagnosticReport(task_type=task, metrics=metrics)

    if fe_model is not None:
        t0 = time.perf_counter()
        x = ds.feature_shards[fe_model.feature_shard]
        summary = BasicStatisticalSummary.from_features(
            np.asarray(x), ds.weights)
        imap = ds.index_maps.get(fe_model.feature_shard)
        keys = imap.index_to_key if imap is not None else None
        report.feature_importance = feature_importance(
            coefs, summary, keys, "expected_magnitude")
        walls["importance"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if task == "logistic_regression":
            report.hosmer_lemeshow = hosmer_lemeshow(preds, ds.response,
                                                     x.shape[1])
        walls["hosmer_lemeshow"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report.independence = kendall_tau_analysis(preds, ds.response - preds)
        walls["kendall_tau"] = time.perf_counter() - t0

        kw = fe_solve_options(config, fe_name)
        # a dense shard's device copy is the one the scoring made; any
        # other shard goes as the JAX package takes it (np.asarray)
        x_fit = (ds.device_shard(fe_model.feature_shard, device, dtype)
                 if isinstance(x, np.ndarray) else x)
        for part, skip in (("bootstrap", args.skip_bootstrap),
                           ("fitting", args.skip_fitting)):
            if skip:
                continue
            counts = (hk.LAUNCHES, hk.LANES_LAUNCHES)
            t0 = time.perf_counter()
            if part == "bootstrap":
                report.bootstrap = bootstrap_training(
                    x_fit, ds.response, task,
                    num_bootstrap_samples=args.bootstrap_samples,
                    weights=ds.weights, offsets=ds.offsets, device=device,
                    dtype=dtype, **kw)
            else:
                report.fitting = fitting_diagnostic(
                    x_fit, ds.response, task, weights=ds.weights,
                    offsets=ds.offsets, device=device, dtype=dtype, **kw)
            walls[part] = time.perf_counter() - t0
            launches[part] = {"single": hk.LAUNCHES - counts[0],
                              "lanes": hk.LANES_LAUNCHES - counts[1]}

    t0 = time.perf_counter()
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "report.json"), "w") as f:
        f.write(report.to_json())
    with open(os.path.join(args.output_dir, "report.md"), "w") as f:
        f.write(render_markdown(report))
    with open(os.path.join(args.output_dir, "report.html"), "w") as f:
        f.write(render_html(report))
    walls["render"] = time.perf_counter() - t0
    LAST_RUN.update(report=report, walls_s=walls, launches=launches,
                    coordinate=fe_name, device=str(device))
    print(json.dumps({"metrics": metrics,
                      "coordinate": fe_name,
                      "output": args.output_dir}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
