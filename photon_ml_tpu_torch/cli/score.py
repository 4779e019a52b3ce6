"""Scoring CLI (port of photon_ml_tpu/cli/score.py), on one CUDA device
unless `--device cpu` is given; `--x64` scores in float64.

reference: the GAME scoring job (photon-client/.../cli/game/scoring/
Driver.scala:37-309): load model + data -> score -> save scores
(ScoringResultAvro) + optional evaluation.

  python -m photon_ml_tpu_torch.cli.score --model-dir out/best \
      --data test.npz|test.avro --output scores[.npz|.avro]
      [--format npz|avro] [--evaluators AUC,RMSE] [--device cuda|cpu] [--x64]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-ml-tpu-torch-score")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--data", required=True,
                   help=".npz GameDataset, .libsvm, or Avro input (file, "
                        "directory, or glob)")
    p.add_argument("--output", required=True, help="scores output path")
    p.add_argument("--format", default="npz", choices=["npz", "avro"],
                   help="score output format; avro writes ScoringResultAvro "
                        "records (reference: ScoreProcessingUtils)")
    p.add_argument("--model-id", default=None,
                   help="modelId stamped into ScoringResultAvro records "
                        "(default: the model directory name)")
    p.add_argument("--feature-shard-map", default=None,
                   help="Avro inputs: JSON (inline or @file) shard -> bags "
                        "merge map (see cli.train)")
    p.add_argument("--id-columns", default=None,
                   help="Avro inputs: comma-separated id tags to extract")
    p.add_argument("--input-columns", default=None,
                   help="Avro inputs: JSON remap of response/offset/weight/"
                        "uid column names (see cli.train)")
    p.add_argument("--evaluators", default=None)
    p.add_argument("--predict", action="store_true",
                   help="also emit mean predictions (inverse link); only "
                        "the npz output format carries them, so combining "
                        "with --format avro is an error")
    p.add_argument("--mesh", default="auto",
                   help="accepted for the JAX command line's sake ('auto', "
                        "'none' or 'DxF'): scores do not depend on the mesh, "
                        "and the port scores in one process on one device")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX CLI's sake: the port has no "
                        "compile cache")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (default cuda; without "
                        "CUDA the run exits non-zero unless --device cpu)")
    p.add_argument("--x64", action="store_true",
                   help="score in float64 (float32 otherwise)")
    return p


def _load_scoring_data(args, model, model_dir):
    """Avro scoring input reads in the MODEL's feature/entity spaces
    (reference: the scoring job resolves features through the trained
    model's index maps; unseen entities score through the fixed effect
    only).  Returns (dataset, uids or None)."""
    from photon_ml_tpu_torch.cli.train import (_load_dataset,
                                               parse_feature_shard_map,
                                               parse_input_columns,
                                               resolve_avro_paths)
    avro_paths = resolve_avro_paths(args.data)
    if avro_paths is None:
        return _load_dataset(args.data, model.task_type), None
    from photon_ml_tpu_torch.data.avro_game import read_game_examples
    from photon_ml_tpu_torch.models.game import MatrixFactorizationModel
    from photon_ml_tpu_torch.models.io import load_model_index_maps
    id_cols = [c for c in (args.id_columns or "").split(",") if c]
    entity_vocabs = {}

    def add_tag(tag, vocab):
        if tag is None:
            return
        entity_vocabs.setdefault(tag, np.asarray(vocab))
        if tag not in id_cols:
            id_cols.append(tag)

    for m in model.coordinates.values():
        if isinstance(m, MatrixFactorizationModel):
            add_tag(m.row_effect_type, m.row_ids)
            add_tag(m.col_effect_type, m.col_ids)
        elif getattr(m, "random_effect_type", None) is not None \
                and hasattr(m, "entity_ids"):
            add_tag(m.random_effect_type, m.entity_ids)
    index_maps = load_model_index_maps(model_dir)
    shard_map = parse_feature_shard_map(args.feature_shard_map)
    missing = sorted(set(shard_map) - set(index_maps or {}))
    if missing:
        # a PARTIALLY covered shard map is the same failure as no maps at
        # all: read_game_examples would scan a fresh vocabulary for the
        # uncovered shard and columns would silently misalign with the model
        raise SystemExit(
            f"model at {model_dir!r} records no saved index map for feature "
            f"shard(s) {missing} named in --feature-shard-map, so Avro "
            "scoring data cannot be resolved into the model's feature space "
            "(columns would silently misalign). Re-save the model with index "
            "maps for every shard, or score from an npz GameDataset instead.")
    result = read_game_examples(
        avro_paths, shard_map,
        id_columns=id_cols,
        columns=parse_input_columns(getattr(args, "input_columns", None)),
        index_maps=index_maps,
        entity_vocabs=entity_vocabs or None,
        require_response=False)
    return result.dataset, result.uids


def require_fully_labeled(ds, purpose: str) -> None:
    """Shared labeled-data gate for score/diagnose: ANY unlabeled row would
    silently NaN-poison metrics, so partial labels are an error too."""
    nan = np.isnan(np.asarray(ds.response))
    if nan.all():
        raise SystemExit(f"{purpose} requires labeled data (the input has "
                         "no response column)")
    if nan.any():
        raise SystemExit(
            f"{purpose} requires a response for every record; "
            f"{int(nan.sum())} of {ds.num_rows} rows are unlabeled")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.predict and args.format == "avro":
        # ScoringResultAvro records have no prediction field; silently
        # dropping --predict hid the loss — fail loudly instead
        parser.error("--predict emits a predictions array that only the npz "
                     "output format carries; drop --predict or use "
                     "--format npz")

    import torch
    from photon_ml_tpu_torch.cli.train import parse_mesh_arg, resolve_cli_device
    from photon_ml_tpu_torch.evaluation.evaluators import parse_evaluator
    from photon_ml_tpu_torch.models.io import load_game_model

    device = resolve_cli_device(args.device)
    parse_mesh_arg(args.mesh)
    dtype = torch.float64 if args.x64 else torch.float32
    t0 = time.time()
    model, _config = load_game_model(args.model_dir, device=device, dtype=dtype)
    ds, uids = _load_scoring_data(args, model, args.model_dir)
    load_s = time.time() - t0
    t0 = time.time()
    scores = model.score_dataset(ds).detach().cpu().numpy()
    score_s = time.time() - t0

    has_response = not np.isnan(np.asarray(ds.response)).all()
    if args.format == "avro":
        from photon_ml_tpu_torch.data.avro_io import write_scores_avro
        out_path = (args.output if args.output.endswith(".avro")
                    else args.output + ".avro")
        model_id = args.model_id or os.path.basename(
            args.model_dir.rstrip("/")) or "model"
        write_scores_avro(out_path, model_id, scores,
                          labels=ds.response if has_response else None,
                          weights=ds.weights, uids=uids)
    else:
        out = {"scores": scores}
        if args.predict:
            out["predictions"] = model.predict(ds).detach().cpu().numpy()
        np.savez_compressed(args.output if args.output.endswith(".npz")
                            else args.output + ".npz", **out)

    result = {"rows": int(ds.num_rows), "output": args.output,
              "format": args.format,
              "compile_s": None,
              "device": str(device), "load_s": round(load_s, 3),
              "score_s": round(score_s, 3),
              "evaluation": {}}
    if args.evaluators:
        require_fully_labeled(ds, "--evaluators")
        total = scores + (ds.offsets if ds.offsets is not None else 0.0)
        for spec in args.evaluators.split(","):
            ev, group = parse_evaluator(spec)
            if group is not None:
                v = ev.evaluate_grouped(ds.entity_indices[group], total,
                                        ds.response, ds.weights)
            else:
                v = ev(total, ds.response, ds.weights)
            result["evaluation"][ev.name] = v
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
