"""Training CLI (port of photon_ml_tpu/cli/train.py): one entry point for the
legacy single-GLM pipeline and the GAME path, on one CUDA device or a mesh
of them.

  python -m photon_ml_tpu_torch.cli.train \
      --train-data data.npz|data.libsvm|data.avro --task logistic_regression \
      --output-dir out/ [--validation-data v.npz] [--config game.json]
      [--reg-weights 0.1,1,10] [--evaluators AUC,PRECISION@K:10:userId]
      [--device cuda|cpu] [--x64] ...

Without --config, a single fixed-effect coordinate over the "global" shard
is trained (the legacy pipeline: lambda sweep -> validate -> select best,
through GameEstimator.fit_grid); with --config (GameTrainingConfig JSON),
the full GAME coordinate-descent path runs.  The flags are the JAX CLI's;
`--device` (default cuda) is the port's counterpart of JAX_PLATFORMS, and
without CUDA the run exits non-zero unless `--device cpu` is given.  `--x64`
computes in float64 (float32 otherwise).  `--checkpoint-dir` checkpoints
after every outer iteration and resumes from the newest verified record;
`--fault-plan` (or $PHOTON_FAULT_PLAN) arms fault injection; on SIGTERM or
SIGINT the run stops after the in-flight update and exits with the
resumable status 75 and a JSON line.  `--hbm-budget` trains out of core
(streamed fixed effects, residency rotation).  `--tuning random|bayesian`
searches the regularization weights after the fit (hyperparameter/), each
candidate a refit over the shared sweep state.  `--trace-out`/`--run-log`
arm the telemetry span tracer (a Chrome trace and a JSONL run log,
exported on every exit path), `--event-listener` registers training event
listeners and `--profile` records a torch.profiler trace of the fit into
<output-dir>/profile/.

Multi-GPU training runs one process per rank of a data x feature mesh
(parallel/mesh.py, torch.distributed): `--mesh DxF` alone starts the D*F
local ranks itself, one per visible card; `--coordinator HOST:PORT
--num-processes N --process-id I` (or $PHOTON_COORDINATOR /
$PHOTON_NUM_PROCESSES / $PHOTON_PROCESS_ID) joins one rank to a run started
elsewhere.  `--dist-backend nccl|gloo` picks the backend: nccl by default on
cuda, which needs a card per rank; ranks that share a card must ask for
gloo.  Every rank arms the lost-worker watchdog; only process 0 writes
checkpoints and outputs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch-train",
        description="Train GLM / GAME mixed-effect models on a CUDA device "
                    "(PyTorch)")
    p.add_argument("--train-data", required=True,
                   help=".npz GameDataset, .libsvm file, or Avro input "
                        "(.avro file, directory of .avro files, or glob)")
    p.add_argument("--validation-data", default=None)
    p.add_argument("--feature-shard-map", default=None,
                   help="Avro inputs: JSON (inline or @file) mapping shard "
                        "name -> list of feature-bag fields to merge, e.g. "
                        "'{\"global\": [\"features\"], \"per_user\": "
                        "[\"userFeatures\"]}' (reference: readMerged "
                        "featureColumnMap); default merges the 'features' "
                        "bag into one 'global' shard")
    p.add_argument("--index-map-dir", default=None,
                   help="directory of prebuilt per-shard index maps "
                        "(python -m photon_ml_tpu_torch.cli.index); pins this "
                        "job's Avro ingest to that frozen feature space so "
                        "separate jobs share identical feature dimensions "
                        "and key->column assignment (reference: "
                        "FeatureIndexingJob + PalDBIndexMapLoader)")
    p.add_argument("--selected-features", default=None,
                   help="Avro file of FeatureAvro {name, term} records: "
                        "restrict training to exactly these features (+ "
                        "intercept), like the legacy trainer's "
                        "selected-features file (reference: GLMSuite "
                        "selectedFeaturesFile).  Single-shard Avro input "
                        "only; exclusive with --index-map-dir")
    p.add_argument("--id-columns", default=None,
                   help="Avro inputs: comma-separated random-effect id tags "
                        "to extract (top-level field or metadataMap key)")
    p.add_argument("--input-columns", default=None,
                   help="Avro inputs: JSON remapping of input column names, "
                        "e.g. '{\"response\": \"label\", \"weight\": \"w\"}' "
                        "(reference: InputColumnsNames; keys: response, "
                        "offset, weight, uid)")
    p.add_argument("--input-date-range", default=None,
                   help="restrict date-partitioned input to "
                        "'yyyyMMdd-yyyyMMdd': reads "
                        "<train-data>/daily/YYYY/MM/DD per day (reference: "
                        "GameDriver.pathsForDateRange)")
    p.add_argument("--input-days-ago", default=None,
                   help="same as --input-date-range but as 'START-END' days "
                        "ago (e.g. '90-1'); mutually exclusive with it")
    p.add_argument("--validation-date-range", default=None,
                   help="date range for the VALIDATION input's daily/ tree "
                        "(each input resolves its own range, as in the "
                        "reference)")
    p.add_argument("--validation-days-ago", default=None,
                   help="days-ago range for the validation input")
    p.add_argument("--save-feature-stats", action="store_true",
                   help="persist per-shard BasicStatisticalSummary to "
                        "<output-dir>/feature-stats/<shard>.json (reference: "
                        "Driver.calculateAndSaveFeatureShardStats)")
    p.add_argument("--task", default="logistic_regression",
                   choices=["logistic_regression", "linear_regression",
                            "poisson_regression", "smoothed_hinge_loss_linear_svm"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--config", default=None,
                   help="GameTrainingConfig JSON file (enables GAME path)")
    p.add_argument("--optimizer", default="lbfgs", choices=["lbfgs", "tron"])
    p.add_argument("--regularization", default="l2",
                   choices=["none", "l1", "l2", "elastic_net"])
    p.add_argument("--elastic-net-alpha", type=float, default=None)
    p.add_argument("--reg-weights", default="1.0",
                   help="comma-separated lambda sweep (legacy path)")
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--normalization", default="none",
                   choices=["none", "scale_with_standard_deviation",
                            "scale_with_max_magnitude", "standardization"])
    p.add_argument("--evaluators", default=None,
                   help="comma-separated, e.g. AUC,RMSE,PRECISION@K:10:userId")
    p.add_argument("--compute-variances", action="store_true")
    p.add_argument("--x64", action="store_true", help="float64 (parity runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' runs "
                        "on the host, as the parity tests do).  Without CUDA "
                        "and without --device cpu the run exits non-zero")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--mesh", default="auto",
                   help="'DxF' = a data x feature mesh of D*F ranks, one "
                        "process per rank; without --coordinator this "
                        "command starts the D*F local ranks itself, one per "
                        "visible card.  'auto' = every rank of a "
                        "--coordinator run on the data axis, else one "
                        "device; 'none' = one device")
    # multi-process runs (parallel/multihost.py): all three fall back to
    # $PHOTON_COORDINATOR / $PHOTON_NUM_PROCESSES / $PHOTON_PROCESS_ID
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address; process 0 listens there.  "
                        "Required when --num-processes > 1")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks in the run, one process each (the JAX "
                        "package counts hosts here)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes); rank 0 "
                        "writes every checkpoint and output")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default nccl on cuda, "
                        "gloo on the cpu).  NCCL needs a card per rank; "
                        "ranks that share a card must ask for gloo")
    p.add_argument("--data-validation", default="full",
                   choices=["full", "sample", "disabled"],
                   help="input sanity-check intensity (reference: "
                        "DataValidationType VALIDATE_FULL/SAMPLE/DISABLED)")
    p.add_argument("--no-weight-check", action="store_true",
                   help="allow rows with weights <= 0 (the cheap rejection "
                        "otherwise runs even under --data-validation "
                        "disabled, like the reference's separate checkData "
                        "flag)")
    # hyperparameter tuning (reference: GameTrainingParams tuning mode +
    # Driver.runHyperparameterTuning, cli/game/training/Driver.scala:337-373)
    p.add_argument("--tuning", default="none",
                   choices=["none", "random", "bayesian"])
    p.add_argument("--tuning-iterations", type=int, default=10)
    p.add_argument("--tuning-range", default="-3,3",
                   help="log10 lambda search range 'lo,hi' per coordinate")
    p.add_argument("--sweep-seed", type=int, default=None,
                   help="seed for the hyperparameter search (candidate "
                        "draws + GP slice sampler): a fixed seed reproduces "
                        "the candidate sequence bit-identically; default = "
                        "the training config's seed")
    p.add_argument("--warm-start", action="store_true",
                   help="initialize each grid combo / tuning refit from the "
                        "previous (best) model (reference: use-warm-start, "
                        "GameTrainingParams.scala:197)")
    p.add_argument("--event-listener", action="append", default=[],
                   help="dotted class path of an EventListener to register "
                        "(repeatable; reference: Driver.scala:108-118)")
    p.add_argument("--profile", action="store_true",
                   help="record a torch.profiler trace (CPU and CUDA "
                        "activities) of the training run into "
                        "<output-dir>/profile/trace.json; open at "
                        "https://ui.perfetto.dev")
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="arm the telemetry span tracer and write a Chrome-"
                        "trace/Perfetto JSON timeline of the fit (outer "
                        "iterations -> coordinate visits -> solves / chunk "
                        "staging / checkpoint writes, with fault/"
                        "quarantine/recovery events attached to their "
                        "spans); open at https://ui.perfetto.dev.  "
                        "Disarmed (the default) the instrumentation is a "
                        "module-global None check")
    p.add_argument("--run-log", default=None, metavar="RUN.jsonl",
                   help="JSONL run log: one line per finished span and "
                        "instant event (EventEmitter events, fault "
                        "injections, quarantine rollbacks, checkpoint "
                        "recoveries), correlated by span id with "
                        "--trace-out; arms the tracer like --trace-out")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX CLI's flags: the port has no "
                        "compile cache (its kernels are built once per "
                        "checkout)")
    p.add_argument("--model-format", default="npz",
                   choices=["npz", "avro", "reference"],
                   help="best-model output format; avro writes the "
                        "reference's BayesianLinearModelAvro / "
                        "LatentFactorAvro interchange records; reference "
                        "writes the Scala reference's own directory layout "
                        "(part-*.avro + id-info) that photon-ml itself "
                        "can load")
    p.add_argument("--initial-model-dir", default=None,
                   help="warm-start every coordinate this model covers "
                        "(npz, avro, or a reference-layout directory that "
                        "actual photon-ml wrote); beyond the reference, "
                        "whose warm start is intra-sweep only")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist the model after every outer coordinate-"
                        "descent iteration and resume from the latest "
                        "verified record on restart; sweeps checkpoint per "
                        "grid combo (the reference restarts failed jobs from "
                        "scratch)")
    p.add_argument("--hbm-budget", default=None,
                   help="device-memory residency budget, e.g. '8GB', "
                        "'512MB', or raw bytes.  When the training "
                        "coordinates' device blocks can't all fit: "
                        "fixed-effect shards over budget stream in double-"
                        "buffered host->device chunks, and inactive "
                        "coordinates' blocks are evicted between "
                        "coordinate-descent visits (out-of-core training).  "
                        "Overrides the config file's hbm_budget_bytes")
    p.add_argument("--timing-mode", default="pipelined",
                   choices=["pipelined", "strict"],
                   help="pipelined (default): each update's objective and "
                        "metrics stay on the device and are read back in "
                        "one copy per outer iteration.  strict: sync after "
                        "every update (same math bit for bit; per-phase "
                        "timings stay attributable to the device work they "
                        "launched)")
    p.add_argument("--fault-plan", default=None,
                   help="ARM FAULT INJECTION (testing/chaos runs only): "
                        "FaultPlan JSON (inline or @file) of named "
                        "injection sites x trigger hits/probabilities "
                        "(utils/faults.py; same format as the "
                        "PHOTON_FAULT_PLAN env var, which also works).  "
                        "With no plan the injection sites are no-ops.  On "
                        "SIGTERM/SIGINT the trainer exits RESUMABLY (status "
                        "75, EX_TEMPFAIL) after finishing the in-flight "
                        "coordinate update and making the newest checkpoint "
                        "durable")
    return p


def parse_mesh_arg(mesh_arg: str):
    """'auto' | 'none' | 'DxF' -> the string, or (D, F)."""
    if mesh_arg in ("auto", "none"):
        return mesh_arg
    d, _, f = mesh_arg.partition("x")
    try:
        shape = (int(d), int(f) if f else 1)
    except ValueError:
        shape = (0, 0)
    if min(shape) < 1:
        raise SystemExit(f"--mesh {mesh_arg!r}: expected 'auto', 'none' or "
                         "'DxF' with positive integers D and F")
    return shape


def make_mesh_from_arg(mesh_arg: str, device):
    """The run's mesh on `device`: 'none' -> None; 'auto' -> every rank on
    the data axis when a process group runs, else None; 'DxF' -> that mesh
    over the group's ranks (a 1x1 mesh needs no group)."""
    from photon_ml_tpu_torch.parallel import make_mesh, multihost
    shape = parse_mesh_arg(mesh_arg)
    if shape == "none" or (shape == "auto" and not multihost.group_started()):
        return None
    try:
        if shape == "auto":
            return make_mesh(device=device)
        return make_mesh(*shape, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {mesh_arg}: {e}")


def _multihost_requested(args) -> bool:
    from photon_ml_tpu_torch.parallel import multihost
    return (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None
            or bool(os.environ.get(multihost.ENV_COORDINATOR))
            or bool(os.environ.get(multihost.ENV_NUM_PROCESSES)))


def _spawn_shape(args):
    """(D, F) when this command must start the mesh's ranks itself: a
    'DxF' mesh of more than one rank and no multi-process identity."""
    shape = parse_mesh_arg(args.mesh)
    if isinstance(shape, tuple) and shape[0] * shape[1] > 1 \
            and not _multihost_requested(args):
        return shape
    return None


def _rank_device(device, process_id: int):
    """A rank's card: 'cuda' without an index means card
    process_id % visible cards (one per card when there are enough)."""
    import torch
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", process_id % max(torch.cuda.device_count(), 1))


def spawn_ranks(args, argv, shape) -> int:
    """`--mesh DxF` without a coordinator: start the D*F ranks as
    `cli.train` processes on a local coordinator (fresh interpreters, so
    no child inherits a CUDA context) and wait for them.  Rank 0's
    standard output is this command's; rank i's goes to
    <output-dir>/training.proc<i>.out.  If a rank fails, the others get
    the watchdog's grace to exit, then are stopped.  Returns rank 0's exit
    code, or the first failing rank's when rank 0 succeeded."""
    import subprocess
    import torch
    from photon_ml_tpu_torch.parallel import multihost
    n = shape[0] * shape[1]
    device = resolve_cli_device(args.device)
    backend = args.dist_backend or multihost.default_backend(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if n > cards:
            raise SystemExit(
                f"--mesh {args.mesh}: {n} NCCL ranks need {n} cards and "
                f"{cards} are visible (NCCL cannot run two ranks on one "
                "card); pass --dist-backend gloo to put several ranks on "
                "one card")
    os.makedirs(args.output_dir, exist_ok=True)
    base = list(sys.argv[1:] if argv is None else argv)
    coordinator = f"127.0.0.1:{multihost.free_port()}"
    env = multihost.child_env()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, outs = [], []
    try:
        for i in range(n):
            out = (None if i == 0 else open(os.path.join(  # photonlint: disable=PH014 -- the launcher is one process, before any rank exists: it opens rank i's own output file
                args.output_dir, f"training.proc{i}.out"), "w"))
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "photon_ml_tpu_torch.cli.train", *base,
                 "--coordinator", coordinator, "--num-processes", str(n),
                 "--process-id", str(i), "--dist-backend", backend],
                env=env, stdout=out))
        grace = (float(os.environ.get("PHOTON_HEARTBEAT_TIMEOUT", 10.0))
                 + float(os.environ.get("PHOTON_HEARTBEAT_ESCALATE", 10.0))
                 + 30.0)
        failed_at = None
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.returncode not in (None, 0)
                                         for p in procs):
                failed_at = time.time()
            if failed_at is not None and time.time() - failed_at > grace:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out in outs:
            if out is not None:
                out.close()
    codes = [p.returncode for p in procs]
    return codes[0] if codes[0] != 0 else next((c for c in codes if c), 0)


def resolve_avro_paths(path: str):
    """'.avro' file, directory of .avro files, or glob -> sorted paths, or
    None when `path` is not an Avro input.  A directory or glob that yields
    NO .avro files is an explicit error, not a silent fall-through."""
    import glob as _glob
    if os.path.isdir(path):
        found = sorted(_glob.glob(os.path.join(path, "*.avro")))
        if not found:
            raise SystemExit(f"no .avro files found in directory {path!r}")
        return found
    if "*" in path or "?" in path:
        found = sorted(p for p in _glob.glob(path) if p.endswith(".avro"))
        if not found:
            raise SystemExit(f"glob {path!r} matched no .avro files")
        return found
    if path.endswith(".avro"):
        return [path]
    return None


def _load_json_arg(arg: str):
    """Shared 'inline JSON or @file' convention for CLI JSON flags."""
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            return json.loads(f.read())
    return json.loads(arg)


def parse_input_columns(arg):
    """JSON column remap -> InputColumnNames (reference: InputColumnsNames
    remappable response/offset/weight/uid names)."""
    from photon_ml_tpu_torch.data.game_data import InputColumnNames
    if arg is None:
        return InputColumnNames()
    import dataclasses as _dc
    m = _load_json_arg(arg)
    allowed = {f.name for f in _dc.fields(InputColumnNames)}
    if not isinstance(m, dict) or not all(
            isinstance(v, str) and v for v in m.values()):
        raise SystemExit("--input-columns must be a JSON object mapping "
                         "column roles to non-empty string column names")
    bad = set(m) - allowed
    if bad:
        raise SystemExit(f"--input-columns: unknown keys {sorted(bad)} "
                         f"(allowed: {sorted(allowed)})")
    return InputColumnNames(**m)


def parse_feature_shard_map(arg):
    """JSON inline or @file -> {shard: [bags]}; default single-shard merge
    of the TrainingExampleAvro 'features' bag."""
    if arg is None:
        return {"global": ["features"]}
    m = _load_json_arg(arg)
    if not isinstance(m, dict) or not all(
            isinstance(v, list) and v for v in m.values()):
        raise SystemExit("--feature-shard-map must be a JSON object mapping "
                         "shard name -> non-empty list of bag fields")
    return m


def _load_dataset(path: str, task: str, args=None, train_dataset=None,
                  date_range=None, days_ago=None, pinned_maps=None):
    """`train_dataset` pins a validation read to the TRAINING feature/entity
    spaces: separately-scanned Avro validation data would otherwise build
    its own sorted vocabularies and silently misalign columns with the
    trained coefficients.  `date_range`/`days_ago` expand the path's
    daily/YYYY/MM/DD tree (each input resolves its own range, reference:
    GameDriver.pathsForDateRange)."""
    import glob as _glob

    from photon_ml_tpu_torch.data.game_data import (build_game_dataset,
                                                    load_game_dataset)
    from photon_ml_tpu_torch.data.libsvm import read_libsvm
    if path.endswith(".libsvm") or path.endswith(".txt"):
        if pinned_maps is not None:
            raise SystemExit(
                "a pinned feature space (--index-map-dir / "
                "--selected-features) requires Avro training input: LIBSVM "
                "features are positional, not (name, term)-keyed")
        x, y = read_libsvm(path)
        return build_game_dataset(y, {"global": x})
    if date_range or days_ago:
        from photon_ml_tpu_torch.data.date_range import paths_for_date_range
        day_dirs = paths_for_date_range(path, date_range, days_ago)
        # a day dir without .avro files (e.g. only a _SUCCESS marker) is
        # skipped, matching the reference's errorOnMissing=false posture;
        # only a range yielding NOTHING is an error
        avro_paths = []
        for d in day_dirs:
            avro_paths.extend(sorted(_glob.glob(os.path.join(d, "*.avro"))))
        if not avro_paths:
            raise SystemExit(
                f"no .avro files under any day directory of {path!r} "
                "for the requested date range")
    else:
        avro_paths = resolve_avro_paths(path)
    if avro_paths is not None:
        # reference: AvroDataReader.readMerged + GameConverters — the
        # primary input path of the GAME training job
        from photon_ml_tpu_torch.data.avro_game import read_game_examples
        shard_map = parse_feature_shard_map(
            getattr(args, "feature_shard_map", None) if args else None)
        id_cols = (getattr(args, "id_columns", None) or "") if args else ""
        if train_dataset is not None and not train_dataset.index_maps:
            # a libsvm/npz training input carries no (name,term) index maps,
            # so an Avro validation read has nothing to pin its columns to —
            # the scanned vocabulary would silently misalign with the
            # trained coefficients
            raise SystemExit(
                "Avro validation data requires the training input to carry "
                "feature index maps (train from Avro, or from an npz "
                "GameDataset saved with index maps); the training dataset "
                "has none, so validation columns cannot be aligned with the "
                "trained model's feature space")
        result = read_game_examples(
            avro_paths, shard_map,
            id_columns=[c for c in id_cols.split(",") if c],
            columns=parse_input_columns(
                getattr(args, "input_columns", None) if args else None),
            index_maps=(pinned_maps if pinned_maps is not None
                        else train_dataset.index_maps or None
                        if train_dataset is not None else None),
            entity_vocabs=(train_dataset.entity_vocabs or None
                           if train_dataset is not None else None))
        return result.dataset
    if pinned_maps is not None:
        raise SystemExit(
            "a pinned feature space (--index-map-dir / --selected-features) "
            "requires Avro training input; an npz GameDataset already "
            "carries its feature spaces")
    return load_game_dataset(path)


def parse_byte_size(arg) -> Optional[int]:
    """'8GB' / '512MB' / '1.5g' / '4096' -> bytes (decimal units, like
    accelerator spec sheets)."""
    if arg is None:
        return None
    s = str(arg).strip().lower()
    units = {"tb": 1e12, "t": 1e12, "gb": 1e9, "g": 1e9, "mb": 1e6,
             "m": 1e6, "kb": 1e3, "k": 1e3, "b": 1.0}
    for suffix, mult in units.items():
        if s.endswith(suffix):
            num = s[: -len(suffix)].strip()
            break
    else:
        num, mult = s, 1.0
    try:
        value = float(num) * mult
    except ValueError:
        raise SystemExit(f"--hbm-budget: cannot parse {arg!r} (expected "
                         "e.g. '8GB', '512MB', or raw bytes)")
    if value <= 0:
        raise SystemExit(f"--hbm-budget must be positive, got {arg!r}")
    return int(value)


def resolve_cli_device(name: str):
    """--device -> torch.device; exits non-zero when CUDA is asked for and
    absent (the run never carries on on the CPU)."""
    from photon_ml_tpu_torch import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    shape = _spawn_shape(args)
    if shape is not None:
        return spawn_ranks(args, argv, shape)
    # stderr stays quiet unless --verbose (configured only when no host
    # application has set up logging)
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(message)s", stream=sys.stderr)
        for h in logging.getLogger().handlers:
            h.setLevel(logging.INFO if args.verbose else logging.WARNING)
    # persisted job log: the package logger always captures INFO into
    # <output-dir>/training.log (reference: PhotonLogger)
    pkg_logger = logging.getLogger("photon_ml_tpu_torch")
    prev_level = pkg_logger.level
    pkg_logger.setLevel(logging.INFO)
    os.makedirs(args.output_dir, exist_ok=True)
    # a multi-process run shares one output dir: each non-primary process
    # logs to its own file
    from photon_ml_tpu_torch.parallel import multihost
    pid = (args.process_id if args.process_id is not None
           else multihost.process_index())
    _fh = logging.FileHandler(os.path.join(
        args.output_dir, "training.log" if pid == 0 else f"training.proc{pid}.log"))
    _fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    _fh.setLevel(logging.INFO)
    pkg_logger.addHandler(_fh)
    log = logging.getLogger("photon_ml_tpu_torch.train")
    try:
        return _run(args, log)
    finally:
        # main() is a callable API: don't leak this job's log handler into
        # the next in-process call, whatever stage raised
        pkg_logger.removeHandler(_fh)
        pkg_logger.setLevel(prev_level)
        _fh.close()


def _run(args, log) -> int:
    log.info("args: %s", vars(args))
    import torch
    device = resolve_cli_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    parse_mesh_arg(args.mesh)
    from photon_ml_tpu_torch.parallel import multihost
    try:
        return _run_ranked(args, log, device, dtype)
    finally:
        # teardown last (stops the watchdog, leaves the process group,
        # resets identity) so an in-process caller can run again
        multihost.shutdown()


def _join_run(args, log, device):
    """Multi-process bring-up (parallel/multihost.py) from the flags or
    their environment fallbacks, the watchdog armed, and the run's mesh.
    -> (device, mesh, watchdog)."""
    from photon_ml_tpu_torch.parallel import multihost
    watchdog = None
    if _multihost_requested(args):
        pid = (args.process_id if args.process_id is not None
               else multihost._env_int(multihost.ENV_PROCESS_ID) or 0)
        device = _rank_device(device, pid)
        try:
            multihost.initialize(args.coordinator, args.num_processes,
                                 args.process_id, backend=args.dist_backend,
                                 device=device)
        except multihost.MultihostInitError as e:
            raise SystemExit(f"multihost: {e}")
    if multihost.active():
        if args.tuning != "none":
            raise SystemExit(
                "--tuning is not supported on a multi-process run (nor in "
                "the JAX package's CLI); tune in a single-process job")
        if args.mesh == "none":
            raise SystemExit(
                "--mesh none contradicts a multi-process run: without a "
                "mesh each process would train its own local copy")
        watchdog = multihost.WorkerWatchdog(
            args.output_dir,
            interval_s=float(os.environ.get("PHOTON_HEARTBEAT_INTERVAL", 0.5)),
            timeout_s=float(os.environ.get("PHOTON_HEARTBEAT_TIMEOUT", 10.0)),
            escalate_s=float(os.environ.get("PHOTON_HEARTBEAT_ESCALATE", 10.0))
        ).start()
        multihost.set_watchdog(watchdog)
        log.info("multihost: process %d/%d, watchdog armed (timeout %.1fs, "
                 "escalate %.1fs)", multihost.process_index(),
                 multihost.process_count(), watchdog.timeout_s,
                 watchdog.escalate_s)
    mesh = make_mesh_from_arg(args.mesh, device)
    if mesh is not None:
        print(f"mesh: {mesh.shape} on {mesh.device} (rank {mesh.rank} of "
              f"{mesh.size}, backend {mesh.backend})", file=sys.stderr)
    return device, mesh, watchdog


def _run_ranked(args, log, device, dtype) -> int:
    from photon_ml_tpu_torch.parallel import multihost
    device, mesh, watchdog = _join_run(args, log, device)

    from photon_ml_tpu_torch.game import GameTrainingConfig

    t0 = time.time()
    pinned_maps = None
    if args.selected_features:
        # reference: the legacy trainer's selected-features file (GLMSuite
        # selectedFeaturesFile) — a FeatureAvro list freezing the feature
        # space to exactly those (name, term) keys + intercept
        if args.index_map_dir:
            raise SystemExit("--selected-features and --index-map-dir are "
                             "exclusive (both pin the feature space)")
        if args.feature_shard_map:
            raise SystemExit("--selected-features applies to the default "
                             "single-shard ingest only (the legacy trainer's "
                             "scope); build maps with cli.index for "
                             "multi-shard jobs")
        from photon_ml_tpu_torch.data.avro_codec import read_container
        from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
        keys = [feature_key(r["name"], r.get("term") or "")
                for r in read_container(args.selected_features)]
        if not keys:
            raise SystemExit(f"--selected-features {args.selected_features!r}"
                             " names no features")
        pinned_maps = {"global": IndexMap.from_keys(keys)}
        log.info("feature space restricted to %d selected features",
                 len(keys))
    if args.index_map_dir:
        # frozen shared feature space (reference: FeatureIndexingJob +
        # PalDBIndexMapLoader)
        from photon_ml_tpu_torch.data.index_map import IndexMapCollection
        pinned_maps = IndexMapCollection.load(args.index_map_dir).shards
        log.info("pinned feature spaces from %s: %s", args.index_map_dir,
                 {s: m.size for s, m in pinned_maps.items()})
    train = _load_dataset(args.train_data, args.task, args,
                          date_range=args.input_date_range,
                          days_ago=args.input_days_ago,
                          pinned_maps=pinned_maps)
    val = (_load_dataset(args.validation_data, args.task, args,
                         train_dataset=train,
                         date_range=args.validation_date_range,
                         days_ago=args.validation_days_ago)
           if args.validation_data else None)
    ingest_s = time.time() - t0
    log.info("loaded train: %d rows, shards %s", train.num_rows,
             {s: x.shape[1] for s, x in train.feature_shards.items()})
    print(f"loaded train: {train.num_rows} rows, shards "
          f"{ {s: x.shape[1] for s, x in train.feature_shards.items()} }",
          file=sys.stderr)

    # reference: Driver.run -> DataValidators.sanityCheckDataFrameForTraining
    # (the config file's task_type wins over --task on the GAME path)
    from photon_ml_tpu_torch.data.validators import validate_game_dataset
    task = args.task
    if args.config:
        with open(args.config) as f:
            task = GameTrainingConfig.from_json(f.read()).task_type
    validate_game_dataset(train, task, args.data_validation,
                          check_weights=not args.no_weight_check)
    if val is not None:
        validate_game_dataset(val, task, args.data_validation,
                              check_weights=not args.no_weight_check)

    if args.save_feature_stats and multihost.is_primary():
        # reference: cli/game/training/Driver.calculateAndSaveFeatureShardStats
        from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary
        stats_dir = os.path.join(args.output_dir, "feature-stats")
        os.makedirs(stats_dir, exist_ok=True)
        for shard, x in train.feature_shards.items():
            summary = (BasicStatisticalSummary.from_sparse(x, train.weights)
                       if hasattr(x, "tocsr") and not isinstance(x, np.ndarray)
                       else BasicStatisticalSummary.from_features(
                           np.asarray(x), train.weights))
            payload = summary.to_dict()
            imap = (train.index_maps or {}).get(shard)
            if imap is None:
                log.info("shard %r carries no index map: JSON stats only "
                         "(FeatureSummarizationResultAvro keys features by "
                         "name/term)", shard)
            else:
                payload["feature_keys"] = [str(k) for k in imap.index_to_key]
                from photon_ml_tpu_torch.data.avro_io import write_feature_stats_avro
                avro_dir = os.path.join(stats_dir, shard)
                os.makedirs(avro_dir, exist_ok=True)
                write_feature_stats_avro(
                    os.path.join(avro_dir, "part-00000.avro"), summary, imap)
            with open(os.path.join(stats_dir, f"{shard}.json"), "w") as f:
                json.dump(payload, f)
        log.info("feature stats saved to %s", stats_dir)

    # fault containment control plane (utils/faults.py): an env- or
    # flag-armed injection plan (chaos and test runs), and SIGTERM/SIGINT
    # graceful preemption: finish the in-flight coordinate update, make
    # the newest checkpoint durable, exit with the resumable status 75
    from photon_ml_tpu_torch.utils import faults
    fault_plan = faults.install_from_env()
    if args.fault_plan:
        fault_plan = faults.FaultPlan.from_dict(_load_json_arg(args.fault_plan))
        faults.install_plan(fault_plan)
        log.warning("fault plan ACTIVE from --fault-plan: %d spec(s)",
                    len(fault_plan.specs))

    # telemetry (photon_ml_tpu_torch/telemetry): the span tracer arms only
    # when a timeline was asked for; disarmed it is a module-global None
    # check on every instrumented path.  The metrics registry is always
    # live.  Kernel builds and loads are counted from here on
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.ops import _build
    loads0 = len(_build.LOADS)
    tracer = None
    if args.trace_out or args.run_log:
        tracer = telemetry.install(run_log=args.run_log, proc="train")
        log.info("telemetry armed: trace_out=%s run_log=%s",
                 args.trace_out, args.run_log)

    # event hooks (reference: Driver.scala:108-118 registers listeners by
    # class name; PhotonSetupEvent carries the run params)
    from photon_ml_tpu_torch.utils.events import EventEmitter, SetupEvent
    emitter = EventEmitter() if args.event_listener else None
    profiler = None
    try:
        if emitter is not None:
            for dotted in args.event_listener:
                emitter.register_listener_class(dotted)
            emitter.send_event(SetupEvent(params=vars(args)))
        if args.profile:
            os.makedirs(_profile_dir(args), exist_ok=True)
            profiler = _start_profiler(device)
            print(f"profiling to {_profile_dir(args)}", file=sys.stderr)
        with faults.GracefulPreemption():
            return _fit_and_save(args, log, train, val, device, dtype, t0,
                                 ingest_s, fault_plan, emitter, loads0, mesh)
    except faults.Preempted as e:
        # the in-flight update finished and the newest checkpoint record is
        # durable: report resumability and exit with the DISTINCT status 75
        # (EX_TEMPFAIL) so schedulers relaunch the same command
        payload = {
            "preempted": True,
            "completed_iterations": e.completed_iterations,
            "resumable": e.checkpointed,
            "checkpoint_dir": e.checkpoint_dir,
            "exit_status": faults.EXIT_PREEMPTED,
            "lost_worker": (watchdog.lost_process
                            if watchdog is not None else None),
            "wall_s": round(time.time() - t0, 2),
        }
        log.warning("preempted: %s", e)
        if multihost.is_primary():
            with open(os.path.join(args.output_dir,
                                   "training-summary.json"), "w") as f:
                json.dump(payload, f, indent=2)
        print(json.dumps(payload), flush=True)
        return faults.EXIT_PREEMPTED
    except Exception:
        # a peer died mid-collective: the backend raises in this thread
        # within milliseconds, before a heartbeat timeout has passed, so
        # poll the peers' heartbeats to tell a dead peer from a local
        # crash.  A survivor exits with the resumable status 75
        lost = watchdog.confirm_lost() if watchdog is not None else None
        if lost is not None:
            log.error("multihost: collective failed after losing worker "
                      "%d — exiting resumably (status %d)", lost,
                      faults.EXIT_PREEMPTED, exc_info=True)
            print(json.dumps({"preempted": True, "resumable": True,
                              "lost_worker": lost,
                              "exit_status": faults.EXIT_PREEMPTED}),
                  flush=True)
            return faults.EXIT_PREEMPTED
        raise
    finally:
        if profiler is not None:
            profiler.stop()
            profiler.export_chrome_trace(
                os.path.join(_profile_dir(args), "trace.json"))
        if tracer is not None:
            # export on EVERY path (success, preemption, failure): a
            # timeline of the run that died is the one you want most
            telemetry.shutdown()
            if args.trace_out:
                try:
                    info = telemetry.write_chrome_trace(args.trace_out)
                    log.info("chrome trace written: %s", info)
                    print(f"trace written to {args.trace_out} "
                          f"({info['events']} events) — open at "
                          "https://ui.perfetto.dev", file=sys.stderr)
                except Exception:
                    log.exception("trace export failed")
        # listeners flush buffered events in close(): run even when
        # training, validation or tuning raises
        if emitter is not None:
            emitter.clear_listeners()
        # main() is a callable API: the next in-process call starts
        # without this job's plan
        if fault_plan is not None:
            faults.install_plan(None)


def _profile_dir(args) -> str:
    return os.path.join(args.output_dir, "profile")


def _start_profiler(device):
    """A started torch.profiler over the CPU and, on a CUDA device, the
    CUDA activities (the port's counterpart of the JAX CLI's
    jax.profiler.trace)."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _fit_and_save(args, log, train, val, device, dtype, t0, ingest_s,
                  fault_plan, emitter, loads0, mesh=None) -> int:
    """Fit (GAME config or the legacy lambda sweep), save the best model
    and write the summary."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu_torch.game.config import (FixedEffectCoordinateConfig,
                                                 GLMOptimizationConfig)
    from photon_ml_tpu_torch.models.io import save_game_model
    from photon_ml_tpu_torch.ops import _build
    from photon_ml_tpu_torch.ops.normalization import NormalizationType
    from photon_ml_tpu_torch.optim.config import (OptimizerConfig, OptimizerType,
                                                  RegularizationContext,
                                                  RegularizationType)
    evaluator_specs = args.evaluators.split(",") if args.evaluators else None
    initial_model = None
    if args.initial_model_dir:
        # cross-job warm start: any supported layout loads here, including a
        # model directory actual photon-ml wrote; the model re-keys into
        # THIS job's feature spaces
        from photon_ml_tpu_torch.models.io import (align_game_model_to_dataset,
                                                   load_game_model,
                                                   load_model_index_maps)
        initial_model, _ = load_game_model(args.initial_model_dir,
                                           device=device, dtype=dtype)
        try:
            initial_model = align_game_model_to_dataset(
                initial_model,
                load_model_index_maps(args.initial_model_dir), train)
        except ValueError as e:
            raise SystemExit(f"--initial-model-dir: {e}")
        log.info("warm-starting from %s (%s)", args.initial_model_dir,
                 list(initial_model.coordinates))
    t_fit = time.time()
    hbm_budget = parse_byte_size(args.hbm_budget)
    if args.config:
        with open(args.config) as f:
            config = GameTrainingConfig.from_json(f.read())
        if hbm_budget is not None:
            config = dataclasses.replace(config, hbm_budget_bytes=hbm_budget)
        results = [GameEstimator(config, device=device, dtype=dtype,
                                 emitter=emitter, mesh=mesh).fit(
            train, val, evaluator_specs, initial_model=initial_model,
            checkpoint_dir=args.checkpoint_dir, timing_mode=args.timing_mode)]
    else:
        # legacy single-GLM path: one FE coordinate, lambda sweep, best by
        # first validation evaluator (reference: Driver stage machine +
        # ModelSelection)
        reg = RegularizationContext(RegularizationType(args.regularization),
                                    args.elastic_net_alpha)
        opt = OptimizerConfig(optimizer=OptimizerType(args.optimizer),
                              max_iterations=args.max_iterations,
                              tolerance=args.tolerance)
        weights = [float(w) for w in args.reg_weights.split(",")]
        grid = {"fixed": [GLMOptimizationConfig(optimizer=opt, regularization=reg,
                                                regularization_weight=w)
                          for w in sorted(weights, reverse=True)]}
        config = GameTrainingConfig(
            task_type=args.task,
            coordinates={"fixed": FixedEffectCoordinateConfig(
                "global", GLMOptimizationConfig(optimizer=opt, regularization=reg),
                normalization=NormalizationType(args.normalization))},
            updating_sequence=["fixed"], hbm_budget_bytes=hbm_budget)
        results = GameEstimator(config, device=device, dtype=dtype,
                                emitter=emitter, mesh=mesh).fit_grid(
            train, grid, val, evaluator_specs, warm_start=args.warm_start,
            checkpoint_dir=args.checkpoint_dir,
            initial_model=initial_model, timing_mode=args.timing_mode)
    tuning = None
    if args.tuning != "none":
        results, tuning = _tune(args, config, train, val, evaluator_specs,
                                initial_model, results, device, dtype,
                                emitter)
    fit_s = time.time() - t_fit

    from photon_ml_tpu_torch.game.estimator import select_best_result
    from photon_ml_tpu_torch.parallel import multihost
    best = select_best_result(results)
    t_save = time.time()
    if multihost.is_primary():
        # process 0 owns every durable artifact; the other ranks trained
        # the same model (their tables and histories are equal)
        save_game_model(best.model, os.path.join(args.output_dir, "best"),
                        config=best.config, index_maps=train.index_maps or None,
                        format=args.model_format)
    save_s = time.time() - t_save
    solver_diag = best.descent.solver_diagnostics()
    from photon_ml_tpu_torch.ops import hopper_kernels as hk, sparse_kernels as sk
    summary = {
        "task": args.task,
        "train_rows": train.num_rows,
        "ingest_s": round(ingest_s, 2),
        "num_configs": len(results),
        "final_objective": best.objective_history[-1],
        "validation": best.validation,
        # beyond the JAX summary: the histories of the selected fit
        "objective_history": list(best.objective_history),
        "validation_history": dict(best.descent.validation_history),
        "solver_iterations_total": best.descent.total_iterations(),
        "solver_diagnostics": solver_diag,
        # fault containment accounting: quarantine events (rollbacks,
        # tightened retries, freezes), coordinates left frozen, how the
        # checkpoint was recovered at resume, and on chaos runs the
        # injection plan's per-site fire counts
        "containment_events": best.descent.containment_events,
        "frozen_coordinates": best.descent.frozen_coordinates,
        "checkpoint_recovery": best.checkpoint_recovery,
        "fault_report": (fault_plan.report() if fault_plan is not None
                         else None),
        "wall_s": round(time.time() - t0, 2),
        "timing_mode": args.timing_mode,
        # HBM residency accounting (None budget = unbounded/resident)
        "hbm_budget_bytes": hbm_budget,
        "hbm_residency": best.residency,
        # the mesh, the bytes this rank staged (cold static data, warm
        # offsets and x0) and the run's processes
        "mesh": None if mesh is None else mesh.shape,
        "mesh_transfer": best.mesh_transfer,
        "multihost": ({"num_processes": multihost.process_count(),
                       "process_id": multihost.process_index()}
                      if multihost.active() else None),
        "host_blocked_s": round(best.descent.timings.host_blocked_total(), 3),
        # the kernel builds and library loads of this run (ops/_build.py
        # LOADS: nvcc runs and ctypes loads, the port's counterpart of the
        # JAX CLI's XLA compiles); the port has no compile cache (its
        # kernels are built once per checkout)
        "compile_s": round(sum(s for _, _, s in _build.LOADS[loads0:]), 2),
        "compile_count": len(_build.LOADS) - loads0,
        "compile_cache": None,
        # this process's hand-kernel launches (the wrappers' counts: the
        # fused kernel, kernels A and B by mode)
        "kernel_launches": {"fused": hk.LAUNCHES, **sk.LAUNCHES},
        # the unified telemetry surface: registry counters/gauges/
        # histograms (stream/store/checkpoint/quarantine/kernel-load
        # accounting) + tracer record counts when armed
        "telemetry": telemetry.snapshot(),
        "trace_out": args.trace_out,
        "output": os.path.join(args.output_dir, "best"),
        "device": str(device),
        "dtype": str(dtype).replace("torch.", ""),
        "fit_s": round(fit_s, 3),
        "save_s": round(save_s, 3),
        # the selected fit's phase spans (build/coordinates, per-update
        # solve/objective/validation, flushes), seconds
        "spans_s": {k: round(v, 4) for k, v in best.descent.timings.items()},
        # --tuning: the grid's and each searched candidate's values, the
        # candidates' parameter vectors, how many the GP chose, and the
        # search's host seconds outside the refits (the GP fit and the
        # acquisition over the candidate pool); None without --tuning
        "tuning": tuning,
    }
    if multihost.is_primary():
        with open(os.path.join(args.output_dir, "training-summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
    log.info("summary: %s", summary)
    for coord, d in solver_diag.items():
        log.info("solver %-16s solves=%d iterations=%d reasons=%s",
                 coord, d["solves"], d["iterations"], d["reasons"])
        if "stream" in d:
            st = d["stream"]
            log.info("stream %-16s staged=%.1f MB chunks=%d "
                     "local_epochs=%d examples=%d "
                     "examples/staged-byte=%.4f", coord,
                     st["total_bytes"] / 1e6, st["chunks_staged"],
                     st["local_epochs"], st["examples_processed"],
                     st["examples_per_staged_byte"])
    for name, t in best.descent.timings.items():
        log.info("phase %s: %.3fs", name, t)
    print(json.dumps(summary))
    return 0


def _tune(args, config, train, val, evaluator_specs, initial_model, results,
          device, dtype, emitter):
    """reference: Driver.runHyperparameterTuning — a searcher seeded with
    the grid results, each evaluation a refit with the candidate lambdas
    over the shared sweep state (hyperparameter/vectorized.py).  -> (grid
    results + the search's results, the summary's `tuning` record)."""
    if val is None:
        raise SystemExit("--tuning requires --validation-data")
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.hyperparameter import (
        GameEstimatorEvaluationFunction, GaussianProcessSearch, RandomSearch)
    fn = GameEstimatorEvaluationFunction(
        GameEstimator(config, device=device, dtype=dtype, emitter=emitter),
        train, val,
        evaluator_specs, scale="log", warm_start=args.warm_start,
        initial_model=initial_model)
    if args.warm_start:
        for r in results:
            if r.validation:
                fn.observe(r)
    lo, hi = (float(v) for v in args.tuning_range.split(","))
    ranges = [(lo, hi)] * fn.num_params
    spec0 = results[0].validation_specs[0]
    # --sweep-seed pins the WHOLE search chain (candidate draws, GP
    # estimator init, slice sampler) independently of the training seed
    sweep_seed = args.sweep_seed if args.sweep_seed is not None else config.seed
    kind = GaussianProcessSearch if args.tuning == "bayesian" else RandomSearch
    search_s, gp_chosen = [0.0], [0]

    class Timed(kind):
        """The searcher with its host seconds per candidate choice counted,
        and the choices its GP made (the observations outnumber the
        parameters)."""

        def next(self, last_candidate, last_value):
            t0 = time.perf_counter()
            try:
                return super().next(last_candidate, last_value)
            finally:
                search_s[0] += time.perf_counter() - t0
                gp_chosen[0] += len(getattr(self, "_points", ())) > self.num_params

    if args.tuning == "bayesian":
        search = Timed(ranges, fn, spec0.evaluator, seed=sweep_seed)
    else:
        search = Timed(ranges, fn, seed=sweep_seed)
    prior = [r for r in results if r.validation]
    found = search.find(args.tuning_iterations, prior)
    record = {"kind": args.tuning, "sweep_seed": sweep_seed,
              "prior_values": [fn.get_evaluation_value(r) for r in prior],
              "candidates": [fn.vectorize_params(r).tolist() for r in found],
              "values": [fn.get_evaluation_value(r) for r in found],
              "gp_chosen": gp_chosen[0], "search_host_s": round(search_s[0], 4)}
    return results + found, record


if __name__ == "__main__":
    raise SystemExit(main())
