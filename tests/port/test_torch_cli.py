"""Port cli.train / cli.score / cli.index == the JAX package's CLIs.

The same jobs (game_jax_side.cli_jobs) over the same inputs: the legacy
single-GLM path from npz (a lambda sweep with validation) and from LIBSVM
(elastic net, Avro model output), the --config GAME path from npz (also
followed by --tuning random, and by --tuning bayesian --warm-start
--sweep-seed 7) and from Avro pinned by cli.index's maps (reference-layout
output), and cli.score
to npz (with predictions) and to ScoringResultAvro.  The JAX side runs
them once, in a subprocess (f64 CPU, `--x64`); the port runs them in this
process with `--device cpu --x64`.  Tolerances: final objectives and
validation metrics within 1e-10 relative, the same configurations and
row counts, index maps equal, saved models scoring within 1e-9 relative
of each other and the scores written by cli.score likewise.  Then the
port's own flags: every flag of a subsystem not ported yet exits naming
its ROADMAP item, each telemetry flag does its work, and without CUDA the
default device exits non-zero.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.cli import index as index_cli
from photon_ml_tpu_torch.cli import score as score_cli
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.data.avro_game import write_game_examples
from photon_ml_tpu_torch.data.avro_io import read_scores_avro
from photon_ml_tpu_torch.data.game_data import (build_game_dataset, load_game_dataset,
                                                save_game_dataset)
from photon_ml_tpu_torch.data.index_map import IndexMapCollection, build_index_map
from photon_ml_tpu_torch.data.synthetic_bench import (make_a1a_like, make_movielens_like,
                                                      movielens_shards)
from photon_ml_tpu_torch.game.config import GameTrainingConfig
from photon_ml_tpu_torch.models.io import load_game_model

MODULES = {"train": train_cli, "index": index_cli, "score": score_cli}
REL = 1e-10


def _write_inputs(root):
    train, val = side.movielens_glmix(build_game_dataset, make_movielens_like,
                                      movielens_shards)
    save_game_dataset(train, str(root / "train.npz"))
    save_game_dataset(val, str(root / "val.npz"))
    (root / "config.json").write_text(
        GameTrainingConfig.from_dict(side.glmix_config_dict()).to_json())
    x, y = make_a1a_like(1, "logistic", seed=8)
    with open(root / "a1a.libsvm", "w") as f:
        for row, label in zip(x[:800, :-1], y[:800]):
            cols = np.flatnonzero(row)
            f.write(("+1" if label > 0.5 else "-1") + "".join(
                f" {j + 1}:{row[j]:g}" for j in cols) + "\n")
    maps = {"globalFeatures": build_index_map([(f"g{j:02d}", "") for j in range(31)]),
            "userFeatures": build_index_map([(f"u{j:02d}", "") for j in range(19)])}
    for split, ds in (("train", train), ("val", val)):
        (root / "avro" / split).mkdir(parents=True)
        users = np.asarray(ds.entity_vocabs["userId"])[ds.entity_indices["userId"]]
        bounds = (0, ds.num_rows // 2, ds.num_rows)
        for p in range(2):
            rows = np.arange(bounds[p], bounds[p + 1])
            write_game_examples(
                str(root / "avro" / split / f"part-{p:05d}.avro"), ds.response[rows],
                {"globalFeatures": (ds.feature_shards["global"][rows],
                                    maps["globalFeatures"]),
                 "userFeatures": (ds.feature_shards["per_user"][rows],
                                  maps["userFeatures"])},
                id_values={"userId": users[rows]})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (root, {job: (port JSON, JAX JSON)})."""
    root = tmp_path_factory.mktemp("cli")
    _write_inputs(root)
    jax = side.run_jax_side("cli", root / "jax.npz")
    out = {}
    for name, kind, argv in side.cli_jobs(root):
        argv = side.cli_job_argv(name, kind, argv, root / "port_out")
        if kind == "train":
            argv += ["--device", "cpu"]
        elif kind == "score":
            argv += ["--device", "cpu", "--x64"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert MODULES[kind].main(argv) == 0
        assert int(jax[f"{name}/rc"]) == 0
        out[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                     json.loads(str(jax[f"{name}/json"])))
    return root, out


TRAIN_JOBS = [n for n, k, _ in side.cli_jobs(side.ROOT) if k == "train"]


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("name", TRAIN_JOBS)
def test_train_summaries_match_jax(runs, name):
    port, jax = runs[1][name]
    assert _rel(port["final_objective"], jax["final_objective"]) <= REL
    assert sorted(port["validation"]) == sorted(jax["validation"])
    for k, v in jax["validation"].items():
        assert _rel(port["validation"][k], v) <= REL
    for key in ("task", "train_rows", "num_configs", "timing_mode"):
        assert port[key] == jax[key], key
    assert sorted(port["solver_diagnostics"]) == sorted(jax["solver_diagnostics"])
    for key in set(jax) - {"ingest_s", "wall_s", "host_blocked_s", "output"}:
        assert key in port, key
    assert port["timing_mode"] == "pipelined"
    assert port["mesh"] is None
    # the telemetry snapshot's instruments are the JAX CLI's; no kernel is
    # built or loaded on the CPU
    assert sorted(port["telemetry"]["metrics"]) == sorted(jax["telemetry"]["metrics"])
    assert port["compile_count"] == 0 and port["compile_s"] == 0.0
    # residency accounting (always kept; it evicts only under a budget)
    for key in ("hbm_budget_bytes", "hbm_residency"):
        assert port[key] == jax[key], key
    for key in ("containment_events", "frozen_coordinates", "checkpoint_recovery",
                "fault_report"):
        assert port[key] == jax[key], key


def _val_dataset(root, name):
    """The validation rows in the job's feature space."""
    if name == "game_avro":
        from photon_ml_tpu_torch.cli.score import _load_scoring_data
        model, _ = load_game_model(str(root / "port_out" / name / "best"), device="cpu",
                                   dtype=torch.float64)
        args = score_cli.build_parser().parse_args(
            ["--model-dir", "m", "--output", "o", "--data", str(root / "avro" / "val"),
             "--feature-shard-map", side.CLI_SHARD_MAP, "--id-columns", "userId"])
        return _load_scoring_data(args, model, str(root / "port_out" / name / "best"))[0]
    if name == "legacy_libsvm":
        from photon_ml_tpu_torch.data.libsvm import read_libsvm
        x, y = read_libsvm(str(root / "a1a.libsvm"))
        return build_game_dataset(y, {"global": x})
    return load_game_dataset(str(root / "val.npz"))


@pytest.mark.parametrize("name", TRAIN_JOBS)
def test_saved_models_score_alike(runs, name):
    """Each package's saved `best` model, loaded by the port, scores the
    validation rows within 1e-9 relative of the other's."""
    root = runs[0]
    ds = _val_dataset(root, name)
    scores = []
    for who in ("port_out", "jax_out"):
        model, _ = load_game_model(str(root / who / name / "best"), device="cpu",
                                   dtype=torch.float64)
        scores.append(model.score_dataset(ds).numpy())
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-9,
                               atol=1e-9 * np.abs(scores[1]).max())


def test_index_maps_match_jax(runs):
    root, jobs = runs
    port, jax = jobs["index"]
    assert port["shards"] == jax["shards"] and port["files_scanned"] == jax["files_scanned"]
    a, b = (IndexMapCollection.load(str(root / who / "index")).shards
            for who in ("port_out", "jax_out"))
    assert {s: list(m.index_to_key) for s, m in a.items()} == \
        {s: list(m.index_to_key) for s, m in b.items()}


@pytest.mark.parametrize("name", ["score_npz", "score_avro"])
def test_scores_match_jax(runs, name):
    root = runs[0]
    port, jax = runs[1][name]
    assert port["rows"] == jax["rows"] and port["format"] == jax["format"]
    for k, v in jax["evaluation"].items():
        assert _rel(port["evaluation"][k], v) <= REL, k
    if name == "score_npz":
        p, j = (np.load(root / who / "score_npz.npz") for who in ("port_out", "jax_out"))
        for key in ("scores", "predictions"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-9,
                                       atol=1e-9 * np.abs(j[key]).max())
    else:
        (ps, pl, prec), (js, jl, jrec) = (read_scores_avro(str(root / who / "score_avro.avro"))
                                          for who in ("port_out", "jax_out"))
        np.testing.assert_allclose(ps, js, rtol=1e-9, atol=1e-9 * np.abs(js).max())
        np.testing.assert_array_equal(pl, jl)
        assert [r["modelId"] for r in prec] == [r["modelId"] for r in jrec]


# flags that exited naming item 20 until multi-GPU training was ported:
# they now reach the multi-process layer, which exits naming what is wrong
# with a bad invocation before any process group starts (their runs:
# test_torch_multihost.py)
UNPORTED = {
    "--coordinator": (["--coordinator", "nohost", "--num-processes", "2",
                       "--process-id", "0"], "HOST:PORT"),
    "--num-processes": (["--num-processes", "2"], "requires a coordinator"),
    "--process-id": (["--process-id", "3", "--num-processes", "2",
                      "--coordinator", "127.0.0.1:1"], "out of range"),
    "--mesh 2x1": (["--mesh", "2x1", "--dist-backend", "nccl"], "NCCL ranks need"),
}


@pytest.mark.parametrize("flag", list(UNPORTED))
def test_unported_flags_exit_naming_their_item(tmp_path, flag):
    from photon_ml_tpu_torch.parallel import multihost
    extra, message = UNPORTED[flag]
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--train-data", "x.npz", "--output-dir", str(tmp_path),
                        "--device", "cpu", *extra])
    assert message in str(e.value)
    assert not multihost.group_started()


TELEMETRY_FLAGS = ("--event-listener", "--trace-out", "--run-log", "--profile")


@pytest.fixture(scope="module")
def telemetry_run(runs, tmp_path_factory):
    """The legacy LIBSVM job (one fit) with the four flags that exited
    naming item 19 before the port had telemetry: -> (output root, the
    summary, the events the listener saw)."""
    import telemetry_jax_side as tj
    out = tmp_path_factory.mktemp("telemetry_flags")
    name, kind, argv = next(j for j in side.cli_jobs(runs[0]) if j[0] == "legacy_libsvm")
    tj.RecordingListener.seen.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_cli.main(side.cli_job_argv(name, kind, argv, out) + [
            "--device", "cpu", "--event-listener", "telemetry_jax_side.RecordingListener",
            "--trace-out", str(out / "trace.json"), "--run-log", str(out / "run.jsonl"),
            "--profile"]) == 0
    return out, json.loads(buf.getvalue().strip().splitlines()[-1]), list(
        tj.RecordingListener.seen)


@pytest.mark.parametrize("flag", TELEMETRY_FLAGS)
def test_telemetry_flags_work(runs, telemetry_run, flag):
    """Each flag does its work, and the fit is the untraced job's."""
    from photon_ml_tpu_torch.telemetry import distributed, export
    out, summary, seen = telemetry_run
    assert summary["final_objective"] == runs[1]["legacy_libsvm"][0]["final_objective"]
    if flag == "--event-listener":
        assert seen == ["SetupEvent", "TrainingStartEvent", "OptimizationLogEvent",
                        "TrainingFinishEvent"]
    elif flag == "--trace-out":
        assert summary["trace_out"] == str(out / "trace.json")
        trace = json.loads((out / "trace.json").read_text())
        assert export.validate_chrome_trace(trace) == []
        assert {"fit", "outer_iteration", "coordinate_visit", "solve"} <= \
            {e["name"] for e in trace["traceEvents"]}
    elif flag == "--run-log":
        log = distributed.parse_run_log(str(out / "run.jsonl"))
        assert len(log["spans"]) == summary["telemetry"]["tracer"]["spans"] > 0
    else:
        assert (out / "legacy_libsvm" / "profile" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("name,kind,iterations", [("game_tuning_random", "random", 3),
                                                   ("game_tuning_bayesian", "bayesian", 4)])
def test_tuning_summary_records_the_search(runs, name, kind, iterations):
    """--tuning (formerly exiting naming item 17): the grid's fit plus the
    searched candidates, and the port's record of the search: the seed (the
    config's unless --sweep-seed), one vector per candidate, each
    candidate's validation value, the GP's choices (the observations
    outnumber the two parameters from the third candidate on)."""
    port, jax = runs[1][name]
    assert port["num_configs"] == jax["num_configs"] == 1 + iterations
    tun = port["tuning"]
    assert tun["kind"] == kind and tun["sweep_seed"] == (7 if kind == "bayesian" else 11)
    assert len(tun["candidates"]) == len(tun["values"]) == iterations
    assert all(len(c) == 2 and all(-3 <= v <= 3 for v in c) for c in tun["candidates"])
    assert tun["gp_chosen"] == (iterations - 2 if kind == "bayesian" else 0)
    assert port["validation"]["AUC"] == max(tun["prior_values"] + tun["values"])
    assert tun["search_host_s"] >= 0
    assert runs[1]["game_npz"][0]["tuning"] is None


@pytest.mark.parametrize("arg,want", [("8GB", 8_000_000_000), ("512mb", 512_000_000),
                                     ("1.5g", 1_500_000_000), ("4096", 4096)])
def test_formerly_unported_hbm_budget_parses(arg, want):
    """--hbm-budget exited naming its item until out-of-core training was
    ported; its runs are the *_hbm jobs above."""
    assert train_cli.parse_byte_size(arg) == want
    for bad in ("lots", "-1GB"):
        with pytest.raises(SystemExit, match="--hbm-budget"):
            train_cli.parse_byte_size(bad)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("module", ["train", "score"])
def test_default_device_exits_without_cuda(tmp_path, module):
    argv = (["--train-data", "x.npz", "--output-dir", str(tmp_path)] if module == "train"
            else ["--model-dir", str(tmp_path), "--data", "x.npz", "--output", "s"])
    with pytest.raises(SystemExit) as e:
        MODULES[module].main(argv)
    assert "CUDA" in str(e.value) and e.value.code not in (0, None)
    assert not os.path.exists(tmp_path / "best")
