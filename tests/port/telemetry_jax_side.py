"""The JAX side of the telemetry parity tests (test_torch_telemetry.py), run
in a subprocess of its own:

    python tests/port/telemetry_jax_side.py ROOT

With the JAX package's tracer armed, each on a fresh metrics registry, it
runs the fits of FITS — a 2-iteration fixed effect + per-user GAME fit
with a checkpoint directory, and the same fit with one poisoned per-user
solve — then cli.train with --trace-out, --run-log and --event-listener
on ROOT's npz files (outputs under ROOT/jax_out), and writes each fit's
`fit_record` and the CLI's summary line to ROOT/jax.json.  The traced
streamed fit and candidate-lane sweep run in the helpers that already
compile their programs (`game_jax_side.py stream`, `sweep_jax_side.py
sweep`), through the same `run_fit`.  The tracer's compile watch is off:
XLA compiles have no counterpart in the port's CPU run, whose kernel-load
counter stays at 0.  The record functions are plain Python over either
package's tracer, so the test applies them to the port's fits.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import game_jax_side as side
import sweep_jax_side as sweep_side

ROOT = Path(__file__).resolve().parents[2]

# the fits this script traces; "streamed" runs in game_jax_side.py's stream
# mode and "sweep" in sweep_jax_side.py (the result keys below)
FITS = ("checkpointed", "poisoned")
STREAMED_KEY, SWEEP_KEY = "res/streamed/telemetry", "telemetry/sweep"
# the sweep helper's candidate-lane case and all its candidates, whose
# programs that helper has compiled already
SWEEP_CASE = "l2"
# counters whose values depend on thread timing: `checkpoint.coalesced`
# (whether the writer thread was still busy when the next snapshot came)
TIMING_COUNTERS = ("checkpoint.coalesced",)
# the counter of the compile watch: XLA compiles in the JAX package, kernel
# builds and library loads in the port
RENAMED = {"jax.retraces": "kernel.builds_and_loads"}
# gauges whose values are timings: compared by name only
TIMING_GAUGES = ("train.host_blocked_s", "train.host_blocked_frac")


class RecordingListener:
    """An event listener for cli.train's --event-listener: records the
    names of the events it handles, and whether it was closed."""

    seen: list = []
    closed = False

    def handle(self, event) -> None:
        RecordingListener.seen.append(type(event).__name__)

    def close(self) -> None:
        RecordingListener.closed = True


def canonical(value):
    return json.loads(json.dumps(value, sort_keys=True))


def span_paths(tracer) -> dict:
    """span id -> the names from its thread's root span down to it."""
    by_id = {s.span_id: s for s in tracer.spans}
    out = {}
    for s in tracer.spans:
        names, cur = [], s
        while cur is not None:
            names.append(cur.name)
            cur = by_id.get(cur.parent_id)
        out[s.span_id] = "/".join(reversed(names))
    return out


def fit_record(tracer, snapshot: dict) -> dict:
    """A traced run without its times and ids: the spans as (path from the
    thread's root, attrs), the events as (name, path of their span, attrs)
    apart from `compile`, each sorted; the registry's counters (timing
    counters out, the compile-watch counter under its port name) and its
    gauges (timing gauges by name only)."""
    paths = span_paths(tracer)
    spans = sorted(([paths[s.span_id], canonical(s.attrs)] for s in tracer.spans),
                   key=json.dumps)
    events = sorted(([e["name"], paths.get(e["span"]), canonical(e["attrs"])]
                     for e in tracer.events if e["name"] != "compile"), key=json.dumps)
    counters = {RENAMED.get(k, k): v for k, v in snapshot["counters"].items()
                if k not in TIMING_COUNTERS}
    gauges = {k: (None if k in TIMING_GAUGES else v)
              for k, v in snapshot["gauges"].items()}
    return canonical({"spans": spans, "events": events, "counters": counters,
                      "gauges": gauges})


def write_inputs(root: Path, build_game_dataset, save_game_dataset) -> None:
    """The CLI's npz files and config."""
    train, val = side.containment_glmix(build_game_dataset)
    save_game_dataset(train, str(root / "cont_train.npz"))
    save_game_dataset(val, str(root / "cont_val.npz"))
    (root / "cont_config2.json").write_text(json.dumps(side.containment_config_dict(2)))


def cli_argv(root: Path, out: Path) -> list:
    """cli.train's arguments (without the listener and device flags): the
    2-iteration containment fit, traced, with its outputs under `out`."""
    d = lambda *p: str(root.joinpath(*p))
    return ["--train-data", d("cont_train.npz"), "--validation-data", d("cont_val.npz"),
            "--config", d("cont_config2.json"), "--evaluators", "AUC", "--mesh", "none",
            "--no-compile-cache", "--x64", "--output-dir", str(out / "cli"),
            "--trace-out", str(out / "trace.json"), "--run-log", str(out / "run.jsonl")]


def run_fit(name: str, pkg: dict, out: Path, budget: int, **device):
    """One of FITS through `pkg` (the package's GameEstimator,
    GameTrainingConfig, build_game_dataset, SweepEvaluator, faults) under
    an armed tracer, checkpointing under `out` (the package's own); -> the
    tracer.  `device` carries the port's device/dtype keywords."""
    telemetry, faults = pkg["telemetry"], pkg["faults"]
    Est, Cfg = pkg["GameEstimator"], pkg["GameTrainingConfig"]
    build = pkg["build_game_dataset"]
    with telemetry.enabled(watch_compiles=False) as tracer:
        if name in ("checkpointed", "poisoned"):
            train, val = side.containment_glmix(build)
            est = Est(Cfg.from_dict(side.containment_config_dict(2)), **device)
            plan = side.POISON_PLAN if name == "poisoned" else {"faults": []}
            with faults.injected(faults.FaultPlan.from_dict(plan)):
                est.fit(train, val, ["AUC"], checkpoint_dir=str(out / f"ckpt_{name}"))
        elif name == "streamed":
            train, val = pkg["pipeline_dataset"]()
            Est(Cfg.from_dict(side.stream_config_dict(budget)), **device).fit(
                train, val, ["AUC"])
        else:
            train, val = sweep_side.sweep_data(build)
            sweep = pkg["SweepEvaluator"](
                Est(Cfg.from_dict(sweep_side.sweep_config_dict(SWEEP_CASE)), **device),
                train, val, ["AUC"])
            sweep.evaluate_vmapped([Cfg.from_dict(d) for d in sweep_side.candidate_dicts(
                SWEEP_CASE, sweep_side.vmap_weights())])
    return tracer


def jax_package() -> dict:
    """run_fit's `pkg` for the JAX package (in a JAX side's process)."""
    from photon_ml_tpu import telemetry
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu.hyperparameter import SweepEvaluator
    from photon_ml_tpu.utils import faults
    sys.path.insert(0, str(ROOT))
    from bench import _pipeline_dataset
    return {"telemetry": telemetry, "faults": faults, "GameEstimator": GameEstimator,
            "GameTrainingConfig": GameTrainingConfig,
            "build_game_dataset": build_game_dataset, "SweepEvaluator": SweepEvaluator,
            "pipeline_dataset": lambda: _pipeline_dataset(
                side.RES_N, side.RES_DG, side.RES_USERS, side.RES_DU, side.RES_SEED)}


def traced_record(name: str, out: Path, budget=None) -> str:
    """run_fit through the JAX package on a fresh default registry -> its
    fit_record as JSON (the other helpers store it in their npz)."""
    from photon_ml_tpu.telemetry import metrics
    metrics._DEFAULT = None
    tracer = run_fit(name, jax_package(), out, budget)
    return json.dumps(fit_record(tracer, metrics.default_registry().snapshot()))


def main(argv) -> int:
    root = Path(argv[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import contextlib
    import io
    from photon_ml_tpu.cli import train as train_cli
    from photon_ml_tpu.telemetry import metrics
    out = {name: json.loads(traced_record(name, root / "jax_out")) for name in FITS}
    metrics._DEFAULT = None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(cli_argv(root, root / "jax_out") + [
            "--event-listener", "photon_ml_tpu.utils.events.LoggingEventListener"])
    out["cli"] = {"rc": rc, "summary": json.loads(buf.getvalue().strip().splitlines()[-1])}
    (root / "jax.json").write_text(json.dumps(out))
    return 0


def run_jax_side(root: Path) -> dict:
    """Run this script in a fresh process over `root`; its results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(Path(__file__).resolve().parent)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(root)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side failed:\n{proc.stderr[-4000:]}")
    return json.loads((root / "jax.json").read_text())


if __name__ == "__main__":
    sys.exit(main(sys.argv))
