"""The JAX side of the health, refit and fleet parity tests
(test_torch_health.py, test_torch_refit.py, test_torch_fleet.py), run in a
subprocess of its own, one per test module:

    python tests/port/fleet_jax_side.py health|refit|fleet ROOT

`health` runs the streaming statistics on seeded streams and the
ScoringService(health=...) walk below.  `refit` compacts the feedback lane
under ROOT/lane (which the test writes first) from scratch and on top of
the port's partial store, runs `cli.refit` on it, and loads the port's
candidate directory.  `fleet` writes a replication log through the JAX
package's FleetPublisher (with a compaction snapshot), joins a JAX replica
to it and to the port's log under ROOT/port_log, and resumes a JAX replica
from the port replica's state directory.  Results go to ROOT/<mode>.pkl
(one pickled dict), with JAX on the CPU in float64.  The scenario runners
take either package's classes (`pkg`), so the tests run the same code on
the port.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import online_jax_side as oj

ROOT = Path(__file__).resolve().parents[2]

# the health walk: small windows, so that a few batches close them
HEALTH = dict(window_labels=32, window_scores=256, baseline_scores=256,
              sustain_windows=2, recovery_windows=2,
              rollback_on=("calibration",))
UPDATES = dict(micro_batch=8, max_iterations=200, tolerance=1e-12)
# the refit lane: LANE_BATCHES feedback batches of LANE_ROWS rows, sealed
# in chunks of CHUNK_ROWS; the port's partial store covers PREFIX_SEQS
LANE_BATCHES, LANE_ROWS, CHUNK_ROWS, PREFIX_SEQS = 6, 24, 32, 3
REFIT_VERSION = "cand"


# -- the health statistics (host numpy) ---------------------------------------

def health_stats(pkg) -> dict:
    """Seeded (probability, label) and score streams through the streaming
    calibration and the drift detector, chunked unevenly."""
    rng = np.random.default_rng(5)
    cal = pkg["StreamingCalibration"](10)
    out = {"calibration": [], "drift": []}
    for n in (7, 50, 1, 130, 64):
        p = rng.uniform(size=n)
        y = (rng.uniform(size=n) < p ** 1.3).astype(float)
        cal.update(p, y)
        r = cal.report()
        out["calibration"].append({**r.to_dict(), "expected_pos": r.expected_pos,
                                   "observed_neg": r.observed_neg})
    out["calibration_taken"] = cal.take().to_dict()
    det = pkg["DriftDetector"](10, 200)
    for shift, n in ((0.0, 150), (0.0, 90), (0.0, 160), (0.8, 100), (0.0, 33)):
        det.observe(rng.normal(size=n) + shift)
        w = det.take()
        out["drift"].append(None if w is None else
                            {**w.to_dict(), "fractions": w.fractions})
    return out


# -- the health walk (either package) -----------------------------------------

def _rows(seed: int, n: int, shift: float = 0.0):
    rng = np.random.default_rng(seed)
    feats = {"global": rng.normal(size=(n, oj.D_G)) + shift,
             "per_user": rng.normal(size=(n, oj.D_U))}
    ids = {"userId": np.asarray([f"u{rng.integers(0, oj.N_ENT)}"
                                 for _ in range(n)], dtype=object)}
    return feats, ids, rng


def _labels_from(svc, feats, ids, rng, flip: bool):
    """Labels drawn from the live model's own probabilities (calibrated),
    or their complement (the label flip a calibration gate must catch)."""
    z = np.asarray(svc.registry.scorer.score(feats, ids).scores, np.float64)
    p = 1.0 / (1.0 + np.exp(-z))
    y = (rng.uniform(size=len(z)) < p).astype(float)
    return 1.0 - y if flip else y


def health_walk(pkg, host) -> dict:
    """ScoringService(health=..., updates=...): a clean baseline, calibrated
    feedback published as deltas, a shifted feature stream (drift), flipped
    labels (calibration, which rolls the deltas back), then clean traffic
    until every gate recovers.  The verdict, the pause state and the table
    hashes are recorded after every step."""
    svc = pkg["ScoringService"](
        model=oj.build_model(pkg, oj.model_arrays()),
        config=pkg["serving_config"](max_batch=64, min_bucket=64),
        updates=pkg["OnlineUpdateConfig"](**UPDATES), start_updater=False,
        health=pkg["HealthConfig"](**HEALTH))
    steps = []

    def record(name):
        v = svc.health.verdict()
        steps.append({
            "step": name, "status": v["status"],
            "tripped": sorted(g for g, s in v["gates"].items() if s["tripped"]),
            "trips": {g: s["trips"] for g, s in v["gates"].items()},
            "values": {g: s["value"] for g, s in v["gates"].items()},
            "windows": v["windows_evaluated"], "rollbacks": v["rollbacks"],
            "paused_by_health": v["updates_paused_by_health"],
            "updater_paused": svc.healthz()["updater"]["paused"],
            "pending_deltas": svc.registry.pending_deltas(),
            "healthz_status": svc.healthz()["status"],
            "hashes": svc.registry.scorer.table_hashes()})

    def score(seed, shift=0.0):
        for k in range(8):
            feats, ids, _ = _rows(seed + k, 64, shift)
            svc.score(feats, ids)

    def feedback(seed, flip):
        for k in range(2):
            feats, ids, rng = _rows(seed + k, 32)
            svc.feedback(feats, ids, _labels_from(svc, feats, ids, rng, flip))

    try:
        hashes0 = svc.registry.scorer.table_hashes()
        score(100)
        record("baseline")
        feedback(200, flip=False)
        svc.updater.flush()
        record("calibrated_feedback")
        score(300, shift=3.0)
        record("shifted_scores")
        feedback(400, flip=True)
        record("flipped_labels")
        score(500)
        record("clean_scores")
        feedback(600, flip=False)
        record("clean_feedback")
        health = svc.metrics_snapshot()["health"]
        return {"steps": steps, "hashes0": hashes0,
                "metrics": {k: health[k] for k in (
                    "label_windows", "score_windows", "labels", "breaches",
                    "gate_trips", "recoveries", "rollbacks",
                    "evaluate_skipped")}}
    finally:
        svc.close()


# -- the refit lane and its stores (either package) ---------------------------

def write_lane(pkg, lane_dir) -> None:
    """LANE_BATCHES feedback records with fixed wall times, labels drawn
    from the NEGATED model (the drift a refit must learn)."""
    neg = oj.model_arrays()
    log = pkg["FeedbackLog"](str(lane_dir))
    for b in range(LANE_BATCHES):
        feats, ids, rng = _rows(700 + b, LANE_ROWS)
        rows = [int(u[1:]) for u in ids["userId"]]
        z = -(feats["global"] @ neg["fe"]
              + np.einsum("nd,nd->n", feats["per_user"], neg["re"][rows]))
        labels = (rng.uniform(size=LANE_ROWS) < 1 / (1 + np.exp(-z))).astype(float)
        log.append(pkg["record_for_feedback"](
            feats, ids, labels, np.ones(LANE_ROWS), np.full(LANE_ROWS, 0.1),
            event_ids=[f"e{b}-{i}" for i in range(LANE_ROWS)],
            trace_id=f"t{b}", wall_s=2000.0 + b))


class PrefixLog:
    """The lane as it stood at seq `upto`: a compactor reading it seals
    only what those records hold (the store a crash or an earlier run
    leaves behind)."""

    def __init__(self, log, upto: int):
        self.log, self.upto = log, upto

    def read(self, after: int = 0):
        return [e for e in self.log.read(after) if int(e["log_seq"]) <= self.upto]


def compact(pkg, lane_dir, out_dir, upto=None) -> dict:
    log = pkg["FeedbackLog"](str(lane_dir))
    src = log if upto is None else PrefixLog(log, upto)
    comp = pkg["LogCompactor"](src, str(out_dir),
                               pkg["CompactorConfig"](chunk_rows=CHUNK_ROWS))
    return comp.compact()


def store_bytes(out_dir) -> dict:
    """Every file of a chunk store, by name."""
    return {p.name: p.read_bytes() for p in sorted(Path(out_dir).iterdir())}


def run_cli_refit(refit_cli, argv) -> tuple:
    """cli.refit's main in-process -> (exit code, its result line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = refit_cli.main([str(a) for a in argv])
    return rc, out.getvalue().strip().splitlines()[-1]


def refit_argv(root, who: str) -> list:
    return ["--model-dir", root / "model", "--feedback-log", root / "lane",
            "--chunks", root / f"{who}_cli_chunks",
            "--model-root", root / f"{who}_models",
            "--chunk-rows", CHUNK_ROWS, "--version", REFIT_VERSION]


# -- the fleet log (either package) -------------------------------------------

def _fleet_feedback(svc, seed, n=16):
    feats, ids, rng = _rows(seed, n)
    svc.feedback(feats, ids, (rng.uniform(size=n) < 0.5).astype(float))
    svc.updater.flush()


def publish_log(pkg, root, log_dir) -> dict:
    """A publisher over root/model: deltas, a swap to root/model_b, more
    deltas, a compaction snapshot, a delta-aware rollback and a last delta.
    Returns the publisher's audit."""
    svc = pkg["ScoringService"](
        model_dir=str(root / "model"),
        config=pkg["serving_config"](max_batch=64, min_bucket=64),
        updates=pkg["OnlineUpdateConfig"](**UPDATES), start_updater=False)
    try:
        log = pkg["ReplicationLog"](str(log_dir), segment_records=3)
        pkg["FleetPublisher"](svc, log, model_dir=str(root / "model"))
        _fleet_feedback(svc, 800)
        _fleet_feedback(svc, 801)
        svc.swap(str(root / "model_b"))
        _fleet_feedback(svc, 802)
        log.compact(log.head_seq())
        _fleet_feedback(svc, 803)
        svc.rollback()
        _fleet_feedback(svc, 804)
        return {"audit": svc.audit(), "head": log.head_seq()}
    finally:
        svc.close()


def join_replica(pkg, root, log_dir, state_dir) -> dict:
    """A replica over root/model joined to `log_dir` (resuming from
    `state_dir` when it holds an applied.json) -> its join info + audit."""
    svc = pkg["ScoringService"](
        model_dir=str(root / "model"),
        config=pkg["serving_config"](max_batch=64, min_bucket=64))
    try:
        rep = pkg["Replica"](svc, pkg["ReplicationLog"](str(log_dir)),
                             str(state_dir))
        info = rep.join()
        with open(Path(state_dir) / "applied.json") as f:
            applied = json.load(f)
        return {"join": {k: info[k] for k in ("applied_seq", "records_replayed",
                                              "resumed", "bootstrapped")},
                "audit": rep.audit(), "applied": applied}
    finally:
        svc.close()


# -- the JAX side ---------------------------------------------------------------

def _jax_pkg() -> dict:
    from photon_ml_tpu import fleet, health, refit
    from photon_ml_tpu.fleet import replica
    pkg = oj._jax_pkg()
    pkg.update({k: getattr(health, k) for k in (
        "HealthConfig", "StreamingCalibration", "DriftDetector")})
    pkg.update({k: getattr(refit, k) for k in (
        "LogCompactor", "CompactorConfig", "CompactedDataset")})
    pkg.update({"FleetPublisher": replica.FleetPublisher,
                "Replica": replica.Replica,
                "record_for_feedback": fleet.record_for_feedback})
    return pkg


def health_side(root: Path) -> dict:
    pkg = _jax_pkg()
    return {"stats": health_stats(pkg), "walk": health_walk(pkg, np.asarray)}


def refit_side(root: Path) -> dict:
    from photon_ml_tpu.cli import refit as refit_cli
    from photon_ml_tpu.serving import CompiledScorer
    pkg = _jax_pkg()
    compact(pkg, root / "lane", root / "jax_full")
    compact(pkg, root / "lane", root / "jax_prefix", upto=PREFIX_SEQS)
    shutil.copytree(root / "port_prefix", root / "port_prefix_by_jax")
    compact(pkg, root / "lane", root / "port_prefix_by_jax")
    rc, line = run_cli_refit(refit_cli, refit_argv(root, "jax"))
    hashes = {who: CompiledScorer.from_model_dir(
        str(root / f"{who}_models" / REFIT_VERSION)).table_hashes()
        for who in ("jax", "port")}
    return {"full": store_bytes(root / "jax_full"),
            "prefix_resumed": store_bytes(root / "port_prefix_by_jax"),
            "cli": (rc, line), "candidate_hashes": hashes}


def fleet_side(root: Path) -> dict:
    pkg = _jax_pkg()
    out = {"publisher": publish_log(pkg, root, root / "jax_log"),
           "replica": join_replica(pkg, root, root / "jax_log",
                                   root / "jax_state"),
           "on_port_log": join_replica(pkg, root, root / "port_log",
                                       root / "jax_state_on_port_log")}
    shutil.copytree(root / "port_state", root / "port_state_by_jax")
    out["resumed_port_state"] = join_replica(pkg, root, root / "port_log",
                                             root / "port_state_by_jax")
    return out


def main(argv) -> int:
    mode, root = argv[1], Path(argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {"health": health_side, "refit": refit_side,
           "fleet": fleet_side}[mode](root)
    with open(root / f"{mode}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


def run_jax_side(mode: str, root: Path) -> dict:
    """Run this script in a fresh process; its results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(Path(__file__).resolve().parent)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), mode,
                           str(root)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side failed:\n{proc.stderr[-4000:]}")
    with open(root / f"{mode}.pkl", "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
