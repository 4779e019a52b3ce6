"""The JAX side of the online-tier parity tests (test_torch_online.py,
test_torch_replog.py, test_torch_shards.py), run in a subprocess of its
own, one per test module:

    python tests/port/online_jax_side.py online|replog|shards ROOT

`online` runs the SCENARIOS below through the JAX package's
ScoringService(updates=...): the anchored solve on seeded blocks, the
updater against an offline refit, intake accounting (unseen ids, event-id
dedup, the entity window), a stale delta, the `online.solve` /
`online.publish` faults (transient, poison, fatal), and delta directories
(it writes ROOT/jax_delta and loads ROOT/port_delta, which the test writes
first).  `replog` writes a replication log, a feedback lane and a snapshot
under ROOT/jax_log and reads the port's under ROOT/port_log.  `shards`
hashes seeded ids to shards and scores serving_jax_side's model, full and
per shard.  Results go to ROOT/<mode>.pkl (one pickled dict), with JAX on
the CPU in float64.  The scenario runners take either
package's classes (`pkg`), so the tests run the same code on the port.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

D_G, D_U, N_ENT = 6, 4, 30
TASK = "logistic_regression"
ANCHOR = 0.6
SOLVER = dict(max_iterations=200, tolerance=1e-12)
# the integer online counters every scenario compares
COUNTERS = ("feedback_requests", "feedback_rows", "feedback_lane_rows",
            "dropped_unseen", "dropped_frozen", "deduped", "coalesced",
            "shed", "feedback_rejected", "update_cycles", "entities_updated",
            "rows_trained", "deltas_published", "delta_rows", "stale_deltas",
            "freezes", "frozen_entities", "solve_retries", "publish_retries",
            "solve_failures")
FAULTS = {"transient_solve": ("online.solve", "transient"),
          "transient_publish": ("online.publish", "transient"),
          "poison": ("online.solve", "poison"),
          "fatal": ("online.solve", "fatal")}
SHARD_IDS = 10_000
NUM_SHARDS = 4


def model_arrays(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"fe": rng.normal(size=D_G), "re": rng.normal(size=(N_ENT, D_U)),
            "ids": np.asarray([f"u{i}" for i in range(N_ENT)], dtype=object)}


def build_model(pkg: dict, a: dict):
    """FE on "global" + a per-user random effect on "per_user"."""
    t = pkg["asarray"]
    return pkg["GameModel"]({
        "fixed": pkg["FixedEffectModel"](pkg["model_for_task"](
            TASK, pkg["Coefficients"](t(a["fe"]))), "global"),
        "perUser": pkg["RandomEffectModel"](
            random_effect_type="userId", feature_shard="per_user",
            task_type=TASK, coefficients=t(a["re"]), entity_ids=a["ids"],
            projection=None, global_dim=D_U)}, TASK)


def feedback(seed: int, n: int, ids=None):
    rng = np.random.default_rng(seed)
    feats = {"global": rng.normal(size=(n, D_G)),
             "per_user": rng.normal(size=(n, D_U))}
    if ids is None:
        ids = [f"u{rng.integers(0, N_ENT)}" for _ in range(n)]
    labels = (rng.uniform(size=n) < 0.5).astype(float)
    return feats, {"userId": np.asarray(ids, dtype=object)}, labels


def anchored_inputs(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    E, S = 3, 12
    mask = np.ones((E, S))
    mask[1, 8:] = 0.0
    offsets = rng.normal(size=(E, S)) * 0.3
    return {"x": rng.normal(size=(E, S, D_U)),
            "labels": (rng.uniform(size=(E, S)) < 0.5).astype(float),
            "mask": mask, "offsets": offsets * mask,
            "prior": rng.normal(size=(E, D_U)), "lam": 0.8}


def seeded_delta(delta_mod, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = np.asarray([2, 9, 4, 17], np.int64)
    return delta_mod.ModelDelta(
        base_version="inline@1", seq=seq,
        coordinates={"perUser": delta_mod.CoordinateDelta(
            rows=rows, values=rng.normal(size=(4, D_U)),
            prior=model_arrays()["re"][rows])},
        created_at=123.5)


# -- the scenario runners (either package) ------------------------------------

def _service(pkg, **updates):
    """A service over build_model; with `updates`, its updater solves to
    SOLVER's tolerance (the values are compared at 1e-9 relative, which
    asks for converged solves)."""
    cfg = (pkg["OnlineUpdateConfig"](**{**SOLVER, **updates}) if updates
           else None)
    return pkg["ScoringService"](
        model=build_model(pkg, model_arrays()),
        config=pkg["serving_config"](max_batch=64, min_bucket=4),
        updates=cfg, start_updater=False)


def _counters(svc) -> dict:
    online = svc.metrics_snapshot()["online"]
    return {k: online[k] for k in COUNTERS}


def _deltas(svc, host) -> list:
    return [{"seq": d.seq, "base_version": d.base_version,
             **{f"{lane}/{k}": host(getattr(cd, k))
                for lane, cd in d.coordinates.items()
                for k in ("rows", "values", "prior")}}
            for d in svc.registry.applied_deltas()]


def run_parity(pkg, host) -> dict:
    """bench.py's parity entry at test size: 7 entities' feedback through
    the updater (micro_batch 4 -> two deltas) and an offline refit."""
    svc = _service(pkg, micro_batch=4, anchor_weight=ANCHOR)
    try:
        scorer = svc.registry.scorer
        touched = ["u0", "u1", "u2", "u5", "u7", "u9", "u11"]
        n = 35
        feats, ids, labels = feedback(
            21, n, ids=[touched[i % len(touched)] for i in range(n)])
        table0 = host(scorer.re_table("perUser")).copy()
        prior = {u: table0[scorer.entity_row("perUser", u)].copy()
                 for u in touched}
        margins = scorer.score(feats, ids).scores
        intake = svc.feedback(feats, ids, labels)
        flushed = svc.updater.flush()
        table1 = host(scorer.re_table("perUser"))
        ds = pkg["build_game_dataset"](labels, feats, offsets=margins,
                                       entity_ids=ids)
        offline = pkg["offline_anchored_refit"](
            ds, "userId", "per_user", prior, pkg["loss"],
            pkg["OptimizerConfig"](max_iterations=200, tolerance=1e-12),
            anchor_weight=ANCHOR)
        return {"table0": table0, "table1": table1, "margins": margins,
                "intake": intake, "flush": flushed,
                "offline": {u: np.asarray(v) for u, v in offline.items()},
                "rows": {u: scorer.entity_row("perUser", u) for u in touched},
                "deltas": _deltas(svc, host), "counters": _counters(svc),
                "hashes": scorer.table_hashes()}
    finally:
        svc.close()


def run_intake(pkg, host) -> dict:
    """Intake accounting through the service: unseen ids, an event-id
    retry, one event fanning out within a batch, the entity window."""
    svc = _service(pkg, micro_batch=4, entity_window=3)
    try:
        out = {}
        feats, _ids, labels = feedback(31, 4)
        out["unseen"] = svc.feedback(
            feats, {"userId": np.asarray(["u0", "ghost1", "ghost2", "u1"],
                                         dtype=object)}, labels)
        feats, ids, labels = feedback(32, 6)
        events = [f"ev{i}" for i in range(6)]
        out["events"] = svc.feedback(feats, ids, labels, event_ids=events)
        out["retry"] = svc.feedback(feats, ids, labels, event_ids=events)
        feats, ids, labels = feedback(33, 6, ids=["u3"] * 6)
        out["window"] = svc.feedback(feats, ids, labels)
        out["pending"] = svc.updater.buffer.pending_rows
        out["flush"] = svc.updater.flush()
        out["deltas"] = _deltas(svc, host)
        out["counters"] = _counters(svc)
        return out
    finally:
        svc.close()


def run_stale(pkg, host) -> dict:
    """A swap racing the publish: the first apply_delta raises
    StaleDeltaError, the batch re-enqueues and re-solves next cycle."""
    svc = _service(pkg, micro_batch=8)
    try:
        registry = svc.registry
        feats, ids, labels = feedback(41, 6)
        svc.feedback(feats, ids, labels)
        real_apply = registry.apply_delta
        calls = {"n": 0}

        def flaky_apply(d, publish_s=0.0):
            calls["n"] += 1
            if calls["n"] == 1:
                raise pkg["StaleDeltaError"]("simulated swap race")
            return real_apply(d, publish_s=publish_s)

        registry.apply_delta = flaky_apply
        out = {"first": svc.updater.run_once(),
               "pending": svc.updater.buffer.pending_rows,
               "flush": svc.updater.flush()}
        out["deltas"] = _deltas(svc, host)
        out["counters"] = _counters(svc)
        return out
    finally:
        svc.close()


def run_fault(pkg, host, case: str) -> dict:
    """One fault of FAULTS on the first hit of its site during a flush;
    after a poison, more feedback for a frozen and a healthy entity."""
    faults = pkg["faults"]
    site, action = FAULTS[case]
    svc = _service(pkg, micro_batch=4 if case in ("poison", "fatal") else 8)
    try:
        scorer = svc.registry.scorer
        ids = ["u3", "u3", "u4", "u4"] if case == "poison" else None
        feats, ids, labels = feedback(51, 4 if ids else 8, ids=ids)
        svc.feedback(feats, ids, labels)
        table0 = host(scorer.re_table("perUser")).copy()
        plan = faults.FaultPlan([{"site": site, "action": action,
                                  "hits": [1]}])
        with faults.injected(plan):
            out = {"flush": svc.updater.flush()}
        out["fired"] = plan.report()["total_fired"]
        out["table_untouched"] = bool(np.array_equal(
            host(scorer.re_table("perUser")), table0))
        out["frozen"] = sorted(str(e) for _l, e in
                               svc.updater.frozen_entities())
        if case == "poison":
            f2, i2, l2 = feedback(52, 2, ids=["u3", "u5"])
            out["after"] = svc.feedback(f2, i2, l2)
            out["after_flush"] = svc.updater.flush()
        out["deltas"] = _deltas(svc, host)
        out["counters"] = _counters(svc)
        out["hashes"] = scorer.table_hashes()
        return out
    finally:
        svc.close()


def apply_delta_dir(pkg, directory) -> dict:
    """A persisted delta loaded and applied to a fresh service: the live
    table hashes and version vector."""
    svc = _service(pkg)
    try:
        delta = pkg["load_model_delta"](str(directory))
        svc.registry.apply_delta(delta)
        return {"hashes": svc.registry.scorer.table_hashes(),
                "version_vector": svc.version_vector()}
    finally:
        svc.close()


# -- replication-log records (either package) ---------------------------------

def log_records(rng_seed: int = 61) -> list:
    """swap, two deltas (f64 and f32 rows), a delta rollback, a shard map,
    a full rollback: record dicts built from numpy only."""
    rng = np.random.default_rng(rng_seed)
    return [
        ("swap", {"kind": "swap", "version": "v1", "previous_version": None,
                  "source_dir": "/models/v1"}),
        ("delta", {"kind": "delta", "version": "v1", "base_version": "v1",
                   "delta_seq": 1, "created_at": 10.5, "coordinates": {
                       "perUser": {"rows": np.arange(3, dtype=np.int64),
                                   "values": rng.normal(size=(3, D_U)),
                                   "prior": rng.normal(size=(3, D_U))}}}),
        ("delta", {"kind": "delta", "version": "v1", "base_version": "v1",
                   "delta_seq": 2, "created_at": 11.0, "coordinates": {
                       "perUser": {"rows": np.asarray([1, 7], np.int64),
                                   "values": rng.normal(size=(2, D_U))
                                   .astype(np.float32),
                                   "prior": rng.normal(size=(2, D_U))
                                   .astype(np.float32)}}}),
        ("delta_rollback", {"kind": "delta_rollback", "version": "v1",
                            "to_delta_seq": 1, "restored": {
                                "perUser": {"rows": np.asarray([1, 7],
                                                               np.int64),
                                            "values": rng.normal(
                                                size=(2, D_U))}}}),
        ("shard_map", None),
        ("rollback", {"kind": "rollback", "version": "v0",
                      "previous_version": "v1", "degraded": False}),
    ]


def encode_record(pkg, kind, rec):
    """numpy record -> the log's JSON record through the package's codec."""
    enc = pkg["encode_array"]
    if kind == "shard_map":
        return pkg["record_for_shard_map"](pkg["ShardSpec"](NUM_SHARDS))
    out = dict(rec)
    for key in ("coordinates", "restored"):
        if key in rec:
            out[key] = {lane: {k: enc(v) for k, v in parts.items()}
                        for lane, parts in rec[key].items()}
    return out


def feedback_records(pkg) -> list:
    out = []
    for seed in (71, 72, 73):
        feats, ids, labels = feedback(seed, 5)
        out.append(pkg["record_for_feedback"](
            feats, ids, labels, np.full(5, 2.0), np.full(5, 0.25),
            event_ids=[f"e{seed}-{i}" for i in range(5)],
            trace_id=f"t{seed}", wall_s=1000.0 + seed))
    return out


def write_logs(pkg, root) -> None:
    """The model-state log (compacted at seq 3 into a snapshot) and the
    feedback lane, under `root`."""
    log = pkg["ReplicationLog"](str(root / "model"), segment_records=2)
    for kind, rec in log_records():
        log.append(encode_record(pkg, kind, rec))
    log.compact(3)
    fb = pkg["FeedbackLog"](str(root / "feedback"), segment_records=2)
    for rec in feedback_records(pkg):
        fb.append(rec)


def read_logs(pkg, root) -> dict:
    """What a log directory of either package reads as: every envelope
    (timestamps and checksums included), the snapshot, the head seqs."""
    log = pkg["ReplicationLog"](str(root / "model"))
    fb = pkg["FeedbackLog"](str(root / "feedback"))
    return {"model": log.read(3), "snapshot": log.latest_snapshot(),
            "head": log.head_seq(), "feedback": fb.read(0),
            "feedback_head": fb.head_seq(),
            "live": (log.live_records(), fb.live_records()),
            "segments": sorted(os.listdir(root / "model"))
            + sorted(os.listdir(root / "feedback"))}


def shard_ids() -> list:
    """SHARD_IDS ids of mixed types: strings, ints, numpy ints, floats."""
    rng = np.random.default_rng(81)
    out = []
    for i in range(SHARD_IDS):
        k = i % 4
        v = int(rng.integers(0, 10**9))
        out.append(f"user-{v}" if k == 0 else v if k == 1
                   else np.int64(v) if k == 2 else v / 7.0)
    return out


# -- the JAX side ---------------------------------------------------------------

def _jax_pkg() -> dict:
    import jax.numpy as jnp

    from photon_ml_tpu import fleet
    from photon_ml_tpu.data.game_data import build_game_dataset
    from photon_ml_tpu.game.anchored import offline_anchored_refit
    from photon_ml_tpu.models import game
    from photon_ml_tpu.models.coefficients import Coefficients
    from photon_ml_tpu.models.glm import model_for_task
    from photon_ml_tpu.models.io import load_model_delta
    from photon_ml_tpu.online import OnlineUpdateConfig
    from photon_ml_tpu.ops import TASK_LOSSES
    from photon_ml_tpu.optim import OptimizerConfig
    from photon_ml_tpu.serving import (ScoringService, ServingConfig,
                                       StaleDeltaError)
    from photon_ml_tpu.utils import faults
    return {"asarray": jnp.asarray, "Coefficients": Coefficients,
            "model_for_task": model_for_task,
            "GameModel": game.GameModel,
            "FixedEffectModel": game.FixedEffectModel,
            "RandomEffectModel": game.RandomEffectModel,
            "ScoringService": ScoringService,
            "serving_config": ServingConfig,
            "OnlineUpdateConfig": OnlineUpdateConfig,
            "OptimizerConfig": OptimizerConfig,
            "StaleDeltaError": StaleDeltaError, "faults": faults,
            "build_game_dataset": build_game_dataset,
            "offline_anchored_refit": offline_anchored_refit,
            "loss": TASK_LOSSES[TASK], "load_model_delta": load_model_delta,
            **{k: getattr(fleet, k) for k in (
                "ReplicationLog", "FeedbackLog", "encode_array",
                "record_for_shard_map", "record_for_feedback", "ShardSpec")}}


def online_side(root: Path) -> dict:
    import jax.numpy as jnp

    from photon_ml_tpu.game.anchored import entity_rows, solve_anchored
    from photon_ml_tpu.models.io import save_model_delta
    from photon_ml_tpu.online import delta as delta_mod
    from photon_ml_tpu.optim import OptimizerConfig
    from photon_ml_tpu.parallel.random_effect import EntityBlocks
    pkg = _jax_pkg()
    host = np.asarray
    a = anchored_inputs()
    blocks = EntityBlocks(
        x=jnp.asarray(a["x"]), labels=jnp.asarray(a["labels"]),
        mask=jnp.asarray(a["mask"]), weights=jnp.asarray(a["mask"]),
        offsets=jnp.asarray(a["offsets"]))
    new_rows, _ = solve_anchored(
        blocks, jnp.asarray(a["prior"]), pkg["loss"],
        OptimizerConfig(max_iterations=200, tolerance=1e-12), a["lam"])
    feats, ids, labels = feedback(12, 40)
    ds = pkg["build_game_dataset"](labels, feats, entity_ids=ids)
    out = {"anchored": np.asarray(new_rows),
           "extract": entity_rows(ds, "userId", ["u1", "u3"]),
           "parity": run_parity(pkg, host),
           "intake": run_intake(pkg, host), "stale": run_stale(pkg, host)}
    for case in FAULTS:
        out[f"fault/{case}"] = run_fault(pkg, host, case)
    save_model_delta(seeded_delta(delta_mod, 5, 91), str(root / "jax_delta"))
    out["delta/jax"] = apply_delta_dir(pkg, root / "jax_delta")
    out["delta/port"] = apply_delta_dir(pkg, root / "port_delta")
    return out


def replog_side(root: Path) -> dict:
    pkg = _jax_pkg()
    write_logs(pkg, root / "jax_log")
    return {"jax": read_logs(pkg, root / "jax_log"),
            "port": read_logs(pkg, root / "port_log")}


def shards_side(root: Path) -> dict:
    import serving_jax_side as sj
    from photon_ml_tpu.fleet import ShardAssignment, ShardSpec
    from photon_ml_tpu.serving import CompiledScorer
    spec = ShardSpec(NUM_SHARDS)
    out = {"shard_of": np.asarray([spec.shard_of(e) for e in shard_ids()])}
    model = sj.build_model(sj._jax_pkg(), sj.model_arrays())
    full = CompiledScorer(model, max_batch=sj.MAX_BATCH,
                          min_bucket=sj.MIN_BUCKET)
    out["scores"] = [full.score(f, i).scores for f, i in sj.requests()]
    out["shard_hashes"] = [full.shard_table_hashes(spec, k)
                           for k in range(NUM_SHARDS)]
    out["owned"] = [CompiledScorer(
        model, max_batch=sj.MAX_BATCH, min_bucket=sj.MIN_BUCKET,
        shard=ShardAssignment(spec, k)).shard_info()
        for k in range(NUM_SHARDS)]
    return out


def main(argv) -> int:
    mode, root = argv[1], Path(argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {"online": online_side, "replog": replog_side,
           "shards": shards_side}[mode](root)
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
