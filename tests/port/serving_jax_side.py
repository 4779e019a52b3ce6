"""The JAX side of the serving and store parity tests (test_torch_serving.py,
test_torch_store.py), run in a subprocess of its own:

    python tests/port/serving_jax_side.py serving|store ROOT

`serving` builds the JAX package's CompiledScorer over MODEL (FE, a plain
and an index-projected random effect, a factored random effect and an MF
pair; logistic), scores REQUESTS (every bucket of MAX_BATCH/MIN_BUCKET, a
chunked request, unseen ids), runs the registry through a delta warmup,
two deltas, a delta-aware rollback, a replay of its published row state, a
background swap (`load_async`) and a full rollback (`table_hashes`, pending
deltas and scores at each stage, every publish and swap hook call), then
the same model through the tiered store.
`store` runs STORE_OPS on a TieredEntityStore over STORE_TABLE (lookups,
write-through and promoting updates, gathers, a flush), recording every
counter, lane and value; it also creates a cold store of its own under
ROOT/jax_store and opens the port's under ROOT/port_store.  Results go to
ROOT/<mode>.npz, with JAX on the CPU in float64.  The builders below are
numpy only (and take either package's classes), so the tests import them
to make the same inputs for the port.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

D_G, D_U, D_I, K_LOCAL, K_LATENT, K_MF = 6, 4, 5, 3, 2, 3
N_USERS, N_ITEMS = 24, 10
MAX_BATCH, MIN_BUCKET = 32, 4
# rows per request: every bucket (4, 8, 16, 32) and a chunked request
REQUEST_ROWS = (1, 3, 4, 5, 8, 9, 16, 17, 32, 40)
# lanes whose tables load bit for bit in both packages (the factored
# random effect's table is a matmul, whose last bits may differ)
EXACT_LANES = ("fixed", "perUser", "perItem", "mf/row", "mf/col")
STAGES = ("load", "warmup_delta", "delta1", "delta2", "rollback", "redelta",
          "replay", "swap", "rollback_full")
DELTA_ROWS = {1: {"perUser": [1, 5, 7], "perItem": [0, 3]},
              2: {"perUser": [5, 9]}}
STORE_CONFIG = dict(hot_rows=8, warm_segments=2, seg_rows=4, overlay_rows=32,
                    flush_rows=4, lfu_sample=16, decay_every=2)

STORE_ROWS, STORE_DIM = 60, 3
STORE_TABLE_CONFIG = dict(hot_rows=10, warm_segments=2, seg_rows=8,
                          overlay_rows=16, flush_rows=5, lfu_sample=6,
                          decay_every=3)
# the JAX store's own bound on one scatter program, set small so its flushes
# run in several chunks (the port scatters a flush in one call)
JAX_SCATTER_CHUNK = {"serving": 8, "store": 4}


def model_arrays(seed: int = 5, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    proj = np.stack([rng.permutation(D_I)[:K_LOCAL] for _ in range(N_ITEMS)])
    proj[::3, -1] = -1                       # padded projection columns
    return {
        "fe": scale * rng.normal(size=D_G),
        "user": scale * rng.normal(size=(N_USERS, D_U)),
        "user_ids": np.asarray([f"u{i}" for i in range(N_USERS)], dtype=object),
        "item_local": scale * rng.normal(size=(N_ITEMS, K_LOCAL)),
        "item_proj": proj.astype(np.int64),
        "item_ids": np.arange(N_ITEMS, dtype=np.int64),
        "latent": scale * rng.normal(size=(N_USERS, K_LATENT)),
        "latent_proj": rng.normal(size=(K_LATENT, D_U)),
        "mf_row": scale * rng.normal(size=(N_USERS, K_MF)),
        "mf_col": scale * rng.normal(size=(N_ITEMS, K_MF)),
    }


def build_model(pkg: dict, a: dict):
    """A GameModel of either package from model_arrays; `pkg` holds the
    package's model classes, `Coefficients`, `model_for_task` and an
    `asarray` onto its device."""
    t, task = pkg["asarray"], "logistic_regression"
    return pkg["GameModel"]({
        "fixed": pkg["FixedEffectModel"](pkg["model_for_task"](
            task, pkg["Coefficients"](t(a["fe"]))), "global"),
        "perUser": pkg["RandomEffectModel"](
            random_effect_type="userId", feature_shard="per_user",
            task_type=task, coefficients=t(a["user"]),
            entity_ids=a["user_ids"], projection=None, global_dim=D_U),
        "perItem": pkg["RandomEffectModel"](
            random_effect_type="itemId", feature_shard="per_item",
            task_type=task, coefficients=t(a["item_local"]),
            entity_ids=a["item_ids"], projection=a["item_proj"],
            global_dim=D_I),
        "perUserLatent": pkg["FactoredRandomEffectModel"](
            random_effect_type="userId", feature_shard="per_user",
            task_type=task, latent_coefficients=t(a["latent"]),
            projection=t(a["latent_proj"]), entity_ids=a["user_ids"],
            global_dim=D_U),
        "mf": pkg["MatrixFactorizationModel"](
            row_effect_type="userId", col_effect_type="itemId",
            row_factors=t(a["mf_row"]), row_ids=a["user_ids"],
            col_factors=t(a["mf_col"]), col_ids=a["item_ids"]),
    }, task)


def requests(seed: int = 6) -> list:
    """(features, ids) per REQUEST_ROWS entry; a quarter of the ids are
    unseen by the model."""
    rng = np.random.default_rng(seed)
    out = []
    for n in REQUEST_ROWS:
        users = np.asarray([f"u{rng.integers(N_USERS)}" if rng.uniform() > 0.25
                            else f"ghost{rng.integers(3)}" for _ in range(n)],
                           dtype=object)
        items = np.asarray([int(rng.integers(N_ITEMS)) if rng.uniform() > 0.25
                            else 90 + int(rng.integers(3)) for _ in range(n)],
                           dtype=object)
        feats = {"global": rng.normal(size=(n, D_G)),
                 "per_user": rng.normal(size=(n, D_U)),
                 "per_item": rng.normal(size=(n, D_I))}
        out.append((feats, {"userId": users, "itemId": items}))
    return out


def delta_values(seq: int, lane: str, dim: int) -> np.ndarray:
    rng = np.random.default_rng(100 + seq)
    return rng.normal(size=(len(DELTA_ROWS[seq][lane]), dim)) * (1 + seq)


def make_delta(delta_mod, scorer, seq: int, host):
    """ModelDelta `seq` of DELTA_ROWS against `scorer`'s live rows (its
    priors gathered through the scorer, `host` turning them to numpy)."""
    coords = {}
    for lane, rows in DELTA_ROWS[seq].items():
        rows = np.asarray(rows, np.int64)
        prior = host(scorer.gather_rows(lane, rows))
        coords[lane] = delta_mod.CoordinateDelta(
            rows=rows, values=delta_values(seq, lane, prior.shape[1]),
            prior=prior)
    return delta_mod.ModelDelta(base_version="v1", seq=seq, coordinates=coords)


def run_registry(registry_cls, scorer, make_second, delta_mod, host) -> dict:
    """The registry walk of STAGES: per stage the live table hashes, the
    pending deltas and the scores of every request.  `scorer` is installed
    as v1; a discarded delta warmup; two deltas and the delta-aware
    rollback; delta 1 again, then the rollback's published row state
    replayed over it; v2 built and warmed by `make_second()` on
    `load_async`'s background thread; the full rollback.  Also every
    publish hook event (ticket, kind, version) and swap hook call, in
    order, and the thread that built v2."""
    reqs = requests()
    out = {}
    built_on = []

    def factory(version_dir, version):
        built_on.append(threading.current_thread().name)
        return make_second()

    registry = registry_cls(scorer_factory=factory)
    published, swapped = [], []
    registry.add_publish_hook(lambda ticket, event: published.append(
        (ticket, event["kind"], event["version"], event)))
    registry.add_swap_hook(lambda version, action: swapped.append(
        (version, action)))

    def record(stage):
        live = registry.scorer
        out[f"hashes/{stage}"] = np.asarray(
            sorted(live.table_hashes().items()), dtype=object)
        out[f"pending/{stage}"] = np.asarray(registry.pending_deltas())
        for i, (f, ids) in enumerate(reqs):
            out[f"scores/{stage}/{i}"] = live.score(f, ids).scores

    registry.install(scorer, "v1")
    record("load")
    registry.scorer.warmup_delta(max_rows=8)
    record("warmup_delta")
    for seq in (1, 2):
        registry.apply_delta(make_delta(delta_mod, registry.scorer, seq, host))
        record(f"delta{seq}")
    registry.rollback()
    record("rollback")
    restored = published[-1][3]["restored"]
    registry.apply_delta(make_delta(delta_mod, registry.scorer, 1, host))
    record("redelta")
    registry.replay_row_state(restored, "v1", 0)
    record("replay")
    registry.load_async("v2_dir", "v2").result(timeout=120)
    record("swap")
    registry.rollback()
    record("rollback_full")
    out["events/publish"] = np.asarray([p[:3] for p in published], dtype=object)
    out["events/swap"] = np.asarray(swapped, dtype=object)
    out["events/built_on"] = np.asarray(built_on, dtype=object)
    return out


def store_table(seed: int = 9):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(STORE_ROWS, STORE_DIM))
    ids = np.asarray([f"e{i}" for i in rng.permutation(STORE_ROWS)], dtype=object)
    return table, ids


def store_ops(seed: int = 10) -> list:
    """("lookup", ids) / ("update", ids, values, promote) / ("gather", ids) /
    ("flush",) steps over store_table's ids: skewed lookups with unknown
    ids, then updates of hot and cold rows, gathers and a flush."""
    rng = np.random.default_rng(seed)
    _, ids = store_table()
    head = ids[:12]
    ops = []
    for step in range(16):
        pick = [head[rng.integers(len(head))] if rng.uniform() < 0.7
                else ids[rng.integers(STORE_ROWS)] for _ in range(6)]
        pick[step % 6] = "nobody"
        ops.append(("lookup", np.asarray(pick, dtype=object)))
        if step in (5, 11):
            rows = np.asarray(rng.choice(ids, size=5, replace=False), dtype=object)
            ops.append(("update", rows, rng.normal(size=(5, STORE_DIM)),
                        step == 11))
            ops.append(("gather", np.asarray(rng.choice(ids, 7), dtype=object)))
    ops.append(("flush",))
    ops.append(("gather", ids))
    return ops


def run_store_ops(st, host) -> dict:
    """Apply store_ops to a TieredEntityStore `st`; every lane, value,
    counter and residency field after each step."""
    out = {}
    for i, op in enumerate(store_ops()):
        if op[0] == "lookup":
            slots, stage, table, values = st.lookup_slots(st.resolve(op[1]))
            out[f"{i}/slots"], out[f"{i}/stage"] = slots, stage
            out[f"{i}/values"], out[f"{i}/table"] = values, host(table)
        elif op[0] == "update":
            res = st.update_rows(st.resolve(op[1]), op[2], promote=op[3])
            out[f"{i}/hot"] = np.asarray(res["hot"])
        elif op[0] == "gather":
            out[f"{i}/gather"] = st.gather_rows(st.resolve(op[1]))
        else:
            out[f"{i}/flushed"] = np.asarray(st.flush())
        out[f"{i}/stats"] = np.asarray(sorted(st.stats.snapshot().items()),
                                       dtype=object)
        res = {k: v for k, v in st.residency().items() if k != "hit_rate"}
        out[f"{i}/residency"] = np.asarray(sorted(res.items()), dtype=object)
    out["table"] = host(st.table())
    return out


def _jax_pkg() -> dict:
    import jax.numpy as jnp

    from photon_ml_tpu.models import game
    from photon_ml_tpu.models.coefficients import Coefficients
    from photon_ml_tpu.models.glm import model_for_task
    return {"asarray": jnp.asarray, "Coefficients": Coefficients,
            "model_for_task": model_for_task,
            **{k: getattr(game, k) for k in (
                "GameModel", "FixedEffectModel", "RandomEffectModel",
                "FactoredRandomEffectModel", "MatrixFactorizationModel")}}


def serving_side(root: Path) -> dict:
    from photon_ml_tpu.online import delta as delta_mod
    from photon_ml_tpu.serving import CompiledScorer, ModelRegistry
    from photon_ml_tpu.store import StoreConfig
    pkg = _jax_pkg()
    out = {}

    def scorer(scale=1.0, **kw):
        return CompiledScorer(build_model(pkg, model_arrays(scale=scale)),
                              max_batch=MAX_BATCH, min_bucket=MIN_BUCKET, **kw)

    s = scorer()
    s.warmup()
    for i, (f, ids) in enumerate(requests()):
        res = s.score(f, ids)
        out[f"scores/{i}"], out[f"buckets/{i}"] = res.scores, np.asarray(res.buckets)
        out[f"hits/{i}"] = np.asarray([res.entity_hits, res.entity_lookups])
        for name, z in s.score_margins(f, ids).items():
            out[f"margins/{i}/{name}"] = z
    out["predict"] = s.mean_prediction(out["scores/0"])
    tiered = StoreConfig(**STORE_CONFIG,
                         scatter_chunk=JAX_SCATTER_CHUNK["serving"])
    walks = {"resident": lambda **kw: scorer(**kw),
             "tiered": lambda **kw: scorer(store=tiered,
                                           store_dir=str(root / "tiers" / str(
                                               kw.get("scale", 1.0))), **kw)}
    for walk, make in walks.items():
        first = make()
        first.warmup()
        res = run_registry(ModelRegistry, first, lambda: make(scale=0.5),
                           delta_mod, np.asarray)
        out.update({f"{walk}/{k}": v for k, v in res.items()})
        out[f"{walk}/totals"] = np.asarray(sorted(first.store_totals().items()),
                                           dtype=object)
    return out


def store_side(root: Path) -> dict:
    from photon_ml_tpu.store import ColdStore, StoreConfig, TieredEntityStore
    table, ids = store_table()
    config = StoreConfig(**STORE_TABLE_CONFIG,
                         scatter_chunk=JAX_SCATTER_CHUNK["store"])
    st = TieredEntityStore.create(str(root / "jax_store"), table, config,
                                  entity_ids=ids)
    st.warmup()
    out = run_store_ops(st, np.asarray)
    out["full_table"] = st.full_table()
    port = ColdStore.open(str(root / "port_store"))
    out["port_store/table"] = port.read_table()
    out["port_store/ids"] = np.asarray(port.entity_ids, dtype=object)
    reopened = TieredEntityStore.open(str(root / "port_store"), config)
    out["port_store/gather"] = reopened.gather_rows(reopened.resolve(ids[:9]))
    return out


def main(argv) -> int:
    mode, root = argv[1], Path(argv[2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {"serving": serving_side, "store": store_side}[mode](root)
    np.savez(root / f"{mode}.npz", **out)
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
    with np.load(root / f"{mode}.npz", allow_pickle=True) as z:
        return dict(z)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
