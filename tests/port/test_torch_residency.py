"""Port game/residency.py, store/, and the out-of-core GLMix fit == the JAX
package's.

bench.py --stream --smoke's pair (6,000 rows, d_global 24, 300 users,
d_user 4, two outer iterations of LBFGS(8), seed 17): a resident fit, then
the same config under a budget of half its resident footprint (the fixed
effect streams in chunks, the per-user coordinate is evicted between
visits), in both timing modes, and with a stochastic-early schedule.  Each
holds its objective and AUC histories within 1e-10 of the JAX package's,
its residency accounting (block and chunk bytes, evictions, the tracked
peak, under_budget, the store's counts and the stream statistics) equal,
and the per-visit `stream` deltas of its trackers and solver diagnostics
equal.  bench.py's `_pipeline_dataset` arrays equal the port's copy
(data/synthetic_bench.py).  Also: the store's fault site and eviction
entry point, and the lazy random-effect blocks.  The JAX side is
game_jax_side.py's stream mode (shared, see test_torch_streaming.py).
"""
import json
import sys

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data.synthetic_bench import pipeline_arrays, pipeline_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.store.base import StoreError
from photon_ml_tpu_torch.store.handles import BlockStore
from photon_ml_tpu_torch.utils import faults

REL = 1e-10


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return side.stream_results(tmp_path_factory.mktemp("residency") / "jax.npz")


@pytest.fixture(scope="module")
def data():
    return pipeline_dataset(side.RES_N, side.RES_DG, side.RES_USERS, side.RES_DU,
                            side.RES_SEED)


@pytest.fixture(scope="module")
def fits(jax_side, data):
    train, val = data
    budget = int(jax_side["res/budget"])
    out = {}
    for name, (budgeted, mode, schedule) in side.RES_FITS.items():
        cfg = GameTrainingConfig.from_dict(
            side.stream_config_dict(budget if budgeted else None, schedule))
        out[name] = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(
            train, val, ["AUC"], timing_mode=mode)
    return budget, out


def test_pipeline_dataset_copy_matches_bench():
    sys.path.insert(0, str(side.ROOT))
    from bench import _pipeline_dataset
    for args in ((side.RES_N, side.RES_DG, side.RES_USERS, side.RES_DU, side.RES_SEED),
                 (500, 6, 40, 4, 9, 30, 3)):
        train, val = _pipeline_dataset(*args)
        y, shards, ids = pipeline_arrays(*args)
        ours = pipeline_dataset(*args)
        n_train = train.num_rows
        np.testing.assert_array_equal(y[:n_train], train.response)
        for k, x in shards.items():
            np.testing.assert_array_equal(x[n_train:], val.feature_shards[k])
            np.testing.assert_array_equal(ours[0].feature_shards[k], train.feature_shards[k])
        for k, col in ids.items():
            vocab = np.asarray(train.entity_vocabs[k])
            np.testing.assert_array_equal(vocab[train.entity_indices[k]], col[:n_train])
            np.testing.assert_array_equal(ours[0].entity_indices[k], train.entity_indices[k])


def test_budget_from_resident_accounting_matches(jax_side, fits):
    budget, res = fits
    assert side.stream_budget(res["resident"].residency) == budget


@pytest.mark.parametrize("name", list(side.RES_FITS))
def test_streamed_glmix_matches_jax(jax_side, fits, name):
    res = fits[1][name]
    key = f"res/{name}"
    np.testing.assert_allclose(res.objective_history, jax_side[f"{key}/objective_history"],
                               rtol=REL)
    np.testing.assert_allclose(res.descent.validation_history["AUC"],
                               jax_side[f"{key}/auc_history"], rtol=REL)
    assert res.residency == json.loads(str(jax_side[f"{key}/accounting"]))
    want_diag = json.loads(str(jax_side[f"{key}/diagnostics"]))
    diag = res.descent.solver_diagnostics()
    for coord, d in want_diag.items():
        assert diag[coord].get("stream") == d.get("stream"), coord
        assert diag[coord]["iterations"] == d["iterations"]
        assert diag[coord]["reasons"] == d["reasons"]
    assert {k: t.stream for k, t in res.descent.trackers.items()} == \
        json.loads(str(jax_side[f"{key}/trackers"]))


def test_out_of_core_shape(fits):
    """The streamed fit trains data that exceeds its budget and stays under
    it; the resident fit's accounting is accounting only."""
    budget, res = fits
    r, s = res["resident"].residency, res["streamed"].residency
    assert r["budget_bytes"] is None and r["evictions"] == 0 and r["under_budget"]
    assert r["resident_block_total"] + r["flat_vector_bytes"] > budget
    assert s["under_budget"] and s["peak_tracked_bytes"] <= budget
    assert list(s["streamed_chunk_bytes"]) == ["fixed"]
    # the stochastic lane does more work per staged byte
    assert res["stochastic"].residency["stream"]["fixed"]["examples_per_staged_byte"] > \
        1.5 * s["stream"]["fixed"]["examples_per_staged_byte"]


def test_evicted_blocks_come_back_equal(data):
    from photon_ml_tpu_torch.data.batching import build_random_effect_dataset
    from photon_ml_tpu_torch.game.config import RandomEffectCoordinateConfig
    from photon_ml_tpu_torch.game.config import GLMOptimizationConfig
    cfg = RandomEffectCoordinateConfig("userId", "per_user", GLMOptimizationConfig())
    red = build_random_effect_dataset(data[0], cfg.data_config(3, keep_host_blocks=True),
                                      device="cpu", block_dtype=torch.float64)
    b = red.buckets[0]
    assert not b.is_resident
    bytes_before = red.device_bytes()
    x = b.blocks.x.clone()
    assert b.is_resident and red.device_bytes() == bytes_before
    red.evict_device_blocks()
    assert not b.is_resident
    assert torch.equal(b.blocks.x, x)
    resident = build_random_effect_dataset(data[0], cfg.data_config(3), device="cpu",
                                           block_dtype=torch.float64)
    resident.evict_device_blocks()  # no host copy: the device copy stays
    assert resident.buckets[0].is_resident


def test_block_store_fetch_retries_and_evicts():
    evicted = []
    store = BlockStore()
    store.register("re", evict=lambda: evicted.append(1), block_bytes=10)
    store.register("fe", evict=lambda: evicted.append(2), streamed=True)
    plan = faults.FaultPlan.from_dict({"faults": [{"site": "store.fetch", "hits": [1]}]})
    with faults.injected(plan):
        assert store.touch("re") and not store.touch("re") and not store.touch("fe")
    store.evict("re")
    store.evict("fe")
    snap = store.snapshot()
    assert evicted == [1] and snap["retries"] == 1 and snap["fetches"] == 1
    assert snap["evictions"] == 1 and snap["blocks"]["re"]["resident"] is False
    fatal = faults.FaultPlan.from_dict(
        {"faults": [{"site": "store.fetch", "action": "fatal", "hits": [1]}]})
    with faults.injected(fatal), pytest.raises(StoreError, match="block 're'"):
        store.touch("re")
