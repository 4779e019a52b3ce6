"""Parity of the port's entity-sharded serving (fleet/shards.py and
CompiledScorer(shard=...)) with the JAX package's, on the CPU in float64.

The JAX side (online_jax_side.py shards, one subprocess) hashes 10,000 ids
of mixed types to shards and scores serving_jax_side's model (FE, a plain
and a projected random effect, a factored random effect, an MF pair) in
full, with each shard's audit hashes and owned rows.  Here: `shard_of`
equal id for id, the spec's dict round trip, `shards_touched`, the
fan-out merge of four shard scorers' `score_margins` equal to the port's
monolithic scorer bit for bit (and within 1e-12 of JAX's scores), the
per-shard audits, shard-filtered deltas, and the sharded ScoringService.
"""
import numpy as np
import pytest
import torch

import online_jax_side as oj
import serving_jax_side as sj
from photon_ml_tpu_torch.fleet import (ShardAssignment, ShardMergeError,
                                       ShardSpec, merge_margins,
                                       shards_touched)
from photon_ml_tpu_torch.online import delta as delta_mod
from photon_ml_tpu_torch.serving import (CompiledScorer, ScoringService,
                                         ServingConfig)
from test_torch_serving import PKG

SPEC = ShardSpec(oj.NUM_SHARDS)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return oj.run_jax_side("shards", tmp_path_factory.mktemp("shards_jax"))


@pytest.fixture(scope="module")
def scorers():
    model = sj.build_model(PKG, sj.model_arrays())
    kw = dict(max_batch=sj.MAX_BATCH, min_bucket=sj.MIN_BUCKET, device="cpu")
    full = CompiledScorer(model, **kw)
    legs = [CompiledScorer(model, shard=ShardAssignment(SPEC, k), **kw)
            for k in range(oj.NUM_SHARDS)]
    for s in legs:
        s.warmup()
    return full, legs


def test_shard_of_matches_jax_for_mixed_ids(jax_side):
    got = np.asarray([SPEC.shard_of(e) for e in oj.shard_ids()])
    assert np.array_equal(got, jax_side["shard_of"])
    counts = np.bincount(got, minlength=oj.NUM_SHARDS)
    assert counts.min() > 0.2 * len(got)       # a total, balanced map
    assert ShardSpec(4, version=2).shard_of("u1") in range(4)


def test_spec_id_roundtrip_and_mismatch():
    spec = ShardSpec(4, salt="s", version=3)
    assert ShardSpec.from_dict(spec.to_dict()) == spec
    bad = dict(spec.to_dict(), spec_id="0" * 16)
    with pytest.raises(ValueError, match="spec_id mismatch"):
        ShardSpec.from_dict(bad)
    with pytest.raises(ValueError):
        ShardSpec(0)
    with pytest.raises(ValueError):
        ShardAssignment(spec, 4)
    assert ShardAssignment(spec, 1).owns("u1") == (spec.shard_of("u1") == 1)


def test_version_and_salt_change_the_partition():
    a, b, c = ShardSpec(4), ShardSpec(4, version=2), ShardSpec(4, salt="other")
    ids = [f"u{i}" for i in range(100)]
    assert [a.shard_of(e) for e in ids] != [b.shard_of(e) for e in ids]
    assert [a.shard_of(e) for e in ids] != [c.shard_of(e) for e in ids]
    assert len({a.spec_id(), b.spec_id(), c.spec_id()}) == 3


def test_owned_masks_partition_the_ids():
    ids = oj.shard_ids()[:500]
    masks = np.stack([SPEC.owned_mask(ids, k) for k in range(oj.NUM_SHARDS)])
    assert np.array_equal(masks.sum(axis=0), np.ones(len(ids)))
    assert masks.argmax(axis=0).tolist() == [SPEC.shard_of(e) for e in ids]


def test_merge_refuses_malformed_legs(scorers):
    full, legs = scorers
    feats, ids = sj.requests()[2]
    meta = full.coordinate_meta()
    margins = {k: s.score_margins(feats, ids) for k, s in enumerate(legs)}
    with pytest.raises(ValueError, match="missing_policy"):
        merge_margins(SPEC, meta, ids, margins, primary=0, missing_policy="x")
    short = dict(margins[0], fixed=margins[0]["fixed"][:-1])
    with pytest.raises(ShardMergeError, match="rows, expected"):
        merge_margins(SPEC, meta, ids, {**margins, 0: short}, primary=0)
    with pytest.raises(ShardMergeError, match="carries no margins"):
        merge_margins(SPEC, meta, ids, {**margins, 0: {}}, primary=0)
    partial = {k: v for k, v in margins[0].items() if k != "mf"}
    with pytest.raises(ShardMergeError, match="coordinate 'mf'"):
        merge_margins(SPEC, meta, ids, {**margins, 0: partial}, primary=0)


def test_shards_touched_names_only_owning_shards(scorers):
    full, _ = scorers
    feats, ids = sj.requests()[6]
    touched = shards_touched(SPEC, full.coordinate_meta(), ids)
    want = sorted({SPEC.shard_of(e) for t in ("userId", "itemId")
                   for e in ids[t].tolist()})
    assert touched == want


@pytest.mark.parametrize("i", range(len(sj.REQUEST_ROWS)),
                         ids=[f"rows{n}" for n in sj.REQUEST_ROWS])
def test_fanout_merge_equals_the_monolithic_scorer(jax_side, scorers, i):
    full, legs = scorers
    feats, ids = sj.requests()[i]
    want = full.score(feats, ids).scores
    margins = {k: s.score_margins(feats, ids) for k, s in enumerate(legs)}
    got = merge_margins(SPEC, full.coordinate_meta(), ids, margins, primary=0)
    assert got["scores"].tobytes() == want.tobytes()
    assert got["partial_rows"] == [] and got["missing_shards"] == []
    jax = jax_side["scores"][i]
    assert np.max(np.abs(got["scores"] - jax) / np.maximum(1.0, np.abs(jax))) <= 1e-12


def test_merge_missing_owner_policies(scorers):
    full, legs = scorers
    feats, ids = sj.requests()[8]
    margins = {k: s.score_margins(feats, ids) for k, s in enumerate(legs)}
    del margins[2]
    meta = full.coordinate_meta()
    owners = {SPEC.shard_of(e) for e in ids["userId"].tolist() + ids["itemId"].tolist()}
    if 2 in owners:
        with pytest.raises(ShardMergeError, match="shard 2"):
            merge_margins(SPEC, meta, ids, margins, primary=0)
    out = merge_margins(SPEC, meta, ids, margins, primary=0,
                        missing_policy="partial")
    assert out["missing_shards"] == ([2] if 2 in owners else [])
    with pytest.raises(ShardMergeError, match="primary"):
        merge_margins(SPEC, meta, ids, margins, primary=2)


def test_per_shard_audits(jax_side, scorers):
    full, legs = scorers
    for k, leg in enumerate(legs):
        assert leg.table_hashes() == full.shard_table_hashes(SPEC, k)
        for lane in sj.EXACT_LANES:      # tables bit-equal in both packages
            assert full.shard_table_hashes(SPEC, k)[lane] == \
                jax_side["shard_hashes"][k][lane], (k, lane)
        assert leg.shard_info() == jax_side["owned"][k]
    with pytest.raises(ValueError, match="FULL model"):
        legs[0].shard_table_hashes(SPEC, 0)


def test_sharded_scorers_apply_only_their_rows():
    """A full-model delta lands on each shard's owned rows (the rest are
    dropped and counted), and the shards' audits follow the full scorer's."""
    model = sj.build_model(PKG, sj.model_arrays())
    full = CompiledScorer(model, device="cpu")
    legs = [CompiledScorer(model, shard=ShardAssignment(SPEC, k), device="cpu")
            for k in range(oj.NUM_SHARDS)]
    delta = sj.make_delta(delta_mod, full, 1,
                          lambda t: t.detach().cpu().numpy())
    for s in [full] + legs:
        s.apply_delta(delta)
    rows = sum(cd.num_rows for cd in delta.coordinates.values())
    assert sum(s.shard_info()["rows_dropped"] for s in legs) == \
        rows * (oj.NUM_SHARDS - 1)
    for k, leg in enumerate(legs):
        assert leg.table_hashes() == full.shard_table_hashes(SPEC, k)
    for s in [full] + legs:
        s.revert_delta(delta)
    assert legs[0].table_hashes() == CompiledScorer(
        model, shard=ShardAssignment(SPEC, 0), device="cpu").table_hashes()


def test_sharded_service():
    model = sj.build_model(PKG, sj.model_arrays())
    cfg = ServingConfig(max_batch=sj.MAX_BATCH, min_bucket=sj.MIN_BUCKET,
                        device="cpu", dtype=torch.float64, shard_index=1,
                        shard_count=oj.NUM_SHARDS)
    with ScoringService(model=model, config=cfg) as svc:
        feats, ids = sj.requests()[3]
        leg = svc.score_margins(feats, ids)
        assert leg["shard"]["index"] == 1 and svc.healthz()["shard"]["index"] == 1
        assert [m["name"] for m in leg["coordinates"]] == list(leg["margins"])
        assert svc.metrics_snapshot()["fleet"]["shard_index"] == 1
    with pytest.raises(ValueError, match="come together"):
        ScoringService(model=model, config=ServingConfig(device="cpu",
                                                         shard_index=0))
    from photon_ml_tpu_torch.online import OnlineUpdateConfig
    with pytest.raises(ValueError, match="cannot run the online updater"):
        ScoringService(model=model, config=cfg, updates=OnlineUpdateConfig())
