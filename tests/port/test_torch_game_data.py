"""Port GAME data layer == the JAX package's, exactly.

build_game_dataset/subset and build_random_effect_dataset run their host
work in numpy in both packages, so the port's blocks must equal the JAX
package's bit for bit (tolerance: none): bucket shapes, lane order, row
ids, x/labels/mask/weights/offsets, the projection, passive and discarded
rows, over a ragged entity mix with a cap that bites, passive data with a
lower bound, both projectors, max_buckets in {None, 2} and Pearson feature
selection.  Nothing here compiles an XLA program (the JAX builder only
moves finished numpy blocks to the device)."""
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import batching as jb
from photon_ml_tpu.data.game_data import build_game_dataset as jbuild
from photon_ml_tpu.data.stats import BasicStatisticalSummary as JStats
from photon_ml_tpu_torch.data import batching as tb
from photon_ml_tpu_torch.data.game_data import build_game_dataset as tbuild
from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary as TStats

N, D = 900, 9


def _columns(seed=3):
    """A ragged entity mix: a few heavy users (well over the caps), a few
    just over them, many light ones, and rows with no entity (-1 after a
    shared vocabulary lookup)."""
    rng = np.random.default_rng(seed)
    heavy = rng.integers(0, 4, size=300)
    medium = np.repeat(np.arange(60, 64), 25)   # just over the caps
    light = rng.integers(4, 60, size=N - 400)
    users = np.concatenate([heavy, medium, light])
    rng.shuffle(users)
    x = rng.normal(size=(N, D)) * (rng.uniform(size=(N, D)) < 0.6)
    x[:, -1] = 1.0
    y = (rng.uniform(size=N) < 0.4).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=N)
    o = rng.normal(size=N) * 0.1
    items = rng.integers(0, 30, size=N).astype(str)
    return dict(response=y, shards={"re": x, "fe": rng.normal(size=(N, 4))},
                weights=w, offsets=o, ids={"userId": users, "itemId": items})


def _pair(with_wo=True, vocab=False):
    c = _columns()
    kw = dict(weights=c["weights"], offsets=c["offsets"]) if with_wo else {}
    if vocab:
        # a shared vocabulary that misses some ids -> -1 entity indices
        kw["entity_vocabs"] = {"userId": np.arange(2, 55)}
    return (jbuild(c["response"], c["shards"], entity_ids=c["ids"], **kw),
            tbuild(c["response"], c["shards"], entity_ids=c["ids"], **kw))


@pytest.mark.parametrize("vocab", [False, True], ids=["interned", "shared_vocab"])
def test_build_game_dataset_and_subset(vocab):
    j, t = _pair(vocab=vocab)
    for ds_j, ds_t in ((j, t), (j.subset(np.arange(0, N, 3)), t.subset(np.arange(0, N, 3)))):
        np.testing.assert_array_equal(ds_t.response, ds_j.response)
        np.testing.assert_array_equal(ds_t.offsets, ds_j.offsets)
        np.testing.assert_array_equal(ds_t.weights, ds_j.weights)
        assert ds_t.feature_shards.keys() == ds_j.feature_shards.keys()
        for s in ds_j.feature_shards:
            np.testing.assert_array_equal(ds_t.feature_shards[s], ds_j.feature_shards[s])
        for k in ds_j.entity_indices:
            np.testing.assert_array_equal(ds_t.entity_indices[k], ds_j.entity_indices[k])
            np.testing.assert_array_equal(ds_t.entity_vocabs[k], ds_j.entity_vocabs[k])
        assert ds_t.num_rows == ds_j.num_rows
        assert ds_t.num_entities("userId") == ds_j.num_entities("userId")
        assert ds_t.shard_dim("re") == ds_j.shard_dim("re")
    assert (t.entity_indices["userId"] == -1).any() == vocab


def test_device_shard_is_one_shared_tensor():
    _, t = _pair()
    a = t.device_shard("re", "cpu", torch.float64)
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float64
    assert t.device_shard("re", "cpu", torch.float64) is a
    np.testing.assert_array_equal(a.numpy(), t.feature_shards["re"])
    assert t.device_shard("re", "cpu", torch.float32).dtype == torch.float32


def test_sparse_shard_refuses_device_copy():
    """A CSR shard refuses a dense device copy: device_shard gives a
    PaddedSparse with the JAX package's arrays (exactly), one per (shard,
    device, dtype); asking for the column view attaches it to that one
    shared entry (on the CPU from CSC_MIN_COLS columns up, as JAX)."""
    sp = pytest.importorskip("scipy.sparse")
    from photon_ml_tpu_torch.ops.features import CSC_MIN_COLS, PaddedSparse
    rng = np.random.default_rng(2)
    x = sp.random(40, 30, density=0.2, format="csr", random_state=3)
    t = tbuild(np.zeros(40), {"s": x})
    j = jbuild(np.zeros(40), {"s": x}).device_shard("s")
    got = t.device_shard("s", "cpu", torch.float64)
    assert isinstance(got, PaddedSparse) and not got.has_csc
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(j.values))
    assert t.device_shard("s", "cpu", torch.float64) is got
    assert t.device_shard("s", "cpu", torch.float32).dtype == torch.float32
    wide = tbuild(np.zeros(4), {"w": sp.random(4, CSC_MIN_COLS, density=1e-4,
                                                format="csr", random_state=rng)})
    viewed = wide.device_shard("w", "cpu", torch.float64, with_csc=True)
    assert viewed.has_csc and wide.device_shard("w", "cpu", torch.float64) is viewed


CONFIGS = {
    "cap_passive_index_map": dict(active_data_upper_bound=20),
    "cap_lower_bound": dict(active_data_upper_bound=20, passive_data_lower_bound=15),
    "identity": dict(active_data_upper_bound=25, projector="identity"),
    "one_bucket_per_class": dict(active_data_upper_bound=40, max_buckets=None),
    "two_buckets": dict(active_data_upper_bound=40, max_buckets=2),
    "pearson": dict(features_to_samples_ratio=0.3, max_buckets=None),
    "pearson_cap": dict(active_data_upper_bound=30, features_to_samples_ratio=0.5,
                        passive_data_lower_bound=5, seed=13),
    "no_cap": dict(),
}


def _build_both(name, with_wo=True, vocab=False):
    j, t = _pair(with_wo, vocab)
    kw = dict(random_effect_type="userId", feature_shard="re", **CONFIGS[name])
    jr = jb.build_random_effect_dataset(j, jb.RandomEffectDataConfig(**kw))
    tr = tb.build_random_effect_dataset(t, tb.RandomEffectDataConfig(**kw),
                                        device="cpu", block_dtype=torch.float64)
    return j, t, jr, tr


def _assert_same_blocks(jr, tr):
    np.testing.assert_array_equal(tr.entity_ids, jr.entity_ids)
    np.testing.assert_array_equal(tr.entity_position, jr.entity_position)
    if jr.projection is None:
        assert tr.projection is None
    else:
        np.testing.assert_array_equal(tr.projection, jr.projection)
    assert (tr.global_dim, tr.num_active, tr.num_passive) == \
        (jr.global_dim, jr.num_active, jr.num_passive)
    np.testing.assert_array_equal(tr.discarded_rows, jr.discarded_rows)
    assert len(tr.buckets) == len(jr.buckets)
    for bt, bj in zip(tr.buckets, jr.buckets):
        assert bt.lane_start == bj.lane_start
        np.testing.assert_array_equal(bt.row_ids, bj.row_ids)
        for f in ("x", "labels", "mask", "weights", "offsets"):
            a, b = getattr(bt.blocks, f), getattr(bj.blocks, f)
            if b is None:
                assert a is None, f
                continue
            assert tuple(a.shape) == tuple(b.shape), f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert tr.padding_stats() == jr.padding_stats()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_random_effect_dataset_equals_jax(name):
    _, _, jr, tr = _build_both(name)
    _assert_same_blocks(jr, tr)


@pytest.mark.parametrize("name", ["cap_passive_index_map", "pearson_cap"])
def test_random_effect_dataset_without_weights_offsets_and_unseen_ids(name):
    _, _, jr, tr = _build_both(name, with_wo=False, vocab=True)
    _assert_same_blocks(jr, tr)


def test_the_cases_exercise_what_they_name():
    """The configurations above really cap, keep passive rows, discard
    rows, select features and bucket differently."""
    *_, cap = _build_both("cap_passive_index_map")
    *_, low = _build_both("cap_lower_bound")
    *_, many = _build_both("one_bucket_per_class")
    *_, two = _build_both("two_buckets")
    *_, pearson = _build_both("pearson")
    *_, plain = _build_both("no_cap")
    assert cap.num_passive > 0 and len(cap.discarded_rows) == 0
    assert len(low.discarded_rows) > 0
    assert len(many.buckets) > 2 and len(two.buckets) == 2
    assert (pearson.projection >= 0).sum() < (plain.projection >= 0).sum()
    # the cap rescales the heavy entities' weights: count / cap
    heavy = cap.buckets[0].blocks
    assert heavy.weights.max() > 2.0


@pytest.mark.parametrize("name", ["cap_passive_index_map", "cap_lower_bound", "identity"])
def test_lanes_offsets_and_scatter(name):
    j, t, jr, tr = _build_both(name)
    idx = t.entity_indices["userId"]
    np.testing.assert_array_equal(tr.flat_entity_lanes(idx), jr.flat_entity_lanes(idx))
    flat = np.random.default_rng(1).normal(size=N)
    for bt in tr.buckets:
        off = bt.with_offsets_from_flat(torch.from_numpy(flat)).offsets.numpy()
        want = flat[np.maximum(bt.row_ids, 0)] * (bt.row_ids >= 0)
        np.testing.assert_array_equal(off, want)
    single = tr.with_offsets_from_flat(torch.from_numpy(flat))
    rows = tr.active_row_ids
    np.testing.assert_array_equal(single.offsets.numpy(),
                                  flat[np.maximum(rows, 0)] * (rows >= 0))
    assert single.x.shape[:2] == rows.shape
    local = np.random.default_rng(2).normal(size=(tr.num_entities, tr.local_dim))
    g = tr.scatter_to_global(torch.from_numpy(local)).numpy()
    if tr.projection is None:
        np.testing.assert_array_equal(g, local)
    else:
        want = np.zeros((tr.num_entities, tr.global_dim))
        e, k = np.nonzero(tr.projection >= 0)
        want[e, tr.projection[e, k]] = local[e, k]
        np.testing.assert_array_equal(g, want)


def test_build_is_memoized_and_unported_options_raise():
    _, t = _pair()
    cfg = tb.RandomEffectDataConfig("userId", "re", active_data_upper_bound=20)
    a = tb.build_random_effect_dataset(t, cfg, device="cpu", block_dtype=torch.float64)
    assert tb.build_random_effect_dataset(t, cfg, device="cpu",
                                          block_dtype=torch.float64) is a
    # the random projector (ported with the factored random effects):
    # k + 1 local columns, the last selecting the intercept; its parity
    # with the JAX package is test_torch_factored.py's
    rp = tb.build_random_effect_dataset(
        t, tb.RandomEffectDataConfig("userId", "re", projector="random_projection:4"),
        device="cpu", block_dtype=torch.float64)
    d = t.feature_shards["re"].shape[1]
    assert rp.projection is None and rp.projection_matrix.shape == (5, d)
    assert rp.local_dim == 5
    np.testing.assert_array_equal(rp.projection_matrix[4], np.eye(d)[-1])
    with pytest.raises(ValueError, match="projector"):
        tb.build_random_effect_dataset(
            t, tb.RandomEffectDataConfig("userId", "re", projector="nope"), device="cpu")


def test_fixed_effect_dataset_and_stats_copy():
    j, t = _pair()
    cfg = tb.FixedEffectDataConfig("fe")
    fe = tb.FixedEffectDataset.build(t, cfg)
    np.testing.assert_array_equal(fe.x, j.feature_shards["fe"])
    assert fe.feature_shard == "fe" and fe.weights is t.weights
    x = t.feature_shards["re"]
    for w in (None, t.weights):
        a, b = TStats.from_features(x, w), JStats.from_features(x, w)
        assert a.to_dict() == b.to_dict()
        np.testing.assert_array_equal(a.max_magnitude, b.max_magnitude)
