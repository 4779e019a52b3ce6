"""Port Avro ingest and interchange == the JAX package's.

Records written by either package decode the same in the other (the
container's sync marker is random, so records are compared, never file
bytes); the port's native decoder and its pure-Python route give the
JAX package's columns; `read_game_examples` gives the JAX package's
arrays, index maps and vocabularies for dense and CSR shards, through
either route; the decoder is built from the port's own copy of the C
source into build/photon_ml_tpu_torch/, and each reader counts its route.
Everything is host numpy: equality is exact.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from photon_ml_tpu.data import avro_codec as jcodec
from photon_ml_tpu.data import avro_game as jgame
from photon_ml_tpu.data import avro_io as jio
from photon_ml_tpu.data import avro_native as jnative
from photon_ml_tpu.data import index_map as jim
from photon_ml_tpu.data import stats as jstats
from photon_ml_tpu_torch.data import avro_codec as pcodec
from photon_ml_tpu_torch.data import avro_game as pgame
from photon_ml_tpu_torch.data import avro_io as pio
from photon_ml_tpu_torch.data import avro_native as pnative
from photon_ml_tpu_torch.data import index_map as pim
from photon_ml_tpu_torch.data import stats as pstats

ROOT = Path(__file__).resolve().parents[2]
N = 120
PACKAGES = {"port": (pcodec, pio, pgame, pim), "jax": (jcodec, jio, jgame, jim)}


def _game_arrays(seed=0):
    """Bags: 'global' (CSR, 40 columns, last = intercept), 'per_user'
    (dense, 6 columns, last = intercept); id columns; weights, offsets,
    uids, a metadata map (the queryId id tag, sometimes another key)."""
    rng = np.random.default_rng(seed)
    g = sp.random(N, 39, density=0.15, random_state=seed, format="csr")
    g = sp.hstack([g, np.ones((N, 1))]).tocsr()
    u = rng.normal(size=(N, 6))
    u[:, -1] = 1.0
    u[rng.uniform(size=(N, 6)) < 0.2] = 0.0
    u[:, -1] = 1.0
    ids = {"userId": np.asarray([f"u{v}" for v in rng.integers(0, 9, N)]),
           "itemId": np.asarray([str(v) for v in rng.integers(0, 5, N)])}
    meta = [{"queryId": f"q{i % 7}", **({"extra": "x"} if i % 3 else {})}
            for i in range(N)]
    return dict(response=(rng.uniform(size=N) < 0.4).astype(np.float64), g=g, u=u,
                ids=ids, weights=rng.uniform(0.5, 2, N), offsets=rng.normal(size=N),
                uids=[f"r{i}" for i in range(N)], meta=meta)


def _maps(im):
    return {"global": im.build_index_map([(f"g{j:02d}", "t" if j % 2 else "")
                                          for j in range(39)]),
            "per_user": im.build_index_map([(f"u{j}", "") for j in range(5)])}


def _write_game(pkg, path, a):
    _, _, game, im = PACKAGES[pkg]
    maps = _maps(im)
    game.write_game_examples(
        str(path), a["response"],
        {"globalFeatures": (a["g"], maps["global"]),
         "userFeatures": (a["u"], maps["per_user"])},
        id_values=a["ids"], weights=a["weights"], offsets=a["offsets"],
        uids=a["uids"], metadata=a["meta"])


@pytest.fixture(scope="module")
def game_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("avro")
    a = _game_arrays()
    out = {}
    for pkg in PACKAGES:
        out[pkg] = [d / f"{pkg}-part-{p}.avro" for p in range(2)]
        half = N // 2
        for p, rows in enumerate((slice(0, half), slice(half, N))):
            part = dict(a, response=a["response"][rows], g=a["g"][rows], u=a["u"][rows],
                        ids={k: v[rows] for k, v in a["ids"].items()},
                        weights=a["weights"][rows], offsets=a["offsets"][rows],
                        uids=a["uids"][rows], meta=a["meta"][rows])
            _write_game(pkg, out[pkg][p], part)
    return out


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_records_cross_decode(game_files, writer):
    """The same records, read by either package's codec."""
    for path in game_files[writer]:
        assert list(pcodec.read_container(str(path))) == \
            list(jcodec.read_container(str(path)))
    port_recs = [r for p in game_files["port"] for r in pcodec.read_container(str(p))]
    jax_recs = [r for p in game_files["jax"] for r in jcodec.read_container(str(p))]
    assert port_recs == jax_recs


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_native_columns_match_jax(game_files, writer):
    for path in game_files[writer]:
        got = pnative.read_columnar(str(path), decode_maps=True)
        want = jnative.read_columnar(str(path), decode_maps=True)
        assert got is not None and want is not None
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k].to_list() == want[k].to_list()


SHARD_MAP = {"global": ["globalFeatures"], "per_user": ["userFeatures"],
             "merged": ["globalFeatures", "userFeatures"]}


def _read(game, paths, route, **kw):
    if route == "python":
        return game._read_game_python(
            [str(p) for p in paths], SHARD_MAP, ["userId", "itemId", "queryId"],
            kw.get("index_maps"), game.InputColumnNames(), True,
            kw.get("dense_threshold", 4096), np.float32, kw.get("entity_vocabs"))
    return game.read_game_examples([str(p) for p in paths], SHARD_MAP,
                                   id_columns=["userId", "itemId", "queryId"], **kw)


def _assert_same_result(got, want):
    g, w = got.dataset, want.dataset
    assert got.uids == want.uids
    for a, b in ((g.response, w.response), (g.weights, w.weights), (g.offsets, w.offsets)):
        np.testing.assert_array_equal(a, b)
    assert sorted(g.feature_shards) == sorted(w.feature_shards)
    for s, x in w.feature_shards.items():
        y = g.feature_shards[s]
        assert sp.issparse(x) == sp.issparse(y), s
        np.testing.assert_array_equal(y.toarray() if sp.issparse(y) else y,
                                      x.toarray() if sp.issparse(x) else x)
        assert list(g.index_maps[s].index_to_key) == list(w.index_maps[s].index_to_key)
    for t in w.entity_indices:
        np.testing.assert_array_equal(g.entity_indices[t], w.entity_indices[t])
        assert list(g.entity_vocabs[t]) == list(w.entity_vocabs[t])


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("dense_threshold", [4096, 10])
def test_read_game_examples_matches_jax(game_files, route, dense_threshold):
    """Dense shards (all under 4,096 columns) and, at a threshold of 10,
    CSR shards: the same arrays, maps and vocabularies as the JAX reader's
    native route, the intercept rebuilt once."""
    want = _read(jgame, game_files["jax"], "native", dense_threshold=dense_threshold)
    got = _read(pgame, game_files["port"], route, dense_threshold=dense_threshold)
    _assert_same_result(got, want)
    x = got.dataset.feature_shards["global"]
    assert sp.issparse(x) == (dense_threshold == 10)
    dense = x.toarray() if sp.issparse(x) else x
    np.testing.assert_array_equal(dense[:, -1], 1.0)     # the intercept, once
    assert got.dataset.index_maps["global"].intercept_index == dense.shape[1] - 1


def test_pinned_read_matches_jax(game_files):
    """A read pinned to the training maps and vocabularies (validation)."""
    train_p = _read(pgame, game_files["port"][:1], "native")
    train_j = _read(jgame, game_files["jax"][:1], "native")
    got = _read(pgame, game_files["port"][1:], "native",
                index_maps=train_p.dataset.index_maps,
                entity_vocabs=train_p.dataset.entity_vocabs)
    want = _read(jgame, game_files["jax"][1:], "native",
                 index_maps=train_j.dataset.index_maps,
                 entity_vocabs=train_j.dataset.entity_vocabs)
    _assert_same_result(got, want)
    with pytest.raises(ValueError, match="covers no shard"):
        pgame.read_game_examples([str(game_files["port"][0])], SHARD_MAP,
                                 index_maps={"global": train_p.dataset.index_maps["global"]})


def test_routes_are_counted_and_unsupported_schemas_read_in_python(tmp_path, game_files):
    for k in pnative.ROUTES:
        pnative.ROUTES[k] = 0
    _read(pgame, game_files["port"], "native")
    assert pnative.ROUTES == {"native": 2, "python": 0}
    # a union of two non-null branches has no flat program: the Python codec
    schema = {"type": "record", "name": "R", "fields": [
        {"name": "response", "type": "double"},
        {"name": "odd", "type": ["int", "string"]},
        {"name": "features", "type": {"type": "array", "items": pio.FEATURE_AVRO}}]}
    recs = [{"response": 1.0, "odd": 3, "features": [{"name": "a", "term": "", "value": 2.0}]},
            {"response": 0.0, "odd": "x", "features": []}]
    path = str(tmp_path / "odd.avro")
    pcodec.write_container(path, schema, recs)
    assert pnative.compile_schema(schema) is None
    res = pgame.read_game_examples([path], {"global": ["features"]})
    assert pnative.ROUTES == {"native": 2, "python": 1}
    want = jgame.read_game_examples([path], {"global": ["features"]})
    _assert_same_result(res, want)


def test_decoder_is_built_from_the_ports_source():
    lib = pnative._load_lib()
    assert lib is not None, pnative.BUILD_ERROR
    so = pnative.library_path()
    assert so.parent == ROOT / "build" / "photon_ml_tpu_torch" and so.exists()
    assert Path(lib._name) == so
    assert pnative._SRC == ROOT / "photon_ml_tpu_torch" / "native" / "avro_decode.c"
    assert pnative._SRC.read_bytes() == \
        (ROOT / "photon_ml_tpu" / "native" / "avro_decode.c").read_bytes()


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_training_examples_cross_read(tmp_path, writer):
    _, wio, _, wim = PACKAGES[writer]
    a = _game_arrays(1)
    imap = wim.build_index_map([(f"u{j}", "") for j in range(5)])
    path = str(tmp_path / "t.avro")
    wio.write_training_examples(path, a["u"], a["response"], imap, weights=a["weights"],
                                offsets=a["offsets"], uids=a["uids"])
    got, want = pio.read_training_examples(path), jio.read_training_examples(path)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    assert list(got[5].index_to_key) == list(want[5].index_to_key)


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_model_and_score_records_cross_read(tmp_path, writer):
    """BayesianLinearModelAvro (fixed and random effect), LatentFactorAvro,
    ScoringResultAvro and FeatureSummarizationResultAvro written by one
    package read the same in both."""
    _, wio, _, wim = PACKAGES[writer]
    rng = np.random.default_rng(2)
    imap = wim.build_index_map([(f"f{j}", "x") for j in range(6)])
    means = rng.normal(size=imap.size)
    means[2] = 0.0
    wio.write_glm_avro(str(tmp_path / "glm.avro"), "fixed-effect", "logistic_regression",
                       means, imap, rng.uniform(size=imap.size))
    coefs = rng.normal(size=(4, imap.size))
    wio.write_random_effect_avro(str(tmp_path / "re.avro"), "poisson_regression",
                                 np.asarray(["a", "b", "c", "d"]), coefs, imap)
    wio.write_latent_factors_avro(str(tmp_path / "lf.avro"), ["r0", "r1"],
                                  rng.normal(size=(2, 3)))
    wio.write_scores_avro(str(tmp_path / "s.avro"), "m", rng.normal(size=5),
                          labels=np.ones(5), weights=None, uids=[str(i) for i in range(5)])
    stats = (pstats if writer == "port" else jstats).BasicStatisticalSummary.from_features(
        rng.normal(size=(30, imap.size)))
    wio.write_feature_stats_avro(str(tmp_path / "st.avro"), stats, imap)
    pmap = pim.build_index_map([(f"f{j}", "x") for j in range(6)])
    jmap = jim.build_index_map([(f"f{j}", "x") for j in range(6)])

    def same(a, b):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, (tuple, list)) and a and not isinstance(a[0], (str, tuple)):
            for x, y in zip(a, b):
                same(x, y)
        elif hasattr(a, "index_to_key"):
            assert list(a.index_to_key) == list(b.index_to_key)
        else:
            assert a == b

    for got, want in (
            (pio.read_glm_avro(str(tmp_path / "glm.avro"), pmap),
             jio.read_glm_avro(str(tmp_path / "glm.avro"), jmap)),
            (pio.read_random_effect_avro(str(tmp_path / "re.avro"), pmap),
             jio.read_random_effect_avro(str(tmp_path / "re.avro"), jmap)),
            (pio.read_latent_factors_avro(str(tmp_path / "lf.avro")),
             jio.read_latent_factors_avro(str(tmp_path / "lf.avro"))),
            (pio.read_scores_avro(str(tmp_path / "s.avro"))[:2],
             jio.read_scores_avro(str(tmp_path / "s.avro"))[:2]),
            (pio.read_feature_stats_avro(str(tmp_path / "st.avro")),
             jio.read_feature_stats_avro(str(tmp_path / "st.avro")))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    assert os.path.exists(tmp_path / "glm.avro")
