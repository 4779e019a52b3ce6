"""chip_smoke.py's host-side pieces, on the CPU: the key of a scipy optimum
in bench_ref_cache.json is recomputed as bench.py computes it, for a dense
and for a CSR design matrix, and the script refuses to run without CUDA."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _bench_key(task, seed, x, y, l1, l2, box):
    """bench.py glm_entry's key, as it builds it."""
    return (f"scipy:{task}:seed{seed}:{x.shape[0]}x{x.shape[1]}:l1={l1}:l2={l2}:box={box}"
            f":fp={bench._data_fingerprint(x, y)}")


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_scipy_ref_key_is_bench_key(kind):
    from photon_ml_tpu_torch.data.synthetic_bench import make_wide_sparse_logistic
    x, y = make_wide_sparse_logistic(300, d=2000, nnz=8, seed=77)
    if kind == "dense":
        x = np.asarray(x.todense())
    got = chip_smoke.scipy_ref_key("logistic_regression", 77, x, y, 0.0, 1.0, None)
    assert got == _bench_key("logistic_regression", 77, x, y, 0.0, 1.0, None)
    # the two branches hash different bytes
    other = np.asarray(x.todense()) if kind == "csr" else sp.csr_matrix(x)
    assert chip_smoke.scipy_ref_key("logistic_regression", 77, other, y, 0.0, 1.0,
                                    None) != got


def test_config6_key_is_in_the_reference_cache():
    """The key config 6's phase recomputes on the card names an entry of
    the committed cache (its fingerprint is what the card run prints)."""
    cache = json.loads((ROOT / "bench_ref_cache.json").read_text())
    prefix = (f"scipy:logistic_regression:seed{chip_smoke.CONFIG6_SEED}:"
              f"{chip_smoke.CONFIG6_N}x{chip_smoke.CONFIG6_D}:l1=0.0:l2=1.0:box=None:fp=")
    keys = [k for k in cache if k.startswith(prefix)]
    assert len(keys) == 1 and keys[0].endswith("fp=g2-fc2e14269cdd1246")
    assert abs(cache[keys[0]]["ref_nll"] - 35659.73165913693) < 1e-9
    assert chip_smoke.YAHOO_REF_KEY in cache


def test_host_objective_takes_csr():
    from photon_ml_tpu_torch.data.synthetic_bench import make_wide_sparse_logistic
    x, y = make_wide_sparse_logistic(500, d=3000, nnz=8, seed=1)
    w = np.random.default_rng(0).normal(size=3000) * 0.1
    dense = chip_smoke.host_objective(np.asarray(x.todense()), y, w, 1.0)
    np.testing.assert_allclose(chip_smoke.host_objective(x, y, w, 1.0), dense, rtol=1e-12)


def test_exits_without_cuda(tmp_path):
    """No CUDA here: a non-zero exit and nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_config5_keys_are_in_the_reference_cache():
    """Both config 5 entries' float64 references are committed, under the
    keys bench.py's game_entry writes for _game_setup("20m", 2,000,000,
    seed=13, mode=...)."""
    cache = json.loads((ROOT / "bench_ref_cache.json").read_text())
    want = {"convex": 744219.0750334203, "full": 550487.7124439895}
    for mode, key in chip_smoke.CONFIG5_REF_KEYS.items():
        assert key == (f"20m:{chip_smoke.CONFIG5_ROWS}:{chip_smoke.CONFIG5_SEED}:{mode}:"
                       "v=g2")
        assert abs(cache[key]["ref_nll"] - want[mode]) < 1e-9


def test_config5_setup_is_bench_setup():
    """chip_smoke's config 5 data and configurations are bench.py's
    _game_setup float32 ones (at 4,000 rows here): the same rows, labels,
    shards and split, and configurations whose JSON is the JAX package's."""
    train, val, convex, full = chip_smoke.config5_setup(4000)
    for mode, cfg in (("convex", convex), ("full", full)):
        j_train, j_val, j_cfg = bench._game_setup("20m", 4000, seed=chip_smoke.CONFIG5_SEED,
                                                  dtype=np.float32, mode=mode)
        assert cfg.to_dict() == j_cfg.to_dict()
        for mine, theirs in ((train, j_train), (val, j_val)):
            np.testing.assert_array_equal(mine.response, theirs.response)
            assert mine.feature_shards.keys() == theirs.feature_shards.keys()
            for k in mine.feature_shards:
                np.testing.assert_array_equal(mine.feature_shards[k], theirs.feature_shards[k])
            for k in ("userId", "itemId"):
                np.testing.assert_array_equal(mine.entity_indices[k], theirs.entity_indices[k])
    assert {k: v.shape[1] for k, v in train.feature_shards.items()} == {
        "global": 33, "per_user": 21, "per_item": 13}


@pytest.fixture(scope="module")
def config7_avro(tmp_path_factory):
    """chip_smoke's config 7 datasets at 3,000 rows, written as Avro part
    files by its writer (in this process: no fork of the test process), and
    read back twice: pinned to the
    writer's maps, and as cli_avro reads them (training maps scanned,
    validation pinned to them)."""
    from photon_ml_tpu_torch.data.avro_game import read_game_examples
    rows = chip_smoke.YAHOO_ROWS
    chip_smoke.YAHOO_ROWS = 3000
    try:
        train, val, cfg = chip_smoke.yahoo_setup()
    finally:
        chip_smoke.YAHOO_ROWS = rows
    written = chip_smoke.write_yahoo_avro({"train": train, "validation": val},
                                          tmp_path_factory.mktemp("avro"), writers=1)
    shard_map = {bag: [bag] for bag in chip_smoke.YAHOO_BAGS}
    files = lambda split: sorted(str(p) for p in written["dirs"][split].glob("*.avro"))
    ids = ["userId", "itemId"]
    pinned = read_game_examples(files("train"), shard_map, ids,
                                index_maps=written["maps"]).dataset
    scanned = read_game_examples(files("train"), shard_map, ids).dataset
    scanned_val = read_game_examples(files("validation"), shard_map, ids,
                                     index_maps=scanned.index_maps,
                                     entity_vocabs=scanned.entity_vocabs).dataset
    return train, val, cfg, written, pinned, scanned, scanned_val


def test_avro_writer_reproduces_config7_data(config7_avro):
    """Pinned to the writer's maps, the read is yahoo_setup's training set:
    the same rows, labels and shards (the intercept skipped on write and
    rebuilt once on read), entities up to the order of their vocabulary;
    scanned, the same up to the columns no row uses."""
    import scipy.sparse as sp
    train, _, _, written, pinned, scanned, _ = config7_avro
    assert written["rows"] == 3000 and written["files"] == 2
    np.testing.assert_array_equal(pinned.response, train.response)
    for shard, x in train.feature_shards.items():
        got = pinned.feature_shards[shard]
        assert sp.issparse(got) == sp.issparse(x) == (shard == "global")
        dense = lambda a: a.toarray() if sp.issparse(a) else np.asarray(a)
        np.testing.assert_array_equal(dense(got), dense(x))
        keys = scanned.index_maps[shard].index_to_key
        cols = [written["maps"][shard].key_to_index[str(k)] for k in keys]
        np.testing.assert_array_equal(dense(scanned.feature_shards[shard]), dense(x)[:, cols])
        unused = np.setdiff1d(np.arange(x.shape[1]), cols)
        assert not dense(x)[:, unused].any()
    for t in ("userId", "itemId"):
        raw = np.asarray(train.entity_vocabs[t])[train.entity_indices[t]]
        back = np.asarray(pinned.entity_vocabs[t])[pinned.entity_indices[t]]
        assert [str(v) for v in raw] == list(back)


def test_avro_read_fits_config7_alike(config7_avro):
    """Config 7 fit on the Avro-read datasets (float64, CPU) == on
    yahoo_setup's: the objective and AUC histories within 1e-9 relative
    (the same problem up to a permutation of columns and entities)."""
    import torch
    from photon_ml_tpu_torch.game import GameEstimator
    train, val, cfg, _, _, scanned, scanned_val = config7_avro
    fits = [GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(t, v, ["AUC"])
            for t, v in ((train, val), (scanned, scanned_val))]
    np.testing.assert_allclose(fits[1].objective_history, fits[0].objective_history,
                               rtol=1e-9)
    np.testing.assert_allclose(fits[1].descent.validation_history["AUC"],
                               fits[0].descent.validation_history["AUC"], rtol=1e-9)
