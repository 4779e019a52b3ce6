"""Port index maps, date ranges, named constraints, data validators and the
durable-write helpers == the JAX package's, on the same inputs.

These are host modules (numpy and the standard library only), compared
in-process: no XLA program is compiled here.  Equality is exact (keys,
paths, bounds, error messages); the constrained solve holds its named
constraints equal to the positional box they resolve to (f64, rtol 1e-12).
"""
import dataclasses
import datetime
import json
import math
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import date_range as jdr
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.data import index_map as jim
from photon_ml_tpu.data import validators as jval
from photon_ml_tpu.game.config import GameTrainingConfig as JConfig
from photon_ml_tpu.optim import constraints as jcon
from photon_ml_tpu_torch.data import date_range as pdr
from photon_ml_tpu_torch.data import game_data as pgd
from photon_ml_tpu_torch.data import index_map as pim
from photon_ml_tpu_torch.data import validators as pval
from photon_ml_tpu_torch.data.synthetic_bench import make_a1a_like
from photon_ml_tpu_torch.game.config import GameTrainingConfig
from photon_ml_tpu_torch.models.training import train_glm
from photon_ml_tpu_torch.optim import constraints as pcon
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, RegularizationContext, RegularizationType,
)
from photon_ml_tpu_torch.utils import durable

import game_jax_side as side

PAIRS = [("age", ""), ("country", "us"), ("country", "fr"), ("zeta", "1"),
         ("(INTERCEPT)", ""), ("é", "ü"), ("age", "")]


@pytest.mark.parametrize("add_intercept", [True, False])
def test_index_maps_match_jax(add_intercept):
    pm = pim.build_index_map(PAIRS, add_intercept=add_intercept)
    jm = jim.build_index_map(PAIRS, add_intercept=add_intercept)
    assert list(pm.index_to_key) == list(jm.index_to_key)
    assert pm.key_to_index == jm.key_to_index
    assert (pm.intercept_index, pm.has_intercept, pm.size) == \
        (jm.intercept_index, jm.has_intercept, jm.size)
    for name, term in PAIRS + [("unseen", "")]:
        assert pm.index_of(name, term) == jm.index_of(name, term)
    assert [pm.name_term(i) for i in range(pm.size)] == \
        [jm.name_term(i) for i in range(jm.size)]
    assert pim.feature_key("a", "b") == jim.feature_key("a", "b")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_map_collections_cross_load(tmp_path, writer):
    maps = {"global": PAIRS[:4], "per_user": [("u", str(i)) for i in range(5)]}
    w, r = (pim, jim) if writer == "port" else (jim, pim)
    w.IndexMapCollection({s: w.build_index_map(p) for s, p in maps.items()}).save(
        str(tmp_path / "maps"))
    loaded = r.IndexMapCollection.load(str(tmp_path / "maps")).shards
    assert sorted(loaded) == sorted(maps)
    for s, p in maps.items():
        assert list(loaded[s].index_to_key) == list(jim.build_index_map(p).index_to_key)


def test_date_ranges_match_jax(tmp_path):
    today = datetime.date(2024, 3, 2)
    for day in ("2024/02/27", "2024/02/29", "2024/03/01"):
        os.makedirs(tmp_path / "daily" / day)
    base = str(tmp_path)
    for kw in ({"date_range": "20240226-20240301"}, {"days_ago": "5-1"},
               {"date_range": "20240228-20240228"}, {}):
        want = got = None
        try:
            want = jdr.paths_for_date_range(base, today=today, **kw)
        except (ValueError, FileNotFoundError) as e:
            want = (type(e), str(e))
        try:
            got = pdr.paths_for_date_range(base, today=today, **kw)
        except (ValueError, FileNotFoundError) as e:
            got = (type(e), str(e))
        assert got == want, kw
    for bad in ("20240301-20240226", "2024-03", "x"):
        with pytest.raises(ValueError) as pe:
            pdr.parse_date_range(bad)
        with pytest.raises(ValueError) as je:
            jdr.parse_date_range(bad)
        assert str(pe.value) == str(je.value)
    assert pdr.parse_days_ago("90-1", today) == jdr.parse_days_ago("90-1", today)
    with pytest.raises(ValueError):
        pdr.paths_for_date_range(base, "20240101-20240102", "3-1")


CONSTRAINTS = {
    "named": [{"name": "country", "term": "us", "lowerBound": -0.5},
              {"name": "age", "term": "", "lowerBound": 0.0, "upperBound": 2.0}],
    "name_wildcard": [{"name": "country", "term": "*", "upperBound": 1.0},
                      {"name": "zeta", "term": "1", "lowerBound": -1.0, "upperBound": 1.0}],
    "all": [{"name": "*", "term": "*", "lowerBound": -0.25, "upperBound": 0.25}],
    "unseen_skipped": [{"name": "nope", "term": "", "lowerBound": 0.0}],
    "tuples": [("age", "", -1.0, math.inf)],
}
BAD_CONSTRAINTS = {
    "unbounded": [{"name": "a", "term": ""}],
    "reversed": [{"name": "a", "term": "", "lowerBound": 1.0, "upperBound": 0.0}],
    "name_star_alone": [{"name": "*", "term": "x", "lowerBound": 0.0}],
    "all_not_alone": [{"name": "*", "term": "*", "lowerBound": 0.0},
                      {"name": "a", "term": "", "lowerBound": 0.0}],
    "unknown_key": [{"name": "a", "term": "", "lower": 0.0}],
    "no_term": [{"name": "a", "lowerBound": 0.0}],
}


@pytest.mark.parametrize("case", list(CONSTRAINTS))
def test_constraints_resolve_as_jax(case):
    raw = CONSTRAINTS[case]
    pn, jn = pcon.normalize_constraints(raw), jcon.normalize_constraints(raw)
    assert pn == jn
    assert pcon.constraints_to_json(pn) == jcon.constraints_to_json(jn)
    pm, jm = pim.build_index_map(PAIRS), jim.build_index_map(PAIRS)
    assert pcon.resolve_constraints(pn, pm) == jcon.resolve_constraints(jn, jm)
    cfg = OptimizerConfig(constraints=tuple(raw))
    lower, upper = jcon.resolve_constraints(jn, jm)
    resolved = cfg.resolved_constraints(pm)
    assert (resolved.box_lower, resolved.box_upper, resolved.constraints) == \
        (lower, upper, None)


@pytest.mark.parametrize("case", list(BAD_CONSTRAINTS))
def test_bad_constraints_raise_as_jax(case):
    raw = BAD_CONSTRAINTS[case]
    with pytest.raises(ValueError) as pe:
        pcon.normalize_constraints(raw)
    with pytest.raises(ValueError) as je:
        jcon.normalize_constraints(raw)
    assert str(pe.value) == str(je.value)


def test_conflicting_and_unresolved_constraints_raise():
    pm = pim.build_index_map(PAIRS)
    dup = pcon.normalize_constraints([{"name": "country", "term": "*", "upperBound": 1.0},
                                      {"name": "country", "term": "us", "lowerBound": 0.0}])
    with pytest.raises(ValueError, match="conflicting bounds"):
        pcon.resolve_constraints(dup, pm)
    with pytest.raises(ValueError, match="exclusive"):
        OptimizerConfig(constraints=({"name": "a", "term": "", "lowerBound": 0.0},),
                        box_lower=(0.0,))
    with pytest.raises(ValueError, match="index map"):
        OptimizerConfig(constraints=tuple(CONSTRAINTS["named"])).resolved_constraints(None)


def test_config_json_with_constraints_matches_jax():
    """model-metadata.json embeds GameTrainingConfig.to_dict: with named
    constraints it is the JAX package's dict, and each package loads the
    other's."""
    d = side.glmix_config_dict()
    d["coordinates"]["fixed"]["optimization"]["optimizer"]["constraints"] = \
        CONSTRAINTS["named"]
    port, jax_cfg = GameTrainingConfig.from_dict(d), JConfig.from_dict(d)
    assert port.to_dict() == jax_cfg.to_dict()
    assert GameTrainingConfig.from_json(jax_cfg.to_json()).to_dict() == jax_cfg.to_dict()
    assert JConfig.from_json(port.to_json()).to_dict() == port.to_dict()


def test_named_constraints_solve_as_their_box():
    """train_glm with named constraints == train_glm with the positional
    box they resolve to (f64 CPU, rtol 1e-12), and the box binds."""
    x, y = make_a1a_like(1, "logistic", seed=3)
    x, y = x[:600].astype(np.float64), y[:600].astype(np.float64)
    imap = pim.build_index_map([(f"f{j:03d}", "") for j in range(x.shape[1] - 1)])
    raw = ({"name": "*", "term": "*", "lowerBound": -0.05, "upperBound": 0.05},)
    common = dict(regularization=RegularizationContext(RegularizationType.L2),
                  regularization_weights=(1.0,), device="cpu")
    named = train_glm(x, y, "logistic_regression", index_map=imap,
                      optimizer_config=OptimizerConfig(max_iterations=50, constraints=raw),
                      **common)[0]
    lo, hi = pcon.resolve_constraints(pcon.normalize_constraints(raw), imap)
    boxed = train_glm(x, y, "logistic_regression",
                      optimizer_config=OptimizerConfig(max_iterations=50, box_lower=lo,
                                                       box_upper=hi), **common)[0]
    a, b = named.model.coefficients.means, boxed.model.coefficients.means
    torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    assert float(a[:-1].abs().max()) == pytest.approx(0.05)   # binds
    assert abs(float(a[-1])) > 0.05                            # intercept free


def _datasets():
    rng = np.random.default_rng(4)
    n = 50
    x = rng.normal(size=(n, 3))
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    out = {"ok": (y, x, None, None)}
    yb = y.copy(); yb[7] = 0.5
    out["non_binary_label"] = (yb, x, None, None)
    xb = x.copy(); xb[11, 2] = np.nan
    out["non_finite_feature"] = (y, xb, None, None)
    w = np.ones(n); w[3] = -1.0; w[9] = 0.0
    out["non_positive_weight"] = (y, x, w, None)
    o = np.zeros(n); o[5] = np.inf
    out["non_finite_offset"] = (y, x, None, o)
    return out


@pytest.mark.parametrize("task", ["logistic_regression", "poisson_regression",
                                  "linear_regression"])
@pytest.mark.parametrize("case", list(_datasets()))
@pytest.mark.parametrize("mode", ["full", "sample", "disabled"])
def test_data_validators_match_jax(task, case, mode):
    y, x, w, o = _datasets()[case]
    if task == "poisson_regression":
        y = np.where(np.arange(len(y)) == 2, -1.0, y)
    outcome = []
    for gd, val in ((pgd, pval), (jgd, jval)):
        ds = gd.build_game_dataset(y, {"global": x}, weights=w, offsets=o)
        try:
            val.validate_game_dataset(ds, task, mode)
            outcome.append(None)
        except ValueError as e:
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]
    assert [t.value for t in pval.DataValidationType] == \
        [t.value for t in jval.DataValidationType]


def test_durable_writes(tmp_path):
    p = str(tmp_path / "meta.json")
    durable.atomic_write_json(p, {"a": [1, 2]})
    durable.atomic_write_text(str(tmp_path / "id-info"), "userId\nshard\n")
    durable.write_marker(str(tmp_path / "_SUCCESS"))
    assert json.loads(open(p).read()) == {"a": [1, 2]}
    assert open(tmp_path / "id-info").read() == "userId\nshard\n"
    assert sorted(os.listdir(tmp_path)) == ["_SUCCESS", "id-info", "meta.json"]


def test_game_dataset_npz_cross_loads(tmp_path):
    """save_game_dataset of either package loads in the other (dense and
    CSR shards, offsets, weights, entity columns)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(5)
    n = 40
    shards = {"global": rng.normal(size=(n, 4)),
              "wide": sp.random(n, 30, density=0.1, random_state=1, format="csr")}
    ids = {"userId": rng.integers(0, 6, n), "itemId": np.asarray([f"i{v}" for v in
                                                                 rng.integers(0, 4, n)])}
    for writer, reader in ((pgd, jgd), (jgd, pgd)):
        ds = writer.build_game_dataset(rng.normal(size=n), shards, entity_ids=ids,
                                       weights=rng.uniform(1, 2, n),
                                       offsets=rng.normal(size=n))
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.npz")
        writer.save_game_dataset(ds, path)
        back = reader.load_game_dataset(path)
        for a, b in ((ds.response, back.response), (ds.weights, back.weights),
                     (ds.offsets, back.offsets), (ds.feature_shards["global"],
                                                  back.feature_shards["global"]),
                     (ds.feature_shards["wide"].toarray(),
                      back.feature_shards["wide"].toarray())):
            np.testing.assert_array_equal(a, b)
        for t in ids:
            np.testing.assert_array_equal(ds.entity_indices[t], back.entity_indices[t])
            assert list(ds.entity_vocabs[t]) == list(back.entity_vocabs[t])
    assert dataclasses.is_dataclass(pgd.GameDataset)
