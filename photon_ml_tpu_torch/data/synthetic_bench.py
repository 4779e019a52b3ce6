"""Statistically-matched synthetic replicas of the benchmark corpora.

A copy of photon_ml_tpu/data/synthetic_bench.py (numpy only): the port
imports nothing of the JAX package, and tests/port/test_torch_synthetic.py
holds both copies to byte-identical output for the same seed.

a1a (LIBSVM adult): n=1605 train rows, d=123 binary one-hot features,
density ~0.115, ~24% positive labels, replicated `replicas`x row-wise for
throughput-scale runs.  MovieLens-1M/-20M replicas carry a planted
mixed-effect structure (global + per-user + per-item weights).  Every
result produced from these generators is a synthetic-replica result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Bump whenever any generator in this module changes its output for a given
# seed.  bench.py folds this into its reference-optimum cache keys so a
# generator change can never silently reuse stale float64 reference NLLs.
GENERATOR_VERSION = "g2"


def make_a1a_features(replicas: int = 1, seed: int = 42,
                      density: float = 0.115) -> np.ndarray:
    """[1605*replicas, 124] binary features (+ intercept column last)."""
    rng = np.random.default_rng(seed)
    n, d = 1605 * replicas, 124
    x = (rng.uniform(size=(n, d)) < density).astype(np.float32)
    x[:, -1] = 1.0
    return x


def make_a1a_like(replicas: int = 1, task: str = "logistic", seed: int = 42):
    """(x, y) at a1a's shape with labels from a planted GLM.

    tasks: logistic (binary 0/1), linear (gaussian), poisson (counts),
    hinge (binary, for the smoothed-hinge SVM config)."""
    x = make_a1a_features(replicas, seed)
    rng = np.random.default_rng(seed + 1)
    n, d = x.shape
    w = (rng.normal(size=d) * 0.7).astype(np.float64)
    z = x.astype(np.float64) @ w
    if task == "logistic" or task == "hinge":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    elif task == "linear":
        y = (z + rng.normal(size=n)).astype(np.float32)
    elif task == "poisson":
        # scale margins down so planted rates stay sane (exp overflow guard)
        y = rng.poisson(np.exp(0.25 * z)).astype(np.float32)
    else:
        raise ValueError(task)
    return x, y


@dataclasses.dataclass
class MovieLensLike:
    """One synthetic-replica ratings table plus its planted truth."""

    user_ids: np.ndarray      # [n] int
    item_ids: np.ndarray      # [n] int
    response: np.ndarray      # [n] float32, binarized rating >= 4
    # feature shards, canonical row order
    x_global: np.ndarray      # [n, d_global] float32 (item genres ++ user
    #                           demographic buckets ++ intercept)
    x_user: np.ndarray        # [n, d_user]  float32 (item genres ++ intercept
    #                           — the per-USER model sees ITEM features)
    x_item: np.ndarray        # [n, d_item]  float32 (user buckets ++ intercept)
    num_users: int
    num_items: int


def make_movielens_like(
    scale: str = "1m",
    seed: int = 7,
    n_rows: Optional[int] = None,
    user_effect_scale: float = 1.0,
    item_effect_scale: float = 0.5,
) -> MovieLensLike:
    """Synthetic replica matched to MovieLens-1M / -20M shape statistics.

    Row counts, user/item cardinalities, and genre dimensionality follow the
    published corpus stats (see module docstring); user activity ~ lognormal
    matched to the heavy tail, item popularity ~ Zipf.  Response is
    logistic( global + per-user + per-item planted effects ).
    """
    if scale == "1m":
        n, num_users, num_items, n_genres = 1_000_209, 6040, 3706, 18
    elif scale == "20m":
        n, num_users, num_items, n_genres = 20_000_263, 138_493, 26_744, 20
    else:
        raise ValueError(scale)
    if n_rows is not None:
        n = int(n_rows)
    rng = np.random.default_rng(seed)

    # --- entities ---------------------------------------------------------
    # user activity: lognormal propensities (heavy tail, every user >= ~20
    # ratings in the real corpus; sampling with replacement approximates it)
    user_prop = rng.lognormal(mean=0.0, sigma=1.1, size=num_users)
    user_prop /= user_prop.sum()
    user_ids = rng.choice(num_users, size=n, p=user_prop).astype(np.int32)
    # item popularity: Zipf-ish via lognormal with a fatter tail
    item_prop = rng.lognormal(mean=0.0, sigma=1.4, size=num_items)
    item_prop /= item_prop.sum()
    item_ids = rng.choice(num_items, size=n, p=item_prop).astype(np.int32)

    # --- static entity features -----------------------------------------
    # items: ~2 genres each on average (multi-hot) + a popularity bucket
    item_genres = (rng.uniform(size=(num_items, n_genres))
                   < (2.0 / n_genres)).astype(np.float32)
    # users: gender (1 col) + 7 age buckets + 4 occupation buckets, one-hot
    n_user_feats = 1 + 7 + 4
    user_feats = np.zeros((num_users, n_user_feats), dtype=np.float32)
    user_feats[:, 0] = rng.uniform(size=num_users) < 0.28  # ML-1M F share
    age = rng.integers(0, 7, size=num_users)
    user_feats[np.arange(num_users), 1 + age] = 1.0
    occ = rng.integers(0, 4, size=num_users)
    user_feats[np.arange(num_users), 8 + occ] = 1.0

    # --- planted truth ----------------------------------------------------
    d_global = n_genres + n_user_feats + 1
    d_user = n_genres + 1          # per-user model over item genres
    d_item = n_user_feats + 1      # per-item model over user buckets
    w_global = rng.normal(size=d_global) * 0.8
    w_user = rng.normal(size=(num_users, d_user)) * user_effect_scale
    w_item = rng.normal(size=(num_items, d_item)) * item_effect_scale

    ig = item_genres[item_ids]                     # [n, n_genres]
    uf = user_feats[user_ids]                      # [n, n_user_feats]
    ones = np.ones((n, 1), dtype=np.float32)
    x_global = np.concatenate([ig, uf, ones], axis=1)
    x_user = np.concatenate([ig, ones], axis=1)
    x_item = np.concatenate([uf, ones], axis=1)

    z = x_global.astype(np.float64) @ w_global
    z = z + np.einsum("nd,nd->n", x_user.astype(np.float64), w_user[user_ids])
    z = z + np.einsum("nd,nd->n", x_item.astype(np.float64), w_item[item_ids])
    response = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)

    return MovieLensLike(user_ids=user_ids, item_ids=item_ids,
                         response=response, x_global=x_global,
                         x_user=x_user, x_item=x_item,
                         num_users=num_users, num_items=num_items)


def movielens_shards(ml: MovieLensLike) -> Dict[str, np.ndarray]:
    return {"global": ml.x_global, "per_user": ml.x_user,
            "per_item": ml.x_item}


def make_wide_sparse_logistic(n: int, d: int = 250_000, nnz: int = 64,
                              seed: int = 77):
    """Wide sparse logistic fixture: [n, d] binary CSR with `nnz` active
    features per row (hashed-feature shape; reference: the >200k-feature
    depth-switch regime, GameEstimator.scala:667-669) + labels from a
    planted sparse GLM.  Column d-1 is the intercept."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz)
    cols = rng.integers(0, d - 1, size=n * nnz)
    x = sp.coo_matrix((np.ones(n * nnz, np.float32), (rows, cols)),
                      shape=(n, d)).tocsr()
    x.sum_duplicates()
    x.data[:] = 1.0                      # binary features, exact in bf16
    icpt = sp.csr_matrix(np.ones((n, 1), np.float32))
    x = sp.hstack([x[:, :d - 1], icpt]).tocsr()
    w = (rng.normal(size=d) * (0.35 / np.sqrt(nnz))).astype(np.float64)
    z = x.astype(np.float64) @ w
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return x, y


@dataclasses.dataclass
class YahooLike:
    """Yahoo!-Music-fixture-shaped GAME data: a WIDE sparse global shard
    (the DriverTest e2e asserts 14,983 fixed-effect coefficients,
    photon-client/src/integTest/.../DriverTest.scala:96-98) + narrow dense
    per-user / per-item shards."""

    user_ids: np.ndarray
    item_ids: np.ndarray
    response: np.ndarray
    x_global: object          # [n, d_global] scipy CSR
    x_user: np.ndarray        # [n, d_user] float32
    x_item: np.ndarray        # [n, d_item] float32
    num_users: int
    num_items: int


def make_yahoo_like(n_rows: int, d_global: int = 14_983, nnz_global: int = 24,
                    num_users: int = 2_000, num_items: int = 10_000,
                    d_user: int = 21, d_item: int = 21,
                    seed: int = 23) -> YahooLike:
    """FE (wide sparse) + per-user RE + per-item RE logistic fixture at the
    Yahoo integration-test shape."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    n = int(n_rows)
    user_ids = rng.integers(0, num_users, size=n).astype(np.int32)
    item_ids = rng.integers(0, num_items, size=n).astype(np.int32)

    rows = np.repeat(np.arange(n), nnz_global)
    cols = rng.integers(0, d_global - 1, size=n * nnz_global)
    xg = sp.coo_matrix((np.ones(n * nnz_global, np.float32), (rows, cols)),
                       shape=(n, d_global)).tocsr()
    xg.sum_duplicates()
    xg.data[:] = 1.0
    icpt = sp.csr_matrix(np.ones((n, 1), np.float32))
    xg = sp.hstack([xg[:, :d_global - 1], icpt]).tocsr()

    xu = rng.normal(size=(n, d_user)).astype(np.float32)
    xu[:, -1] = 1.0
    xi = rng.normal(size=(n, d_item)).astype(np.float32)
    xi[:, -1] = 1.0

    w_g = (rng.normal(size=d_global) * (0.4 / np.sqrt(nnz_global)))
    w_u = rng.normal(size=(num_users, d_user)) * 0.5
    w_i = rng.normal(size=(num_items, d_item)) * 0.3
    z = xg.astype(np.float64) @ w_g
    z = z + np.einsum("nd,nd->n", xu.astype(np.float64), w_u[user_ids])
    z = z + np.einsum("nd,nd->n", xi.astype(np.float64), w_i[item_ids])
    response = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return YahooLike(user_ids=user_ids, item_ids=item_ids, response=response,
                     x_global=xg, x_user=xu, x_item=xi,
                     num_users=num_users, num_items=num_items)


def pipeline_arrays(n: int, d_global: int, n_users: int, d_user: int, seed: int,
                    n_items: int = 0, d_item: int = 0):
    """A numpy copy of bench.py's `_pipeline_dataset` draws: GLMix-shaped
    data with round-robin entity assignment (every entity has n/n_users
    rows, one S-bucket).  -> (y, feature shards, entity id columns), all
    float64 / str numpy arrays, in bench.py's draw order."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(n, d_global))
    xg[:, -1] = 1.0
    xu = rng.normal(size=(n, d_user))
    xu[:, -1] = 1.0
    users = np.arange(n) % n_users
    w_g = rng.normal(size=d_global)
    w_u = rng.normal(size=(n_users, d_user)) * 0.5
    z = xg @ w_g + np.einsum("nd,nd->n", xu, w_u[users])
    shards = {"global": xg, "per_user": xu}
    entity_ids = {"userId": np.asarray([f"u{u:06d}" for u in users])}
    if n_items:
        xi = rng.normal(size=(n, d_item))
        xi[:, -1] = 1.0
        items = np.arange(n) % n_items
        w_i = rng.normal(size=(n_items, d_item)) * 0.5
        z = z + np.einsum("nd,nd->n", xi, w_i[items])
        shards["per_item"] = xi
        entity_ids["itemId"] = np.asarray([f"i{i:06d}" for i in items])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    return y, shards, entity_ids


def pipeline_dataset(n: int, d_global: int, n_users: int, d_user: int, seed: int,
                     n_items: int = 0, d_item: int = 0):
    """bench.py's `_pipeline_dataset`: the first 95% of the rows train, the
    rest validate.  -> (train, validation) GameDatasets of the port."""
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    y, shards, entity_ids = pipeline_arrays(n, d_global, n_users, d_user, seed,
                                            n_items, d_item)
    ds = build_game_dataset(y, shards, entity_ids=entity_ids)
    rows = np.arange(n)
    return ds.subset(rows[: int(n * 0.95)]), ds.subset(rows[int(n * 0.95):])
