"""The port's copy of the synthetic generators gives byte-identical arrays
to the JAX package's for the same seed."""
import numpy as np
import pytest

from photon_ml_tpu.data import synthetic_bench as J
from photon_ml_tpu_torch.data import synthetic_bench as T


def _same(a, b):
    if hasattr(a, "tocsr"):  # scipy.sparse
        a, b = a.tocsr(), b.tocsr()
        for f in ("data", "indices", "indptr"):
            _same(getattr(a, f), getattr(b, f))
        assert a.shape == b.shape
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_generator_version():
    assert T.GENERATOR_VERSION == J.GENERATOR_VERSION


@pytest.mark.parametrize("task", ["logistic", "linear", "poisson", "hinge"])
def test_a1a_like(task):
    for a, b in zip(J.make_a1a_like(2, task, seed=42), T.make_a1a_like(2, task, seed=42)):
        _same(a, b)
    _same(J.make_a1a_features(1, seed=3), T.make_a1a_features(1, seed=3))


def test_movielens_like():
    j = J.make_movielens_like("1m", seed=7, n_rows=3000)
    t = T.make_movielens_like("1m", seed=7, n_rows=3000)
    for f in ("user_ids", "item_ids", "response", "x_global", "x_user", "x_item"):
        _same(getattr(j, f), getattr(t, f))
    assert (j.num_users, j.num_items) == (t.num_users, t.num_items)
    assert sorted(J.movielens_shards(j)) == sorted(T.movielens_shards(t))


def test_wide_sparse_and_yahoo_like():
    for a, b in zip(J.make_wide_sparse_logistic(200, d=5000, nnz=8),
                    T.make_wide_sparse_logistic(200, d=5000, nnz=8)):
        _same(a, b)
    j = J.make_yahoo_like(300, d_global=2000, num_users=50, num_items=80)
    t = T.make_yahoo_like(300, d_global=2000, num_users=50, num_items=80)
    for f in ("user_ids", "item_ids", "response", "x_global", "x_user", "x_item"):
        _same(getattr(j, f), getattr(t, f))
