"""The port's grouped segment metrics (evaluation/segmented.py) and the
MultiEvaluator that routes grouped metrics through them == the JAX
package's, in float64 on the CPU (tolerance 1e-12: the same numpy
arithmetic, the losses' elementwise values from torch against XLA).

Groups of one row, single-class groups (AUC NaN), groups smaller than k,
ties inside and across groups, weights and NaN positions are all covered."""
import numpy as np
import pytest

from photon_ml_tpu.evaluation import evaluators as JE
from photon_ml_tpu.evaluation import segmented as JS
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu_torch.evaluation import evaluators as TE
from photon_ml_tpu_torch.evaluation import segmented as TS
from photon_ml_tpu_torch.ops import losses as TL

TOL = 1e-12


def _grouped(seed=0, n=2000, groups=150):
    """Group-sorted scores, labels and weights with their bounds: a group
    of one row, an all-positive and an all-negative group, tied scores."""
    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(0, groups, size=n))
    gid[:1] = -1                                      # dropped by evaluate_grouped
    scores = np.round(rng.normal(size=n), 1)          # many ties
    labels = (rng.uniform(size=n) < 0.4).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=n)
    labels[gid == 3] = 1.0
    labels[gid == 4] = 0.0
    return gid, scores, labels, weights


def _bounds(gid):
    g = gid[gid >= 0]
    return np.concatenate([[0], np.nonzero(np.diff(g))[0] + 1, [len(g)]])


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_grouped_functions_match_jax(weighted):
    gid, s, y, w = _grouped()
    keep = gid >= 0
    b, s, y, w = _bounds(gid), s[keep], y[keep], (w[keep] if weighted else None)
    for t, j in ((TS.grouped_auc(b, s, y, w), JS.grouped_auc(b, s, y, w)),
                 (TS.grouped_rmse(b, s, y, w), JS.grouped_rmse(b, s, y, w))):
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL, equal_nan=True)
    for k in (1, 3, 50):
        np.testing.assert_allclose(TS.grouped_precision_at_k(k, b, s, y, w),
                                   JS.grouped_precision_at_k(k, b, s, y, w), rtol=TOL)
    for name in ("logistic", "squared", "poisson", "smoothed_hinge"):
        np.testing.assert_allclose(TS.grouped_mean_loss(TL.BY_NAME[name], b, s, y, w),
                                   JS.grouped_mean_loss(JL.BY_NAME[name], b, s, y, w),
                                   rtol=TOL, atol=TOL)
    assert np.isnan(TS.grouped_auc(b, s, y, w)[[3, 4]]).all()


def test_empty_input_gives_nan_per_group():
    b = np.asarray([0])
    e = np.zeros(0)
    for fn in (TS.grouped_auc, JS.grouped_auc):
        assert fn(b, e, e, None).shape == (0,)
    assert TS.grouped_precision_at_k(2, b, e, e).shape == (0,)


@pytest.mark.parametrize("spec", ["AUC:g", "RMSE:g", "LOGISTIC_LOSS:g", "POISSON_LOSS:g",
                                  "SQUARED_LOSS:g", "SMOOTHED_HINGE_LOSS:g",
                                  "PRECISION@K:3:g", "PRECISION@K:10:g"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_multi_evaluator_matches_jax(spec, weighted):
    """parse_evaluator's grouped metrics go through the segment pass and
    equal the JAX package's MultiEvaluator; a NaN score lands in its
    group's value as it does there, and evaluate_grouped averages the
    finite groups alike."""
    gid, s, y, w = _grouped(seed=1)
    s = s.copy()
    s[17] = np.nan
    ev, group = TE.parse_evaluator(spec)
    jev, jgroup = JE.parse_evaluator(spec)
    assert (ev.name, group) == (jev.name, jgroup) and ev.segmented is not None
    wt = w if weighted else None
    got, want = ev.evaluate_grouped(gid, s, y, wt), jev.evaluate_grouped(gid, s, y, wt)
    assert got == pytest.approx(want, rel=TOL, abs=TOL, nan_ok=True)
    # the per-group oracle: the segment pass computes what the loop did
    loop = TE.MultiEvaluator(ev.name, ev.local, ev.larger_is_better)
    clean = np.where(np.isnan(s), 0.0, s)
    assert ev.evaluate_grouped(gid, clean, y, wt) == pytest.approx(
        loop.evaluate_grouped(gid, clean, y, wt), rel=1e-10, abs=1e-12)
