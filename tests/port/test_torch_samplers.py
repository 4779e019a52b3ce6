"""data/samplers.py == the JAX package's, and a GAME fit whose fixed effect
is down-sampled == the JAX package's fit, on the CPU in float64.

The draws: masks and weights bit-equal for both samplers, both dtypes,
with and without weights, for two keys.  The fits: config 4's coordinates
(game_jax_side.py samplers_config_dict) with the fixed effect down-sampled
at 0.5, for logistic (the binary sampler) and poisson (the default
sampler) tasks; every update draws from the next split of PRNGKey(seed).
Tolerances: objective histories rtol 1e-9, validation AUC 1e-9 absolute,
final coefficients and validation scores atol 1e-7, equal iteration
counts per solve."""
import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data import samplers
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.data.synthetic_bench import make_movielens_like, movielens_shards
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
from photon_ml_tpu_torch.utils import prng


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return side.run_jax_side("samplers", tmp_path_factory.mktemp("jax") / "samplers.npz")


@pytest.fixture(scope="module")
def data():
    return side.movielens_glmix(build_game_dataset, make_movielens_like, movielens_shards)


@pytest.fixture(scope="module")
def fits(data):
    train, val = data
    return {task: GameEstimator(GameTrainingConfig.from_dict(side.samplers_config_dict(task)),
                                device="cpu", dtype=torch.float64).fit(train, val, ["AUC"])
            for task in side.SAMPLER_TASKS}


@pytest.mark.parametrize("name", ["binary_classification_downsample", "default_downsample"])
def test_draws_are_bit_equal(jax_results, name):
    rng = np.random.default_rng(8)
    labels = (rng.uniform(size=997) < 0.3).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=997)
    for seed in (0, 7):
        for w in (None, weights):
            for dt in (torch.float32, torch.float64):
                m, ww = getattr(samplers, name)(
                    prng.PRNGKey(seed), torch.as_tensor(labels, dtype=dt),
                    None if w is None else torch.as_tensor(w, dtype=dt), 0.35)
                tag = f"draw/{seed}/{name}/{w is None}/{str(dt)[6:]}"
                assert m.dtype == ww.dtype == dt
                np.testing.assert_array_equal(m.numpy(), jax_results[f"{tag}/mask"])
                np.testing.assert_array_equal(ww.numpy(), jax_results[f"{tag}/weights"])
                assert 0 < m.sum() < len(labels)


def test_binary_sampler_keeps_every_positive():
    labels = torch.tensor([1.0, 0.0] * 500, dtype=torch.float64)
    m, w = samplers.binary_classification_downsample(prng.PRNGKey(1), labels, None, 0.2)
    assert bool((m[labels > 0.5] == 1).all())
    assert torch.equal(w, torch.where(labels > 0.5, 1.0, 5.0).to(torch.float64))
    assert 0.1 < float(m[labels < 0.5].mean()) < 0.3


def test_rates_outside_the_open_unit_interval_raise():
    labels = torch.zeros(4, dtype=torch.float64)
    for rate in (0.0, 1.0, 1.5):
        for fn in (samplers.binary_classification_downsample, samplers.default_downsample):
            with pytest.raises(ValueError, match="rate"):
                fn(prng.PRNGKey(0), labels, None, rate)
    assert samplers.downsampler_for_task("logistic_regression") \
        is samplers.binary_classification_downsample
    assert samplers.downsampler_for_task("smoothed_hinge_loss_linear_svm") \
        is samplers.binary_classification_downsample
    assert samplers.downsampler_for_task("linear_regression") is samplers.default_downsample


@pytest.mark.parametrize("task", side.SAMPLER_TASKS)
def test_downsampled_fit_matches_jax(jax_results, fits, data, task):
    fit = fits[task]
    j = lambda k: jax_results[f"{task}/{k}"]
    np.testing.assert_allclose(fit.objective_history, j("objective_history"), rtol=1e-9)
    np.testing.assert_allclose(fit.descent.validation_history["AUC"], j("auc_history"),
                               rtol=0, atol=1e-9)
    m = fit.descent.model.coordinates
    np.testing.assert_allclose(m["fixed"].glm.coefficients.means.numpy(), j("fixed/means"),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(m["perUser"].coefficients.numpy(), j("perUser/coefficients"),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(fit.descent.model.score_dataset(data[1]).numpy(),
                               j("val_scores"), rtol=0, atol=1e-7)
    for key, t in fit.descent.trackers.items():
        assert t.iterations == int(j(f"iterations/{key}")), key


def test_each_update_draws_anew(data):
    """Two fixed-effect updates of one coordinate at the same offsets take
    different samples (the key walks one split per update), and a fresh
    coordinate repeats the first."""
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    train, _ = data
    cfg = GameTrainingConfig.from_dict(side.samplers_config_dict("logistic_regression"))
    make = lambda: FixedEffectCoordinate("fixed", train, cfg.coordinates["fixed"],
                                         "logistic_regression", device="cpu",
                                         dtype=torch.float64, seed=11)
    zero = torch.zeros(train.num_rows, dtype=torch.float64)
    coord = make()
    a, _ = coord.update(coord.initial_model(), zero)
    b, _ = coord.update(coord.initial_model(), zero)
    c, _ = make().update(coord.initial_model(), zero)
    means = lambda m: m.glm.coefficients.means
    assert not torch.equal(means(a), means(b))
    assert torch.equal(means(a), means(c))
