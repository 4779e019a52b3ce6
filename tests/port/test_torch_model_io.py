"""The cross-package gate of model persistence: a model directory in the
npz, avro or reference layout, written by either package, loads in the
other and scores the same, for every model kind the port has (a fixed
effect; random effects with an index projection and with a projection
matrix; a factored random effect; matrix factorization).

The port writes its directories first; the JAX side (game_jax_side.py
model_io, a subprocess of its own, f64 CPU) writes its directories, scores
its in-memory models and loads the port's.  Tolerance: scores within
1e-12 relative of the writer's in-memory scores (atol 1e-12 times the
largest |score|, since rows of unseen entities score exactly 0).  Then the
port's own layout behaviour, as tests/test_reference_layout.py holds the
JAX package's: the feature space survives zero coefficients, re-keying
into another feature space, the memoized reference maps, load_glm.
"""
import json
import os

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.data.index_map import build_index_map
from photon_ml_tpu_torch.game.config import GameTrainingConfig
from photon_ml_tpu_torch.models import game
from photon_ml_tpu_torch.models import io as pio
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import model_for_task

F64 = torch.float64
put = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
CASES = [(k, f) for k in side.MODEL_IO_KINDS for f in side.MODEL_IO_FORMATS]


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def arrays():
    return side.model_io_arrays()


@pytest.fixture(scope="module")
def dataset(arrays):
    return side.model_io_dataset(build_game_dataset, build_index_map, arrays)


@pytest.fixture(scope="module")
def models(arrays):
    return {k: side.model_io_model(k, arrays, put, game, model_for_task, Coefficients)
            for k in side.MODEL_IO_KINDS}


@pytest.fixture(scope="module")
def exchange(tmp_path_factory, models, dataset):
    """The port's directories, then the JAX side's run over them."""
    root = tmp_path_factory.mktemp("model_io")
    config = GameTrainingConfig.from_dict(side.glmix_config_dict())
    refused = set()
    for kind, fmt in CASES:
        try:
            pio.save_game_model(models[kind], str(root / "port_models" / kind / fmt),
                                config=config, index_maps=dataset.index_maps, format=fmt)
        except ValueError:
            refused.add((kind, fmt))
    results = side.run_jax_side("model_io", root / "jax.npz")
    return root, results, refused


def test_port_scores_equal_jax_in_memory(exchange, models, dataset):
    _, jax, _ = exchange
    for kind in side.MODEL_IO_KINDS:
        _close(models[kind].score_dataset(dataset), jax[f"scores/{kind}"])


@pytest.mark.parametrize("kind,fmt", CASES)
def test_jax_written_model_loads_in_port(exchange, dataset, kind, fmt):
    root, jax, _ = exchange
    d = root / "jax_models" / kind / fmt
    if f"refused/{kind}/{fmt}" in jax:
        assert (kind, fmt) == ("mf", "reference")
        return
    model, cfg = pio.load_game_model(str(d), device="cpu", dtype=F64)
    _close(model.score_dataset(dataset), jax[f"scores/{kind}"])
    if fmt != "reference":
        assert cfg.to_dict() == GameTrainingConfig.from_dict(side.glmix_config_dict()).to_dict()


@pytest.mark.parametrize("kind,fmt", CASES)
def test_port_written_model_loads_in_jax(exchange, models, dataset, kind, fmt):
    _, jax, refused = exchange
    if (kind, fmt) in refused:
        assert (kind, fmt) == ("mf", "reference")
        assert f"refused/{kind}/{fmt}" in jax
        return
    _close(jax[f"port_loaded/{kind}/{fmt}"],
           models[kind].score_dataset(dataset).numpy())
    if fmt != "reference":
        assert bool(jax[f"port_config/{kind}/{fmt}"])


def test_npz_layout_keeps_the_model_kinds(exchange, models):
    root, _, _ = exchange
    for kind in side.MODEL_IO_KINDS:
        loaded, _ = pio.load_game_model(str(root / "jax_models" / kind / "npz"),
                                        device="cpu", dtype=F64)
        assert [type(m).__name__ for m in loaded.coordinates.values()] == \
            [type(m).__name__ for m in models[kind].coordinates.values()]
    re, _ = pio.load_game_model(str(root / "jax_models" / "re" / "npz"), device="cpu",
                                dtype=F64)
    np.testing.assert_array_equal(re.coordinates["perUser"].projection,
                                  side.model_io_arrays()["re_projection"])


def test_loads_land_on_device_in_dtype(exchange):
    root, _, _ = exchange
    for fmt in side.MODEL_IO_FORMATS:
        m, _ = pio.load_game_model(str(root / "jax_models" / "re" / fmt), device="cpu")
        c = m.coordinates["perUser"].coefficients
        assert c.dtype == torch.float32 and c.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pio.load_game_model(str(root / "jax_models" / "fe" / "npz"))


def _fe_model(means):
    return game.GameModel({"fixed": game.FixedEffectModel(
        model_for_task("linear_regression", Coefficients(put(means))), "global")},
        "linear_regression")


def test_reference_layout_keeps_feature_space_with_zero_coefficients(tmp_path):
    """Avro records drop zero coefficients; with index maps given at save,
    the reload keeps the full feature space (as the JAX package's
    tests/test_reference_layout.py:170)."""
    imap = build_index_map([(f"g{i}", "") for i in range(4)])
    means = np.asarray([0.7, 0.0, -1.2, 0.0, 0.5])
    root = str(tmp_path / "refModel")
    pio.save_game_model_reference_layout(_fe_model(means), root,
                                         index_maps={"global": imap})
    assert pio.load_model_index_maps(root)["global"].size == imap.size
    loaded, _ = pio.load_game_model(root, device="cpu", dtype=F64)
    np.testing.assert_array_equal(
        loaded.coordinates["fixed"].glm.coefficients.means.numpy(), means)
    assert sorted(os.listdir(os.path.join(root, "fixed-effect", "fixed"))) == \
        ["coefficients", "id-info"]
    with open(os.path.join(root, "model-metadata.json")) as f:
        assert json.load(f)["modelType"] == "LINEAR_REGRESSION"


def test_warm_start_rekeys_different_feature_space(tmp_path):
    """A compact reference-layout model re-keys into the training data's
    feature space by (name, term) (as tests/test_reference_layout.py:270)."""
    m_map = build_index_map([("a", ""), ("c", "")])
    root = str(tmp_path / "m")
    pio.save_game_model_reference_layout(_fe_model([0.5, -1.0, 2.0]), root,
                                         index_maps={"global": m_map})
    loaded, _ = pio.load_game_model(root, device="cpu", dtype=F64)
    t_map = build_index_map([("a", ""), ("b", ""), ("c", "")])
    ds = build_game_dataset(np.zeros(4), {"global": np.zeros((4, t_map.size))},
                            index_maps={"global": t_map})
    aligned = pio.align_game_model_to_dataset(loaded, pio.load_model_index_maps(root), ds)
    got = aligned.coordinates["fixed"].glm.coefficients.means
    assert got.dtype == F64 and got.shape == (t_map.size,)
    assert float(got[t_map.index_of("a")]) == 0.5
    assert float(got[t_map.index_of("b")]) == 0.0
    assert float(got[t_map.index_of("c")]) == -1.0
    assert float(got[t_map.intercept_index]) == 2.0
    ds_nomaps = build_game_dataset(np.zeros(4), {"global": np.zeros((4, 7))})
    with pytest.raises(ValueError, match="re-key"):
        pio.align_game_model_to_dataset(loaded, None, ds_nomaps)


def test_reference_layout_without_maps_rebuilds_compact_space(tmp_path, models, dataset):
    """A directory the Scala reference wrote carries no maps: they are
    rebuilt from the records (memoized per on-disk state), partitioned
    random-effect files and the _SUCCESS marker included."""
    root = str(tmp_path / "ref")
    pio.save_game_model_reference_layout(models["re"], root, index_maps=dataset.index_maps,
                                         num_re_partitions=3)
    import shutil
    shutil.rmtree(os.path.join(root, "index-maps"))
    coeff_dir = os.path.join(root, "random-effect", "perUser", "coefficients")
    assert sorted(os.listdir(coeff_dir)) == ["_SUCCESS", "part-00000.avro",
                                             "part-00001.avro", "part-00002.avro"]
    maps = pio.load_model_index_maps(root)
    assert pio.load_model_index_maps(root) is maps            # memoized
    loaded, _ = pio.load_game_model(root, device="cpu", dtype=F64)
    aligned = pio.align_game_model_to_dataset(loaded, maps, dataset)
    _close(aligned.score_dataset(dataset), models["re"].score_dataset(dataset))


def test_save_and_load_glm(tmp_path):
    glm = model_for_task("poisson_regression",
                         Coefficients(put([0.1, -0.2, 0.3]), put([1.0, 2.0, 3.0])))
    imap = build_index_map([("a", ""), ("b", "")])
    pio.save_glm(glm, str(tmp_path / "g"), index_map=imap, extra_metadata={"lambda": 1.0})
    back, meta = pio.load_glm(str(tmp_path / "g"), device="cpu", dtype=F64)
    assert type(back).task_type == "poisson_regression" and meta["lambda"] == 1.0
    torch.testing.assert_close(back.coefficients.variances, glm.coefficients.variances,
                               rtol=0, atol=0)
    assert back.validate_coefficients()
    assert not back.with_coefficients(Coefficients(put([np.nan, 0, 0]))).validate_coefficients()


VALIDATOR_CASES = {
    "finite_ok": ("finite", [0.2, 0.9, 0.4], [0.0, 1.0, 0.0]),
    "not_finite": ("finite", [0.2, float("nan"), float("inf")], [0.0, 1.0, 0.0]),
    "negative": ("nonneg", [0.2, -0.1, -3.0], [0.0, 1.0, 0.0]),
    "max_diff": ("maxdiff", [0.2, 0.9, 0.4], [1.0, 1.0, 0.0]),
    "auc_low": ("auc", [0.9, 0.1, 0.8, 0.2], [0.0, 1.0, 0.0, 1.0]),
    "auc_ok": ("auc", [0.1, 0.9, 0.2, 0.8], [0.0, 1.0, 0.0, 1.0]),
    "binary": ("binary", [0.1, 0.9, 0.5], [0.0, 1.0, 0.0]),
    "composite": ("composite", [0.1, -0.9, 0.5], [0.0, 1.0, 0.0]),
    "composite_no_labels": ("composite", [0.1, 0.9, 0.5], None),
}


@pytest.mark.parametrize("case", list(VALIDATOR_CASES))
def test_model_validators_match_jax(case):
    """The five validators and the composite give the JAX package's
    verdicts and messages on the same predictions; the port also computes
    them itself from a model and its features."""
    import jax.numpy as jnp
    from photon_ml_tpu.models import validators as jv
    from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
    from photon_ml_tpu.models.glm import model_for_task as j_model_for_task
    from photon_ml_tpu_torch.models import validators as pv
    kind, preds, labels = VALIDATOR_CASES[case]

    def make(v):
        return {"finite": lambda: [v.PredictionFiniteValidator()],
                "nonneg": lambda: [v.NonNegativePredictionValidator()],
                "maxdiff": lambda: [v.MaximumDifferenceValidator(0.5)],
                "auc": lambda: [v.BinaryClassifierAUCValidator(0.75)],
                "binary": lambda: [v.BinaryPredictionValidator()],
                "composite": lambda: [v.CompositeModelValidator(
                    v.PredictionFiniteValidator(), v.NonNegativePredictionValidator(),
                    v.MaximumDifferenceValidator(2.0))]}[kind]()

    p_model = model_for_task("logistic_regression", Coefficients(put([1.0, -0.5])))
    j_model = j_model_for_task("logistic_regression", JCoefficients(jnp.asarray([1.0, -0.5])))
    outcomes = []
    for v, model, wrap in ((pv, p_model, put), (jv, j_model, np.asarray)):
        try:
            for val in make(v):
                val.validate(model, None, None if labels is None else wrap(labels),
                             predictions=wrap(preds))
            outcomes.append(None)
        except ValueError as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    # the port's own prediction pass: predict(x) = sigmoid(x . c)
    x = put([[0.0, 1.0], [2.0, 0.0], [1.0, 1.0]])
    pv.CompositeModelValidator(pv.PredictionFiniteValidator(),
                               pv.BinaryPredictionValidator()).validate(p_model, x)
    with pytest.raises(pv.ModelValidationError, match="require labels"):
        pv.CompositeModelValidator(pv.BinaryClassifierAUCValidator(0.6)).validate(p_model, x)
