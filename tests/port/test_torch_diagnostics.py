"""The port's diagnostics == the JAX package's, in float64 on the CPU.

- the host metrics, Hosmer-Lemeshow, Kendall tau, feature importance and
  evaluate_glm against the JAX package's in this process (numpy, ≤ 1e-12);
  the rendered markdown and HTML of equal reports byte-equal;
- the lanes kernel's plain version with a lane mask against K plain single
  passes with weights w * member_k (≤ 1e-12) and jax.vmap of the JAX
  GLMObjective over those weight rows; FixedEffectLanes with lane_keep on
  its plain, single and sparse routes against the same vmapped objective
  (values and gradients rtol 1e-12, Hv 1e-10);
- bootstrap_training (logistic, linear, Poisson, smoothed hinge under L2,
  elastic net, TRON and a box, with weights, offsets and warm starts),
  fitting_diagnostic and the argument errors against the JAX package's,
  whose side runs once in a subprocess (diagnostics_jax_side.py): every
  summary within 1e-8 (the solves converge to 1e-11, far below it), the
  significance masks equal;
- cli.diagnose against the JAX CLI on the same model directories (an npz
  GLM, an npz GAME model, an Avro input without and with the bootstrap
  and learning curves, the JAX side's fits widened to float64 for the
  latter), --device cpu --x64: report.json
  within 1e-8, report.md and report.html byte-equal, the stdout summaries
  equal up to 1e-12 in their numbers.
"""
import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diagnostics_jax_side as side
from photon_ml_tpu.diagnostics import bootstrap as jboot
from photon_ml_tpu.diagnostics import fitting as jfit
from photon_ml_tpu.diagnostics import hl as jhl
from photon_ml_tpu.diagnostics import importance as jimp
from photon_ml_tpu.diagnostics import independence as jind
from photon_ml_tpu.diagnostics import metrics as jmet
from photon_ml_tpu.diagnostics import report as jrep
from photon_ml_tpu_torch.diagnostics import bootstrap as tboot
from photon_ml_tpu_torch.diagnostics import fitting as tfit
from photon_ml_tpu_torch.diagnostics import hl as thl
from photon_ml_tpu_torch.diagnostics import importance as timp
from photon_ml_tpu_torch.diagnostics import independence as tind
from photon_ml_tpu_torch.diagnostics import metrics as tmet
from photon_ml_tpu_torch.diagnostics import report as trep
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops.lanes import FixedEffectLanes, lane_words, launch_groups
from photon_ml_tpu_torch.optim import (OptimizerConfig, OptimizerType, RegularizationContext,
                                       RegularizationType)

TASKS = ("logistic_regression", "linear_regression", "poisson_regression",
         "smoothed_hinge_loss_linear_svm")
TIGHT = 1e-12


def _close(got, want, rtol, path=""):
    """Equal structure; numbers within rtol (NaN where NaN), the rest equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (float, int)) and not isinstance(want, bool):
        if isinstance(want, float) and math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=rtol, abs=rtol), path
    else:
        assert got == want, path


def _scores(task, rng, n=500):
    margins = rng.normal(size=n)
    labels = {"linear_regression": margins + rng.normal(size=n),
              "poisson_regression": rng.poisson(np.exp(0.3 * margins)).astype(float)}.get(
        task, (rng.uniform(size=n) < 0.5).astype(float))
    preds = np.asarray(TL.TASK_LOSSES[task].mean(torch.from_numpy(margins)))
    return preds, margins, labels


# -- host modules --------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_metrics_match_jax(task):
    rng = np.random.default_rng(1)
    preds, margins, labels = _scores(task, rng)
    preds[:40] = preds[40:80]                      # ties in the binary sweep
    coefs = rng.normal(size=7)
    coefs[2] = 0.0
    _close(tmet.evaluate_scores(task, preds, margins, labels, coefs),
           jmet.evaluate_scores(task, preds, margins, labels, coefs), TIGHT)
    one_class = np.ones_like(labels)               # undefined binary metrics: NaN
    _close(tmet.evaluate_scores(task, preds, margins, one_class),
           jmet.evaluate_scores(task, preds, margins, one_class), TIGHT)


def test_evaluate_glm_matches_jax():
    from photon_ml_tpu.models.coefficients import Coefficients as JC
    from photon_ml_tpu.models.glm import model_for_task as jmodel
    from photon_ml_tpu_torch.models.coefficients import Coefficients as TC
    from photon_ml_tpu_torch.models.glm import model_for_task as tmodel
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 5))
    x[:, -1] = 1.0
    w = rng.normal(size=5)
    y = (rng.uniform(size=300) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    off = rng.normal(size=300) * 0.1
    for task in ("logistic_regression", "poisson_regression"):
        got = tmet.evaluate_glm(tmodel(task, TC(torch.from_numpy(w))), x, y, off)
        want = jmet.evaluate_glm(jmodel(task, JC(jnp.asarray(w))), x, y, off)
        _close(got, want, TIGHT)


def test_hosmer_lemeshow_matches_jax():
    rng = np.random.default_rng(3)
    for n, dims in ((4000, 8), (40, 1), (1, 3)):     # the floor of 3 bins bites below
        p = rng.uniform(0.01, 0.99, size=n)
        y = (rng.uniform(size=n) < p ** 2).astype(float)
        got, want = thl.hosmer_lemeshow(p, y, dims), jhl.hosmer_lemeshow(p, y, dims)
        _close(got.to_dict(), want.to_dict(), TIGHT)


def test_kendall_tau_matches_jax():
    """The subsample draws the same rows (default_rng(seed).choice), ties
    are counted alike, and the paired-length check raises alike."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=5000)
    b = np.round(a + rng.normal(size=5000), 1)     # ties in b
    for args in ((a, b), (a[:150], b[:150]), (a, b, 700, 3)):
        _close(tind.kendall_tau_analysis(*args).to_dict(),
               jind.kendall_tau_analysis(*args).to_dict(), TIGHT)
    for mod in (tind, jind):
        with pytest.raises(ValueError, match="equal length"):
            mod.kendall_tau_analysis(a, b[:10])


def test_feature_importance_matches_jax():
    from photon_ml_tpu.data.stats import BasicStatisticalSummary as JS
    from photon_ml_tpu_torch.data.stats import BasicStatisticalSummary as TS
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 4)) * np.asarray([1.0, 10.0, 0.1, 3.0])
    w = rng.uniform(0.5, 2.0, size=200)
    c = rng.normal(size=4)
    for kind in ("expected_magnitude", "variance"):
        got = timp.feature_importance(c, TS.from_features(x, w), list("abcd"), kind)
        want = jimp.feature_importance(c, JS.from_features(x, w), list("abcd"), kind)
        _close(got.to_dict(), want.to_dict(), TIGHT)
    _close(timp.feature_importance(c).to_dict(), jimp.feature_importance(c).to_dict(), 0)
    for mod in (timp, jimp):
        with pytest.raises(ValueError, match="unknown importance type"):
            mod.feature_importance(c, None, None, "gain")


def _report(pkg):
    """One full report built from the same values with a package's classes."""
    boot, fit, hl, imp, ind, rep = pkg
    summaries = [boot.CoefficientSummary(-1.0 + j, -0.5, 0.25 * j, 0.5, 1.0, 0.1, 0.2)
                 for j in range(3)]
    return rep.DiagnosticReport(
        task_type="logistic_regression",
        metrics={"Area under ROC": 0.8123456789, "Peak F1 score": 0.61,
                 "Per-datum log likelihood": -0.5123},
        feature_importance=imp.FeatureImportanceReport(
            "expected_magnitude", [("a<b>", 0, 2.5), ("c&d", 1, 1e-7)]),
        hosmer_lemeshow=hl.hosmer_lemeshow(np.linspace(0.01, 0.99, 500),
                                           (np.arange(500) % 3 == 0).astype(float), 4),
        independence=ind.kendall_tau_analysis(np.arange(300.0), np.arange(300.0) % 7),
        bootstrap=boot.BootstrapReport(3, summaries, {"Area under ROC": summaries[0]},
                                       np.asarray([True, False, True])),
        fitting=fit.FittingReport({"Area under ROC": {"portions": [11.1, 22.2, 33.33],
                                                      "train": [0.9, 0.85, float("nan")],
                                                      "test": [0.7, 0.75, 0.8]}}))


def test_rendered_reports_are_byte_equal():
    got = _report((tboot, tfit, thl, timp, tind, trep))
    want = _report((jboot, jfit, jhl, jimp, jind, jrep))
    assert trep.render_markdown(got) == jrep.render_markdown(want)
    assert trep.render_html(got) == jrep.render_html(want)
    assert got.to_json() == want.to_json()
    empty = trep.DiagnosticReport("linear_regression", {})
    assert trep.render_html(empty) == jrep.render_html(jrep.DiagnosticReport(
        "linear_regression", {}))


# -- the lane mask ---------------------------------------------------------------

N, D, K = 333, 7, 5


def _lane_problem(seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    x[:, -1] = 1.0
    y = (rng.uniform(size=N) > 0.5).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=N)
    o = rng.normal(size=(K, N)) * 0.2
    c = rng.normal(size=(K, D)) * 0.3
    v = rng.normal(size=(K, D))
    member = rng.uniform(size=(K, N)) < 0.7
    member[1] = False                              # a lane that keeps no row
    member[2] = True                               # a lane that keeps every row
    return x, y, w, o, c, v, member


@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_plain_lanes_pass_with_lane_mask(name):
    """Bit k of the word is a 0/1 factor on lane k's weights: the masked
    plain pass == K plain single passes with weights w * member_k, and ==
    jax.vmap of the JAX GLMObjective over those weight rows; with the row
    mask and a shift on top, == the single passes with both."""
    from photon_ml_tpu.ops import losses as JL
    from photon_ml_tpu.ops.objective import GLMObjective as JObjective
    x, y, w, o, c, _, member = _lane_problem()
    t = torch.from_numpy
    loss = TL.BY_NAME[name]
    word = lane_words(t(member))
    assert word.dtype == torch.int32
    for weights in (None, t(w)):
        v, g, s = hk.fused_value_and_gradient_lanes_plain(
            loss, t(x), t(y), t(c), weights, t(o), lane_mask=word)
        for k in range(K):
            wk = t(member[k] * (1.0 if weights is None else w))
            vk, gk = hk.fused_value_and_gradient_plain(loss, t(x), t(y), t(c[k]), wk, t(o[k]))
            np.testing.assert_allclose(v[k].item(), vk.item(), rtol=TIGHT, atol=TIGHT)
            np.testing.assert_allclose(g[k].numpy(), gk.numpy(), rtol=TIGHT, atol=TIGHT)
    jv, jg = jax.vmap(lambda wk, ck, ok: JObjective(
        JL.BY_NAME[name], jnp.asarray(x), jnp.asarray(y), weights=wk,
        offsets=ok).value_and_gradient(ck))(jnp.asarray(member * w), jnp.asarray(c),
                                            jnp.asarray(o))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TIGHT, atol=TIGHT)
    # the row mask stays a select on top of the bits, the shift a margin term
    m = (np.arange(N) % 4 != 0).astype(np.float64)
    b = np.linspace(-0.1, 0.1, K)
    v, g, s = hk.fused_value_and_gradient_lanes_plain(
        loss, t(x), t(y), t(c), t(w), t(o), t(m), t(b), word)
    for k in range(K):
        vk, gk = hk.fused_value_and_gradient_plain(loss, t(x), t(y), t(c[k]),
                                                   t(member[k] * w), t(o[k] + b[k]), t(m))
        np.testing.assert_allclose(v[k].item(), vk.item(), rtol=TIGHT, atol=TIGHT)
        np.testing.assert_allclose(g[k].numpy(), gk.numpy(), rtol=TIGHT, atol=TIGHT)


def test_dropped_row_with_a_non_finite_loss_poisons_its_lane_only():
    """As JAX's member * w: 0 * inf = NaN in the lanes that drop the row;
    the lanes that keep it see the infinite loss; a row-masked row adds
    nothing anywhere."""
    x, y, w, o, c, _, member = _lane_problem()
    t = torch.from_numpy
    o = o.copy()
    o[:, 5] = 1e6                                  # exp overflows: Poisson loss inf
    member[:, 5] = [True, False, True, False, True]
    v, _, _ = hk.fused_value_and_gradient_lanes_plain(
        TL.POISSON, t(x), t(y), t(c), t(w), t(o), lane_mask=lane_words(t(member)))
    assert [math.isnan(a) for a in v.tolist()] == [False, True, False, True, False]
    assert [math.isinf(a) for a in v.tolist()] == [True, False, True, False, True]
    m = np.ones(N)
    m[5] = 0.0
    v, _, _ = hk.fused_value_and_gradient_lanes_plain(
        TL.POISSON, t(x), t(y), t(c), t(w), t(o), t(m), lane_mask=lane_words(t(member)))
    assert torch.isfinite(v).all()


def test_lane_words_and_groups():
    rng = np.random.default_rng(7)
    keep = torch.from_numpy(rng.uniform(size=(32, 50)) < 0.5)
    word = lane_words(keep)
    bits = (word[None, :] >> torch.arange(32, dtype=torch.int32)[:, None]) & 1
    assert torch.equal(bits.bool(), keep)
    with pytest.raises(ValueError, match="32 lanes"):
        lane_words(torch.ones((33, 4), dtype=torch.bool))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert launch_groups(40, 31, cpu, masked=True) == [(0, 32), (32, 40)]
    assert launch_groups(40, 31, cuda, masked=True) == [(0, 16), (16, 32), (32, 40)]
    assert launch_groups(3, 4096, cuda, masked=True) == [(0, 1), (1, 2), (2, 3)]
    # the words' span costs no lanes at any width
    assert all(hk.max_lanes(d, masked=True) == hk.max_lanes(d) for d in range(1, 2050))
    x = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="32 lanes"):
        hk.fused_value_and_gradient_lanes_plain(TL.LOGISTIC, x, torch.zeros(4),
                                                torch.zeros((33, 3), dtype=torch.float64),
                                                lane_mask=torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("d", [1, 9, 31, 124, 513, 2048])
def test_masked_lanes_plan_replays(d):
    """A masked plan's stage holds one more per-row span (the words), after
    O's K runs; it fits shared memory; the unmasked plan is unchanged."""
    for lanes in sorted({1, 5, hk.max_lanes(d, masked=True)}):
        plan = hk.plan_lanes(950_051, d, lanes, 132, masked=True)
        lay = plan.layout
        assert lay == hk.lanes_smem_layout(d, lanes, plan.rows_per_tile, plan.stages, True)
        assert lay.stage == lay.stage_x + (4 + lanes) * lay.stage_v
        assert lay.bytes <= hk.MAX_SMEM and plan.stages >= 2
        plain = hk.plan_lanes(950_051, d, lanes, 132)
        assert plain.layout.stage == plain.layout.stage_x + (3 + lanes) * plain.layout.stage_v


def _jax_lanes(name, x, y, w, o, c, v, member, l2):
    from photon_ml_tpu.ops import losses as JL
    from photon_ml_tpu.ops.objective import GLMObjective as JObjective

    def one(wk, ck, ok, lk, vk):
        obj = JObjective(JL.BY_NAME[name], jnp.asarray(x), jnp.asarray(y), weights=wk,
                         offsets=ok).with_l2(lk)
        val, grad = obj.value_and_gradient(ck)
        return val, grad, obj.hessian_vector(ck, vk)

    return jax.jit(jax.vmap(one))(jnp.asarray(member * w), jnp.asarray(c), jnp.asarray(o),
                                  jnp.asarray(l2), jnp.asarray(v))


@pytest.mark.parametrize("route", ["plain", "single", "sparse"])
@pytest.mark.parametrize("name", ["logistic", "poisson"])
def test_fixed_effect_lanes_with_lane_keep_match_vmapped_jax(name, route, monkeypatch):
    """FixedEffectLanes with lane_keep on each route the CPU runs (the
    single route forced at a small width, as on the card past d = 2,048;
    a PaddedSparse X) == jax.vmap of the JAX objective over the weight
    rows member_k * w: values, gradients and Hessian-vector products."""
    from photon_ml_tpu_torch.ops import lanes as lanes_mod
    if route == "single":
        monkeypatch.setattr(lanes_mod, "lanes_route", lambda d, device, xbytes=4: "single")
    x, y, w, o, c, v, member = _lane_problem()
    l2 = np.linspace(0.0, 2.0, K)
    jv, jg, jh = _jax_lanes(name, x, y, w, o, c, v, member, l2)
    t = torch.from_numpy
    xs = fops.PaddedSparse.from_dense(x, device="cpu") if route == "sparse" else t(x)
    lanes = FixedEffectLanes(TL.BY_NAME[name], xs, t(y), t(o), t(l2), weights=t(w),
                             lane_keep=t(member))
    assert lanes.route == route
    tv, tg = lanes.value_and_gradient(t(c))
    th = lanes.hessian_vector_at(t(c))(t(v))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-10, atol=1e-10)


def test_fixed_effect_lanes_without_offsets():
    """Offsets None (a bootstrap without offsets): the lanes see zero offsets."""
    x, y, w, o, c, v, member = _lane_problem()
    t = torch.from_numpy
    l2 = t(np.full(K, 0.5))
    none = FixedEffectLanes(TL.LOGISTIC, t(x), t(y), None, l2, weights=t(w),
                            lane_keep=t(member))
    zero = FixedEffectLanes(TL.LOGISTIC, t(x), t(y), t(np.zeros((K, N))), l2,
                            weights=t(w), lane_keep=t(member))
    for a, b in zip(none.value_and_gradient(t(c)), zero.value_and_gradient(t(c))):
        assert torch.equal(a, b)
    assert torch.equal(none.hessian_vector_at(t(c))(t(v)), zero.hessian_vector_at(t(c))(t(v)))


# -- bootstrap, fitting and the CLI against the JAX side ---------------------------

def _glm_data(rng, n=900, d=5):
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    return x, y


def _write_cli_cases(root):
    """An npz GLM (weights, offsets), an npz GAME model (fixed effect +
    per-user random effect) and an Avro input of an index-mapped GLM,
    trained by the port; -> {run: the argv both CLIs take}."""
    from photon_ml_tpu_torch.data.avro_game import write_game_examples
    from photon_ml_tpu_torch.data.game_data import build_game_dataset, save_game_dataset
    from photon_ml_tpu_torch.data.index_map import build_index_map
    from photon_ml_tpu_torch.game import (FixedEffectCoordinateConfig, GameEstimator,
                                          GameTrainingConfig, GLMOptimizationConfig,
                                          RandomEffectCoordinateConfig)
    from photon_ml_tpu_torch.models.io import save_game_model
    rng = np.random.default_rng(8)
    opt = GLMOptimizationConfig(regularization=RegularizationContext(RegularizationType.L2),
                                regularization_weight=0.01)

    def fit_and_save(name, ds, coords, seq, **save):
        cfg = GameTrainingConfig("logistic_regression", coords, seq)
        res = GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(ds)
        save_game_model(res.model, str(root / name / "model"), config=cfg, **save)
        return str(root / name / "model")

    runs = {}
    x, y = _glm_data(rng)
    ds = build_game_dataset(y, {"global": x}, weights=rng.uniform(0.5, 2.0, size=len(y)),
                            offsets=rng.normal(size=len(y)) * 0.1)
    model = fit_and_save("glm_npz", ds, {"fixed": FixedEffectCoordinateConfig("global", opt)},
                         ["fixed"])
    save_game_dataset(ds, str(root / "glm_npz" / "data.npz"))
    runs["glm_npz"] = ["--model-dir", model, "--data", str(root / "glm_npz" / "data.npz"),
                       "--bootstrap-samples", "4"]

    x, y = _glm_data(rng, n=800)
    users = rng.integers(0, 20, size=len(y))
    ds = build_game_dataset(y, {"global": x, "per_user": rng.normal(size=(len(y), 3))},
                            entity_ids={"userId": users})
    model = fit_and_save("game_npz", ds, {
        "fixed": FixedEffectCoordinateConfig("global", opt),
        "perUser": RandomEffectCoordinateConfig("userId", "per_user", opt)},
        ["fixed", "perUser"])
    save_game_dataset(ds, str(root / "game_npz" / "data.npz"))
    runs["game_npz"] = ["--model-dir", model, "--data", str(root / "game_npz" / "data.npz"),
                        "--bootstrap-samples", "3", "--skip-fitting"]

    imap = build_index_map([(f"f{i}", "") for i in range(4)])
    x = np.zeros((400, imap.size))
    # values exact in float32 (the Avro read) and float64
    x[:, :-1] = rng.normal(size=(400, 4)).astype(np.float32).astype(np.float64)
    x[:, -1] = 1.0
    y = (rng.uniform(size=400) < 1 / (1 + np.exp(-(x @ rng.normal(size=imap.size))))) * 1.0
    ds = build_game_dataset(y, {"global": x}, index_maps={"global": imap})
    model = fit_and_save("glm_avro", ds, {"fixed": FixedEffectCoordinateConfig("global", opt)},
                         ["fixed"], index_maps=ds.index_maps)
    write_game_examples(str(root / "glm_avro" / "data.avro"), y, bags={"features": (x, imap)})
    runs["glm_avro"] = ["--model-dir", model, "--data", str(root / "glm_avro" / "data.avro"),
                        "--skip-bootstrap", "--skip-fitting"]
    # bootstrap and learning curves on Avro input: the JAX side widens the
    # float32 shard it fits them on to float64 (diagnostics_jax_side
    # .WIDENED_RUNS), the precision the port computes them in under --x64
    runs["glm_avro_full"] = ["--model-dir", model,
                             "--data", str(root / "glm_avro" / "data.avro"),
                             "--bootstrap-samples", "4"]
    return runs


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("diagnostics")
    runs = _write_cli_cases(root)
    (root / "cli_runs.json").write_text(json.dumps(runs))
    return root, runs, side.run_jax_side(root)


def _classes():
    return OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType


@pytest.mark.parametrize("case", list(side.BOOT_CASES))
def test_bootstrap_matches_jax(jax_side, case):
    task = side.BOOT_CASES[case][0]
    p = side.bootstrap_problem(task)
    rep = tboot.bootstrap_training(p["x"], p["labels"], task, device="cpu",
                                   **side.bootstrap_kwargs(case, *_classes()))
    want = jax_side[2]["bootstrap"][case]
    assert rep.significant_mask.tolist() == want.pop("significant_mask")
    _close(rep.to_dict(), want, 1e-8)
    # the replicas are the lanes of one batched solve, one group on the CPU
    assert rep.solve["route"] == "plain" and rep.solve["lane_groups"] == 1
    assert rep.coefficients.shape == (side.BOOT_CASES[case][8], side.BOOT_D)


def test_bootstrap_argument_errors_match_jax(jax_side):
    p = side.bootstrap_problem("linear_regression", n=20, d=2)
    for name, kw in (("one_sample", {"num_bootstrap_samples": 1}),
                     ("portion", {"training_portion": 1.5})):
        with pytest.raises(ValueError) as e:
            tboot.bootstrap_training(p["x"], p["labels"], "linear_regression",
                                     device="cpu", **kw)
        assert str(e.value) == jax_side[2]["errors"][name]


@pytest.mark.parametrize("case", list(side.FIT_CASES))
def test_fitting_matches_jax(jax_side, case):
    task = side.FIT_CASES[case][0]
    p = side.bootstrap_problem(task, seed=4)
    rep = tfit.fitting_diagnostic(p["x"], p["labels"], task, device="cpu",
                                  **side.fitting_kwargs(case, *_classes()))
    _close(rep.to_dict(), jax_side[2]["fitting"][case], 1e-8)
    assert len(rep.solves) == tfit.NUM_TRAINING_PARTITIONS - 1


def test_fitting_refuses_too_little_data():
    rng = np.random.default_rng(9)
    x, y = rng.normal(size=(30, 5)), rng.normal(size=30)
    got = tfit.fitting_diagnostic(x, y, "linear_regression", device="cpu")
    want = jfit.fitting_diagnostic(x, y, "linear_regression")
    assert got.to_dict() == want.to_dict() and got.metrics == {}


@pytest.mark.parametrize("run", ["glm_npz", "game_npz", "glm_avro", "glm_avro_full"])
def test_cli_diagnose_matches_jax(jax_side, run):
    from photon_ml_tpu_torch.cli import diagnose
    root, runs, jax_results = jax_side
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = diagnose.main(runs[run] + ["--output-dir", str(root / "port" / run),
                                        "--device", "cpu", "--x64"])
    want = jax_results["cli"][run]
    assert rc == want["rc"] == 0
    got_line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_line = json.loads(want["stdout"])
    got_line["output"] = want_line["output"] = None
    _close(got_line, want_line, TIGHT)
    got = json.loads((root / "port" / run / "report.json").read_text())
    _close(got, json.loads((root / "jax" / run / "report.json").read_text()), 1e-8)
    for name in ("report.md", "report.html"):   # printed to 4-6 digits: equal
        assert (root / "port" / run / name).read_bytes() == \
            (root / "jax" / run / name).read_bytes()
    assert set(diagnose.LAST_RUN["walls_s"]) >= {"load", "score", "render"}
    if run in ("glm_npz", "glm_avro_full"):
        assert set(got) >= {"hosmer_lemeshow", "bootstrap", "fitting", "independence"}
