"""Port utils/faults.py and game/quarantine.py behave as the JAX package's.

The faults module is host-only in both packages, so both run in this
process on the same plans: hits and context matches, seeded probability,
the JSON and environment round-trips, the rejected sites, actions and
match keys (same messages), GracefulPreemption's flag and escalation, and
EXIT_PREEMPTED.  A plan serialized by either package installs in the
other.  The quarantine's guard, poison and monitor are checked on the
port's models, and a pipelined fit's host read-backs are counted with and
without the health flag: the flag adds none.  Fits run in float64 on the
CPU at tests/test_faults.py's GLMix shape."""
import json
import os
import signal

import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu_torch.data.game_data import build_game_dataset
from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig, quarantine
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import model_for_task
from photon_ml_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """No fault plan or preemption flag leaks between tests, in either
    package."""
    for mod in (faults, jfaults):
        mod.install_plan(None)
        mod.clear_preemption()
    yield
    for mod in (faults, jfaults):
        mod.install_plan(None)
        mod.clear_preemption()


def test_sites_and_constants_are_the_jax_packages():
    assert faults.SITES == jfaults.SITES
    assert faults.EXIT_PREEMPTED == jfaults.EXIT_PREEMPTED == 75
    assert faults._ACTIONS == jfaults._ACTIONS


def _fire_trace(mod, plan, calls):
    """The outcome of each call: the action returned, or the exception
    type's name."""
    out = []
    with mod.injected(plan):
        for site, ctx in calls:
            try:
                out.append(mod.fire(site, **ctx))
            except Exception as e:  # noqa: BLE001 - the outcome is the record
                out.append(type(e).__name__)
    return out


PLANS = {
    "hits_and_match": ({"faults": [{"site": "solve.poison", "action": "transient",
                                    "hits": [2], "match": {"coordinate": "a"}}]},
                       [("solve.poison", {"coordinate": c, "iteration": i})
                        for i, c in enumerate("babaa")]),
    "poison": ({"faults": [{"site": "solve.poison", "action": "poison", "hits": [1, 3]}]},
               [("solve.poison", {"coordinate": "x", "iteration": i}) for i in range(4)]),
    "fatal_and_transient": ({"seed": 3, "faults": [
        {"site": "model.save", "action": "fatal", "hits": [2]},
        {"site": "checkpoint.write", "action": "transient", "hits": [1]}]},
        [("model.save", {"directory": "d"}), ("checkpoint.write", {"iteration": 0}),
         ("model.save", {"directory": "d"}), ("checkpoint.write", {"iteration": 1})]),
    "probability": ({"seed": 7, "faults": [{"site": "stage.fetch", "probability": 0.5,
                                            "max_fires": 100}]},
                    [("stage.fetch", {"chunk": i}) for i in range(50)]),
    "probability_capped": ({"seed": 11, "faults": [{"site": "stage.fetch",
                                                    "probability": 0.7, "max_fires": 3}]},
                           [("stage.fetch", {"chunk": i}) for i in range(30)]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plans_fire_as_the_jax_packages(name):
    d, calls = PLANS[name]
    port, jax = faults.FaultPlan.from_dict(d), jfaults.FaultPlan.from_dict(d)
    assert _fire_trace(faults, port, calls) == _fire_trace(jfaults, jax, calls)
    assert port.report() == jax.report()
    assert port.to_dict() == jax.to_dict()
    if name == "hits_and_match":
        assert port.report()["sites"]["solve.poison"] == {"calls": 3, "fired": 1}
    if name == "probability":
        fired = port.report()["total_fired"]
        assert 0 < fired < len(calls)


def test_plan_json_round_trips_across_packages(monkeypatch, tmp_path):
    plan = jfaults.FaultPlan([{"site": "model.save", "action": "fatal", "hits": [1]},
                              {"site": "solve.poison", "action": "poison", "hits": [2],
                               "match": {"coordinate": "perUser"}}], seed=3)
    monkeypatch.setenv("PHOTON_FAULT_PLAN", json.dumps(plan.to_dict()))
    installed = faults.install_from_env()
    assert installed is not None and faults.active_plan() is installed
    assert installed.to_dict() == plan.to_dict()
    with pytest.raises(faults.FatalFault):
        faults.fire("model.save", directory="x")
    # @file form, written by the port, read by the JAX package
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(installed.to_dict()))
    monkeypatch.setenv("PHOTON_FAULT_PLAN", f"@{path}")
    assert jfaults.install_from_env().to_dict() == plan.to_dict()
    assert faults.install_from_env().to_dict() == plan.to_dict()
    monkeypatch.delenv("PHOTON_FAULT_PLAN")
    faults.install_plan(None)
    assert faults.install_from_env() is None and faults.active_plan() is None


def test_fire_without_a_plan_is_a_noop():
    assert faults.active_plan() is None
    assert faults.fire("stage.fetch", chunk=1) is None


BAD_PLANS = [
    [{"site": "stage.fetch", "action": "explode", "hits": [1]}],
    [{"site": "stage.fetch"}],
    [{"site": "stage.ftch", "hits": [1]}],
    [{"site": "nope", "hits": [1]}],
    [{"site": "stage.fetch", "hits": [1], "match": {"chunk_index": 3}}],
    [{"site": "stage.fetch", "hits": [1], "bogus_key": 1}],
]


@pytest.mark.parametrize("specs", BAD_PLANS, ids=[str(i) for i in range(len(BAD_PLANS))])
def test_bad_plans_are_rejected_as_the_jax_package_rejects_them(specs):
    with pytest.raises((ValueError, TypeError)) as t_err:
        faults.FaultPlan(specs)
    with pytest.raises((ValueError, TypeError)) as j_err:
        jfaults.FaultPlan(specs)
    assert type(t_err.value) is type(j_err.value)
    assert str(t_err.value) == str(j_err.value)


def test_match_key_missing_from_the_fire_context_is_an_error():
    for mod in (faults, jfaults):
        plan = mod.FaultPlan([{"site": "solve.poison", "hits": [1],
                               "match": {"coordinate": "a"}}])
        with mod.injected(plan):
            with pytest.raises(ValueError, match="did not pass"):
                mod.fire("solve.poison", iteration=0)


def test_transient_classification_matches_jax():
    for exc in (OSError("flaky"), TimeoutError(), ConnectionError(), ValueError("bug"),
                KeyboardInterrupt(), SystemExit(), MemoryError(),
                faults.TransientFault("x"), faults.FatalFault("x")):
        j_exc = {faults.TransientFault: jfaults.TransientFault,
                 faults.FatalFault: jfaults.FatalFault}.get(type(exc), type(exc))(*exc.args)
        assert faults.is_transient(exc) == jfaults.is_transient(j_exc)


def test_sigterm_sets_the_flag_then_escalates():
    before = signal.getsignal(signal.SIGTERM)
    with faults.GracefulPreemption():
        assert not faults.preemption_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert faults.preemption_requested()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert not faults.preemption_requested()  # cleared on exit
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored


def test_sigterm_action_requests_a_graceful_stop():
    plan = faults.FaultPlan([{"site": "checkpoint.write", "action": "sigterm", "hits": [1]}])
    with faults.GracefulPreemption(), faults.injected(plan):
        assert faults.fire("checkpoint.write", iteration=0) is None
        assert faults.preemption_requested()


def test_preempted_message_and_fields_match_jax():
    for args in ((2, True, "/ck"), (0, False, None)):
        t, j = faults.Preempted(*args), jfaults.Preempted(*args)
        assert str(t) == str(j)
        assert (t.completed_iterations, t.checkpointed, t.checkpoint_dir) == args


def _fixed(values):
    return FixedEffectModel(model_for_task("logistic_regression", Coefficients(
        torch.tensor(values, dtype=torch.float64))), "g")


def test_guard_rolls_back_nonfinite_coefficients():
    good, bad = _fixed([1.0, 2.0]), _fixed([float("nan"), 3.0])
    guarded, flag = quarantine.guard(bad, good)
    assert isinstance(flag, torch.Tensor) and flag.dtype == torch.bool and not bool(flag)
    assert guarded.glm.coefficients.means.tolist() == [1.0, 2.0]
    guarded2, flag2 = quarantine.guard(good, bad)
    assert bool(flag2) and guarded2.glm.coefficients.means.tolist() == [1.0, 2.0]
    assert not bool(quarantine.combine_health(flag2, torch.tensor(float("inf"))))
    assert bool(quarantine.combine_health(flag2, torch.tensor(3.0)))
    assert quarantine.guard(object(), object())[0] is not None


def test_poison_model_writes_nan_into_every_coefficient_array():
    re = RandomEffectModel("userId", "u", "logistic_regression",
                           torch.ones((3, 2), dtype=torch.float64),
                           np.asarray(["a", "b", "c"]), None, 2)
    for m in (_fixed([1.0, -2.0]), re):
        arrays = quarantine.coefficient_arrays(quarantine.poison_model(m))
        assert all(bool(torch.isnan(a).all()) for a in arrays)


def test_monitor_policy_two_strikes():
    mon = quarantine.QuarantineMonitor()
    assert mon.on_divergence(1, "perUser") == "retry"
    mon.on_retry_result(1, "perUser", True, 3.5)
    assert not mon.is_frozen("perUser")
    assert mon.on_divergence(3, "perUser") == "freeze"
    assert mon.frozen == ["perUser"]
    mon2 = quarantine.QuarantineMonitor()
    mon2.on_divergence(0, "fixed")
    mon2.on_retry_result(0, "fixed", False)
    assert mon2.frozen == ["fixed"]
    assert [e["action"] for e in mon.events] == ["rolled_back", "retry_ok", "rolled_back",
                                                 "frozen"]
    assert [e["coordinate"] for e in mon.events] == ["perUser"] * 4
    assert [e["iteration"] for e in mon.events] == [1, 1, 3, 3]


READBACKS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu", "numpy")


def _count_readbacks(monkeypatch, fn):
    """Calls of the tensor methods that read values back to the host,
    during fn()."""
    counts = {name: 0 for name in READBACKS}
    for name in READBACKS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            counts[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    try:
        fn()
    finally:
        monkeypatch.undo()
    return counts


@pytest.mark.parametrize("mode", ["pipelined", "strict"])
def test_health_flag_adds_no_readback_in_pipelined_mode(monkeypatch, mode):
    """A healthy fit's host read-backs, counted with the quarantine guard
    and with a guard that passes the solve through: equal in pipelined
    mode (the flag rides the one read-back per outer iteration); strict
    mode reads the flag back with each update's objective, by design."""
    train, val = side.containment_glmix(build_game_dataset)
    cfg = GameTrainingConfig.from_dict(side.containment_config_dict(3))
    fit = lambda: GameEstimator(cfg, device="cpu", dtype=torch.float64).fit(
        train, val, ["AUC"], timing_mode=mode)
    fit()  # warm: memoized blocks and device copies of the dataset
    with_guard = _count_readbacks(monkeypatch, fit)
    monkeypatch.setattr(quarantine, "guard", lambda new, prev: (new, None))
    monkeypatch.setattr(quarantine, "combine_health", lambda flag, obj: True)
    without_guard = _count_readbacks(monkeypatch, fit)
    extra = sum(with_guard.values()) - sum(without_guard.values())
    if mode == "pipelined":
        assert with_guard == without_guard
    else:
        assert extra == 3 * len(cfg.updating_sequence)  # one bool per update


@pytest.mark.parametrize("name", ["logistic", "squared", "poisson", "smoothed_hinge"])
def test_nan_coefficients_give_the_reference_value(name):
    """A poisoned model's data term: the kernel's plain version on a NaN
    coefficient is non-finite exactly where the JAX package's loss is, for
    the value and every gradient element (the smoothed hinge maps a NaN
    margin to 0 in both, so there the coefficient guard and the penalty
    carry the NaN; the card holds the kernel to the plain version)."""
    import jax.numpy as jnp
    from photon_ml_tpu.ops import losses as JL
    from photon_ml_tpu_torch.ops import hopper_kernels as hk
    from photon_ml_tpu_torch.ops import losses as TL
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 6))
    y = (rng.uniform(size=50) < 0.5).astype(np.float64)
    c = rng.normal(size=6) * 0.1
    c[2] = np.nan
    v, g = hk.fused_value_and_gradient_plain(TL.BY_NAME[name], torch.from_numpy(x),
                                             torch.from_numpy(y), torch.from_numpy(c))
    jl = JL.BY_NAME[name]
    z = jnp.asarray(x) @ jnp.asarray(c)
    j_v = float(jnp.sum(jl.loss(z, jnp.asarray(y))))
    j_g = np.asarray(jnp.asarray(x).T @ jl.dz(z, jnp.asarray(y)))
    assert bool(torch.isfinite(v)) == np.isfinite(j_v) == (name == "smoothed_hinge")
    np.testing.assert_array_equal(torch.isfinite(g).numpy(), np.isfinite(j_g))
    # the objective the descent evaluates carries the NaN through the
    # penalty term whatever the loss
    assert not np.isfinite(0.5 * np.sum(c * c))
