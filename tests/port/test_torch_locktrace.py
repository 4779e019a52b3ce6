"""The port's utils/locktrace.py == the JAX package's.

The same acquisition program (nested locks, a re-entrant lock, a
condition variable, a second thread, a reversed order) runs through both
trackers: `edges()` (with thread names and witness stacks),
`acquisitions()` and `report()` are equal, and checked against the same
static order after every step, `LockOrderViolation` is raised at the same
step, with the same message.  The port's tracked locks keep the lock and
condition protocols (`wait_for` included).
"""
import threading

from photon_ml_tpu.utils import locktrace as jax_locktrace
from photon_ml_tpu_torch.utils import locktrace

# the orders a static analysis would allow: A before B, R before A, A
# before C
STATIC = {("A._lock", "B._lock"), ("R._lock", "A._lock"), ("A._lock", "C._cv")}


def program(lt) -> list:
    """Steps of acquisitions under an armed tracker; after each, the
    violation message of `assert_consistent(STATIC)` (None if none).
    -> (tracker, messages)."""
    messages = []

    def check(tracker):
        try:
            tracker.assert_consistent(STATIC)
            messages.append(None)
        except lt.LockOrderViolation as e:
            messages.append(str(e))

    with lt.enabled() as tracker:
        a = lt.tracked(threading.Lock(), "A._lock")
        b = lt.tracked(threading.Lock(), "B._lock")
        r = lt.tracked(threading.RLock(), "R._lock")
        cv = lt.tracked(threading.Condition(), "C._cv")
        with a:
            with b:
                pass
        check(tracker)
        assert r.acquire() and r.acquire()           # re-entrant: no self-edge
        with a:
            pass
        r.release()
        r.release()
        check(tracker)
        done = []

        def worker():
            with a:
                with cv:
                    done.append(1)
                    cv.notify_all()
        t = threading.Thread(target=worker, name="lock-worker")
        with cv:
            t.start()
            assert cv.wait_for(lambda: done, timeout=5.0)
        t.join(timeout=5.0)
        check(tracker)
        with b:
            with a:                                  # B -> A reverses A -> B
                pass
        check(tracker)
        with cv:
            with b:                                  # no static counterpart
                pass
        check(tracker)
    return tracker, messages


def test_the_same_program_gives_the_same_record():
    (port, port_msgs), (jax, jax_msgs) = program(locktrace), program(jax_locktrace)
    assert port.edges() == jax.edges()
    assert port.acquisitions() == jax.acquisitions()
    assert port.report() == jax.report()
    assert port_msgs == jax_msgs
    assert port_msgs[:3] == [None, None, None] and "REVERSES" in port_msgs[3]
    assert "call-graph gap" in port_msgs[4]
    assert port.edges()[("A._lock", "C._cv")][0] == "lock-worker"
    assert ("R._lock", "R._lock") not in port.edges()


def test_disarmed_tracked_is_the_raw_lock():
    lock, cv = threading.Lock(), threading.Condition()
    assert locktrace.tracked(lock, "X._lock") is lock
    assert locktrace.tracked(cv, "X._cv") is cv
    assert locktrace.active() is None


def test_tracked_condition_keeps_wait_for_semantics():
    """The AsyncCheckpointer's condition: wait_for returns once the
    predicate holds, times out with False, and the lock stays on the held
    stack across the wait (no ordering fact from the internal re-acquire)."""
    with locktrace.enabled() as tracker:
        cv = locktrace.tracked(threading.Condition(), "AsyncCheckpointer._cv")
        assert isinstance(cv, locktrace.TracedCondition)
        state = []

        def producer():
            with cv:
                state.append("written")
                cv.notify_all()
        t = threading.Thread(target=producer)
        with cv:
            assert cv.wait_for(lambda: False, timeout=0.01) is False
            t.start()
            assert cv.wait_for(lambda: state, timeout=5.0) == ["written"]
        t.join(timeout=5.0)
    assert tracker.acquisitions()["AsyncCheckpointer._cv"] == 2
    assert tracker.edges() == {}


def test_ported_modules_track_their_locks(tmp_path):
    """Armed before construction, the ported classes' locks report under
    the JAX package's names, and a checkpointed fit's writer thread
    orders no lock inside another."""
    import torch

    import game_jax_side as side
    from photon_ml_tpu_torch.data.game_data import build_game_dataset
    from photon_ml_tpu_torch.game import GameEstimator, GameTrainingConfig
    from photon_ml_tpu_torch.utils import faults
    train, val = side.containment_glmix(build_game_dataset)
    with locktrace.enabled() as tracker:
        plan = faults.FaultPlan.from_dict(side.POISON_PLAN)
        with faults.injected(plan):
            GameEstimator(GameTrainingConfig.from_dict(side.containment_config_dict(2)),
                          device="cpu", dtype=torch.float64).fit(
                train, val, ["AUC"], checkpoint_dir=str(tmp_path / "ckpt"))
    acquired = tracker.acquisitions()
    for name in ("FaultPlan._lock", "AsyncCheckpointer._cv", "StoreStats._lock",
                 "BlockStore._lock"):
        assert acquired.get(name, 0) > 0, name
    assert tracker.edges() == {}
