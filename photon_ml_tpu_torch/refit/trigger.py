"""Trigger layer: WHEN the continuous-training loop runs a refit cycle (a
copy of photon_ml_tpu/refit/trigger.py).

Three modes (`TriggerConfig.mode`):

  * "manual"   — nothing fires on its own; `run_once()` is the one-shot
                 entry point (cli.refit without --interval/--on-trip).
  * "interval" — cron-style: a cycle fires every `interval_s` seconds.
  * "on_trip"  — automatic remediation: the trigger polls the
                 HealthMonitor's verdict and fires after `trip_polls`
                 CONSECUTIVE degraded polls (the gates already encode
                 sustain windows; the poll count de-bounces the verdict
                 edge), spaced by `cooloff_s`.

The on-trip orchestration is deliberately thin because the subsystems
already do the heavy lifting: a tripped gate has ALREADY paused the
online updater (HealthConfig.pause_updates), so the refit runs against a
quiescent model; the driver compacts, fits, and validates; a winning
swap lands through ModelRegistry.install(), whose swap hook
(health.on_model_event) resets every gate and resumes the updater —
trip -> pause -> compact -> refit -> validate -> swap -> gates reset ->
resume, with each arrow owned by the component that already owned it.
A losing candidate leaves the gates tripped and the updater paused; the
trigger retries after `cooloff_s`.

`poll()` is one state-machine step with an injectable clock — tests and
the bench drive it synchronously; `start()` runs it on a daemon thread
every `poll_s` seconds for real deployments (cycle errors are recorded
and the loop keeps running: a failed refit must not kill the trigger).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.refit.driver import RefitResult

_MODES = ("manual", "interval", "on_trip")


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    mode: str = "manual"
    #: interval mode: seconds between cycles
    interval_s: float = 3600.0
    #: background loop cadence (start()/stop())
    poll_s: float = 0.5
    #: on_trip mode: consecutive degraded polls that fire a cycle
    trip_polls: int = 2
    #: on_trip mode: minimum spacing between automatic cycles
    cooloff_s: float = 60.0

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got "
                             f"{self.mode!r}")
        if self.interval_s <= 0 or self.poll_s <= 0 or self.cooloff_s < 0:
            raise ValueError("interval_s/poll_s must be > 0 and "
                             "cooloff_s >= 0")
        if self.trip_polls < 1:
            raise ValueError("trip_polls must be >= 1")


class RefitTrigger:
    """Owns the when; the RefitDriver owns the what."""

    def __init__(self, driver, health=None,
                 config: TriggerConfig = TriggerConfig(),
                 clock: Callable[[], float] = time.monotonic):
        if config.mode == "on_trip" and health is None:
            raise ValueError("on_trip mode needs the HealthMonitor "
                             "(ScoringService.health)")
        self.driver = driver
        self.health = health
        self.config = config
        self._clock = clock
        self._lock = threading.Lock()
        self._last_fire: Optional[float] = None  # photonlint: guarded-by=_lock
        self._degraded_polls = 0  # photonlint: guarded-by=_lock
        self._fires = 0  # photonlint: guarded-by=_lock
        self._swaps = 0  # photonlint: guarded-by=_lock
        self._last_error: Optional[str] = None  # photonlint: guarded-by=_lock
        self._last_reason: Optional[str] = None  # photonlint: guarded-by=_lock
        self._thread: Optional[threading.Thread] = None  # photonlint: guarded-by=_lock
        self._stop = threading.Event()

    # -- firing -------------------------------------------------------------

    def run_once(self, reason: str = "manual",
                 version: Optional[str] = None) -> RefitResult:
        """Fire one cycle NOW (every mode supports a manual kick)."""
        telemetry.event("refit_trigger", mode=self.config.mode,
                        reason=reason)
        with self._lock:
            self._fires += 1
            self._last_reason = reason
            self._last_fire = self._clock()
        try:
            result = self.driver.run_once(version=version)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            with self._lock:
                self._last_error = f"{type(e).__name__}: {e}"
            raise
        with self._lock:
            self._last_error = None
            if result.swapped:
                self._swaps += 1
        return result

    def poll(self) -> Optional[RefitResult]:
        """One trigger step: decide, maybe fire, never raise (a cycle
        failure is recorded in `state()` and the incumbent keeps
        serving).  Returns the cycle's result when one ran."""
        decision = self._decide()
        if decision is None:
            return None
        try:
            return self.run_once(reason=decision)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:
            return None     # recorded by run_once; the loop keeps going

    def _decide(self) -> Optional[str]:
        cfg = self.config
        now = self._clock()
        if cfg.mode == "manual":
            return None
        if cfg.mode == "interval":
            with self._lock:
                due = (self._last_fire is None
                       or now - self._last_fire >= cfg.interval_s)
            return "interval" if due else None
        # on_trip: de-bounce the degraded verdict, respect the cooloff
        degraded = bool(self.health.degraded)
        with self._lock:
            self._degraded_polls = (self._degraded_polls + 1 if degraded
                                    else 0)
            sustained = self._degraded_polls >= cfg.trip_polls
            cooled = (self._last_fire is None
                      or now - self._last_fire >= cfg.cooloff_s)
            if sustained and cooled:
                self._degraded_polls = 0
                return "health_trip"
        return None

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            thread = threading.Thread(target=self._loop,
                                      name="refit-trigger", daemon=True)
            self._thread = thread
        thread.start()

    def stop(self) -> None:
        # swap the reference out under the lock, join OUTSIDE it: the
        # loop thread takes the same lock in poll()/run_once()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        thread.join()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.poll()
            self._stop.wait(self.config.poll_s)

    # -- introspection ------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            age = (None if self._last_fire is None
                   else self._clock() - self._last_fire)
            return {"mode": self.config.mode, "fires": self._fires,
                    "swaps": self._swaps,
                    "degraded_polls": self._degraded_polls,
                    "last_fire_age_s": age,
                    "last_reason": self._last_reason,
                    "last_error": self._last_error,
                    "running": self._thread is not None}
