"""Deterministic fault injection + graceful preemption: the containment
layer's control plane (a copy of photon_ml_tpu/utils/faults.py).

The registry, plans, JSON and preemption semantics are the JAX package's,
so a fault plan written for either package loads in the other.  The port
threads the sites its subsystems have (checkpoint.write,
checkpoint.fsync, model.save, model.load, solve.poison); the others are
registered so that such plans load, and fire once their subsystems are
ported.  A fired fault increments `faults.fired` and emits a `fault`
event through the port's telemetry, as in the JAX package.

The reference Photon ML inherited fault tolerance for free from Spark's
lineage-based recovery (GLMix, KDD'16); a JAX rebuild has to build its own —
and a failure path that is never exercised is a failure path that does not
work.  This module makes faults FIRST-CLASS and REPRODUCIBLE:

  * `FaultPlan` / `FaultSpec` — a seeded registry of named injection sites
    (trigger by exact hit index or by seeded probability, optionally
    filtered on call context like the coordinate name or chunk index).
    Activated per-process via `install_plan` / the `injected` context
    manager, or across process boundaries via the `PHOTON_FAULT_PLAN`
    environment variable (inline JSON or `@file`) — which is how the
    bench's kill-resume chaos leg arms its subprocess children.
  * `fire(site, **ctx)` — the hook threaded through chunk staging, device
    transfer, checkpoint write/fsync, and model save/load.  With no plan
    installed it is a module-global None check and return: a zero-overhead
    no-op on every hot path (the compile-count and pipelined-timing smokes
    gate this).
  * transient-vs-fatal classification (`is_transient`) shared by the
    streaming Prefetcher's retry loop.
  * `GracefulPreemption` — SIGTERM/SIGINT handling for preemptible pools:
    first signal requests a graceful stop (the descent loop finishes the
    in-flight coordinate update, makes the newest checkpoint durable, and
    raises `Preempted`); a second signal escalates to KeyboardInterrupt.
    `cli.train` maps `Preempted` to the distinct resumable exit status
    `EXIT_PREEMPTED` (75, EX_TEMPFAIL — "transient failure, retry").

Every injection site is DECLARED in the `SITES` registry below (name ->
declared context keys).  `FaultPlan` rejects unknown sites and unknown
`match` keys at construction/install time — a typo'd site or ctx key in
an injection spec would otherwise arm a fault that silently never fires.

Injection sites currently threaded (ctx keys in parentheses):

  stage.fetch       chunk staging host read        (chunk)
  stage.transfer    chunk host->device transfer    (chunk; covers mesh-
                    sharded chunk staging too — the transfer callable is
                    behind the same site)
  mesh.stage        mesh residency pad+shard       (key, field)
                    transfer (parallel/mesh_residency.py + the
                    pad_and_shard_rows scoring path); transient faults
                    retry with the Prefetcher's backoff discipline,
                    fatal ones raise MeshStagingError
  admm.stage        ADMM derived-aggregate staging (key, field)
                    (parallel/mesh_residency.stage_derived: the consensus
                    lane's per-shard Gram eigendecomposition, built on
                    device and pinned per (coordinate, mesh)); transient
                    faults retry with the staging backoff discipline —
                    the derivation is deterministic so the retry is
                    bit-exact — fatal ones raise MeshStagingError.  There
                    is deliberately NO solve.consensus site: the ADMM
                    iteration keeps duals/consensus state in the on-device
                    while_loop carry and does no host-visible I/O, so the
                    staging boundary is the lane's only fault surface
  checkpoint.write  checkpoint record write start  (iteration)
  checkpoint.fsync  after state.json.tmp fsync,    (iteration)
                    before the atomic rename — a "kill" here is the
                    canonical torn-checkpoint crash test
  model.save        save_game_model entry          (directory)
  model.load        load_game_model entry          (directory)
  solve.poison      after a coordinate solve       (coordinate, iteration)
                    — action "poison" corrupts the solve result with NaNs
                    instead of raising, exercising the quarantine path
  solve.local       one chunk's stochastic local   (chunk, epoch)
                    solve (ops/chunked.py stochastic_pass, epoch = the
                    pass index); transient faults retry the chunk's
                    local epochs (the kernel is deterministic, so the
                    retry is bit-exact), fatal ones raise
                    LocalSolveError naming the chunk
  online.solve      online updater micro-batch     (coordinate)
                    solve (online/updater.py); transient faults retry with
                    the staging backoff discipline, "poison" corrupts the
                    solved rows with NaNs so the non-finite freeze path
                    (entity quarantine, live table untouched) is exercised
  online.publish    online delta publish into the  (coordinate)
                    live scorer (registry.apply_delta call site);
                    transient faults retry, fatal ones drop the delta and
                    re-enqueue the feedback for the next cycle
  health.evaluate   model-health window evaluation (kind)
                    (health/monitor.py, kind = "drift" | "labels");
                    transient faults SKIP the window (counted in
                    health.evaluate_skipped — a dropped verdict, never a
                    dropped serving request), fatal ones propagate to the
                    thread that closed the window
  replog.append     replication-log record append   (kind)
                    (fleet/replog.py, kind = record type); transient
                    faults retry with the staging backoff discipline in
                    the publisher, fatal ones surface to the publishing
                    thread (the record never becomes visible to replicas)
  replog.read       replication-log tail read       (segment)
                    (fleet/replog.py); transient faults retry in the
                    replica's poll loop, fatal ones mark the replica
                    failed (/healthz degraded, front stops routing)
  replica.apply     one replicated record applied   (kind)
                    to a replica's live registry (fleet/replica.py);
                    transient faults retry with backoff and the replica
                    converges to the bit-identical table state, fatal
                    ones mark the replica failed
  store.fetch       tiered-store tier fetch         (tier, block)
                    (store/entity.py cold-segment reads + warm row reads,
                    store/handles.py block re-stages); transient faults
                    retry with the chunk-staging backoff discipline and
                    are absorbed bit-exact, fatal ones raise StoreError
                    naming the entity block/segment
  store.promote     rows promoted into the device   (coordinate, rows)
                    hot tier (store/entity.py); transient faults retry
                    (the promote commit is idempotent), fatal ones name
                    the entity block
  store.spill       dirty warm segment written back (block)
                    to the durable cold tier (store/entity.py); transient
                    faults retry, fatal ones raise StoreError naming the
                    entity block (the segment stays in the write-back
                    buffer, so no row value is ever lost to a failed
                    spill)
  refit.compact     one sealed training chunk     (chunk)
                    written by the log compactor (refit/compactor.py);
                    transient faults retry with the staging backoff
                    discipline, a "kill" here is the canonical
                    mid-compaction crash test (restart resumes from the
                    durable checkpoint and converges to bit-identical
                    chunk files), fatal ones raise CompactionError
  refit.validate    candidate-vs-incumbent holdout (candidate)
                    evaluation (the refit cycle); transient faults retry,
                    fatal ones abort the refit cycle with the incumbent
                    still serving (no swap record is appended)
  refit.swap        candidate publish into the     (version)
                    serving registry (the refit cycle's install call
                    site); transient faults retry with backoff, fatal
                    ones leave the incumbent serving — the swap is the
                    LAST step, so a failed publish never strands a
                    half-installed candidate
  shard.route       one shard group's fan-out leg  (shard)
                    of a sharded scoring request (fleet/front.py,
                    before the leg's hedged/failover attempt loop);
                    transient faults are absorbed by that loop's
                    failover discipline, fatal ones fail the leg — the
                    merge then applies the configured degradation
                    policy (partial-score or error), so a fatal route
                    fault degrades ONLY requests touching that shard
  shard.merge       the per-coordinate margin merge (coordinate)
                    of collected shard legs (fleet/front.py, coordinate
                    = ","-joined fold order); transient faults retry
                    the merge (it is a pure host fold over already-
                    collected legs, so the retry is bit-exact), fatal
                    ones fail the request with the merge error
  shard.catchup     one shard-filtered record      (shard)
                    applied by a sharded replica (fleet/replica.py,
                    fired inside the apply path so the replica's
                    standard transient retry/backoff absorbs transient
                    faults bit-exactly; fatal ones mark the replica
                    failed exactly like replica.apply)
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("photon_ml_tpu_torch")

#: Distinct resumable exit status for graceful preemption (EX_TEMPFAIL).
EXIT_PREEMPTED = 75

#: The central fault-site registry: site name -> the context keys its
#: `fire(...)` call passes (what injection specs may `match` on): the
#: JAX package's registry, whole, kept in sync with the docstring above.
SITES: Dict[str, Tuple[str, ...]] = {
    "stage.fetch": ("chunk",),
    "stage.transfer": ("chunk",),
    "mesh.stage": ("key", "field"),
    "admm.stage": ("key", "field"),
    "checkpoint.write": ("iteration",),
    "checkpoint.fsync": ("iteration",),
    "model.save": ("directory",),
    "model.load": ("directory",),
    "solve.poison": ("coordinate", "iteration"),
    "solve.local": ("chunk", "epoch"),
    "online.solve": ("coordinate",),
    "online.publish": ("coordinate",),
    "health.evaluate": ("kind",),
    "replog.append": ("kind",),
    "replog.read": ("segment",),
    "replica.apply": ("kind",),
    "store.fetch": ("tier", "block"),
    "store.promote": ("coordinate", "rows"),
    "store.spill": ("block",),
    "refit.compact": ("chunk",),
    "refit.validate": ("candidate",),
    "refit.swap": ("version",),
    "shard.route": ("shard",),
    "shard.merge": ("coordinate",),
    "shard.catchup": ("shard",),
}


class FaultError(Exception):
    """Base class of injected faults."""


class TransientFault(FaultError):
    """An injected fault the retry machinery is expected to absorb."""

    transient = True


class FatalFault(FaultError):
    """An injected fault that must NOT be retried (propagates and kills
    the operation, like a permission error or corrupted input would)."""

    transient = False


# exception types the streaming retry loop treats as retryable; anything
# else — and always KeyboardInterrupt/SystemExit/MemoryError/FatalFault —
# propagates immediately
TRANSIENT_EXCEPTIONS = (TransientFault, ConnectionError, TimeoutError,
                        OSError)


def is_transient(exc: BaseException) -> bool:
    """Transient-vs-fatal classification for retry loops: an explicit
    `transient` attribute wins, then the type table above.  Interrupts and
    memory exhaustion are never transient."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, MemoryError)):
        return False
    flagged = getattr(exc, "transient", None)
    if flagged is not None:
        return bool(flagged)
    return isinstance(exc, TRANSIENT_EXCEPTIONS)


_ACTIONS = ("transient", "fatal", "kill", "sigterm", "poison")


@dataclasses.dataclass
class FaultSpec:
    """One arming rule: WHERE (site + context match), WHEN (1-based hit
    indices, or a seeded probability with an optional fire cap), WHAT
    (action).  Counters live on the spec so a plan is also its own
    report."""

    site: str
    action: str = "transient"
    hits: Tuple[int, ...] = ()          # 1-based matching-call indices
    probability: float = 0.0            # alternative to hits (seeded RNG)
    max_fires: Optional[int] = None     # cap for probability mode
    match: Dict[str, object] = dataclasses.field(default_factory=dict)
    # runtime counters (not part of the JSON identity)
    calls: int = dataclasses.field(default=0, compare=False)
    fired: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {_ACTIONS})")
        if not self.hits and not self.probability:
            raise ValueError(f"fault spec for site {self.site!r} never "
                             "fires: give hits=[...] or probability>0")
        self.hits = tuple(int(h) for h in self.hits)

    def matches(self, ctx: Dict[str, object]) -> bool:
        """Context filter.  A `match` key the site did not pass is an
        ERROR, not a silent no-match: the old lenient behavior compared
        against None and hid typo'd injection specs behind faults that
        never fired."""
        missing = [k for k in self.match if k not in ctx]
        if missing:
            raise ValueError(
                f"fault spec for site {self.site!r} matches on context "
                f"key(s) {missing} that the site did not pass "
                f"(got {sorted(ctx)}); declared keys for the site live "
                "in utils.faults.SITES")
        return all(str(ctx[k]) == str(v) for k, v in self.match.items())

    def to_dict(self) -> dict:
        d = {"site": self.site, "action": self.action}
        if self.hits:
            d["hits"] = list(self.hits)
        if self.probability:
            d["probability"] = self.probability
        if self.max_fires is not None:
            d["max_fires"] = self.max_fires
        if self.match:
            d["match"] = dict(self.match)
        return d


class FaultPlan:
    """A seeded set of FaultSpecs + firing state.  Thread-safe: sites fire
    from the staging thread and the training thread concurrently."""

    def __init__(self, specs, seed: int = 0):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        for s in self.specs:
            if s.site not in SITES:
                known = ", ".join(sorted(SITES))
                raise ValueError(
                    f"unknown fault site {s.site!r} — a plan naming an "
                    "unregistered site would arm a fault that never "
                    f"fires (known sites: {known}; new sites must be "
                    "declared in utils.faults.SITES)")
            bad = sorted(set(s.match) - set(SITES[s.site]))
            if bad:
                raise ValueError(
                    f"fault spec for site {s.site!r} matches on unknown "
                    f"context key(s) {bad}; the site passes "
                    f"{list(SITES[s.site])} (see utils.faults.SITES)")
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        from photon_ml_tpu_torch.utils import locktrace
        self._lock = locktrace.tracked(threading.Lock(),
                                       "FaultPlan._lock")

    # -- JSON round-trip (PHOTON_FAULT_PLAN / --fault-plan) ----------------
    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        return FaultPlan(d.get("faults", []), seed=d.get("seed", 0))

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        return FaultPlan.from_dict(json.loads(text))

    def to_dict(self) -> dict:
        # snapshot under the lock: specs fire (and count) from staging and
        # training threads concurrently with plan serialization [PH010]
        with self._lock:
            specs = list(self.specs)
        return {"seed": self.seed,
                "faults": [s.to_dict() for s in specs]}

    def report(self) -> dict:
        """Per-site calls/fired accounting (the bench records this per
        chaos leg)."""
        sites: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for s in self.specs:
                agg = sites.setdefault(s.site, {"calls": 0, "fired": 0})
                agg["calls"] += s.calls
                agg["fired"] += s.fired
            total = sum(s.fired for s in self.specs)
        return {"sites": sites, "total_fired": total}

    def _decide(self, site: str, ctx: Dict[str, object]) -> Optional[str]:
        with self._lock:
            for s in self.specs:
                if s.site != site or not s.matches(ctx):
                    continue
                s.calls += 1
                fire_now = (s.calls in s.hits if s.hits else
                            (s.max_fires is None or s.fired < s.max_fires)
                            and self._rng.random() < s.probability)
                if fire_now:
                    s.fired += 1
                    return s.action
        return None

    def fire(self, site: str, **ctx) -> Optional[str]:
        action = self._decide(site, ctx)
        if action is None:
            return None
        logger.warning("fault injection: site=%s ctx=%s action=%s",
                       site, ctx, action)
        # telemetry correlation: the fired fault lands in the run log /
        # trace attached to whatever span is active at the injection site
        # (a chunk-staging span, a coordinate visit, a checkpoint write).
        # Import here, not at module top: faults must stay importable with
        # zero package dependencies for subprocess children arming early.
        from photon_ml_tpu_torch import telemetry
        telemetry.counter("faults.fired").inc()
        telemetry.event("fault", site=site, action=action,
                        **{k: str(v) for k, v in ctx.items()})
        if action == "transient":
            raise TransientFault(f"injected transient fault at {site!r} "
                                 f"(ctx {ctx})")
        if action == "fatal":
            raise FatalFault(f"injected fatal fault at {site!r} (ctx {ctx})")
        if action == "kill":
            # the crash test: an abrupt, unhandleable death mid-operation
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "sigterm":
            # graceful-preemption test: delivered to our own handler
            os.kill(os.getpid(), signal.SIGTERM)
            return None
        return action  # "poison": caller applies the corruption


# -- process-global activation ------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) the process-global plan; returns the
    previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    return prev


class injected:
    """Context manager: `with faults.injected(plan): ...` — scoped
    activation for tests and in-process bench legs."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        self._prev = install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc):
        install_plan(self._prev)


def install_from_env(env_var: str = "PHOTON_FAULT_PLAN"
                     ) -> Optional[FaultPlan]:
    """Arm the plan named by the environment (inline JSON, or `@path`):
    how subprocess children of the chaos bench — and preempted re-launches
    of cli.train — pick up their injection plan."""
    raw = os.environ.get(env_var)
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    plan = FaultPlan.from_json(raw)
    install_plan(plan)
    logger.warning("fault plan ACTIVE from $%s: %d spec(s), seed %d",
                   env_var, len(plan.specs), plan.seed)
    return plan


def fire(site: str, **ctx) -> Optional[str]:
    """The injection hook.  MUST stay zero-overhead when no plan is
    installed — it sits on chunk staging and checkpoint hot paths."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)


# -- graceful preemption ------------------------------------------------------

class Preempted(RuntimeError):
    """Raised by the descent loop after a graceful-preemption request has
    been honored: the in-flight coordinate update finished and the newest
    checkpoint record is durable.  cli.train maps this to EXIT_PREEMPTED."""

    def __init__(self, completed_iterations: int, checkpointed: bool,
                 checkpoint_dir: Optional[str] = None):
        self.completed_iterations = completed_iterations
        self.checkpointed = checkpointed
        self.checkpoint_dir = checkpoint_dir
        super().__init__(
            f"training preempted after {completed_iterations} completed "
            f"outer iteration(s); "
            + (f"resumable from checkpoint {checkpoint_dir!r}"
               if checkpointed else "no durable checkpoint was written"))


_PREEMPT = threading.Event()


def preemption_requested() -> bool:
    return _PREEMPT.is_set()


def request_preemption() -> None:
    """Programmatic preemption (tests; also what the SIGTERM handler
    does)."""
    _PREEMPT.set()


def clear_preemption() -> None:
    _PREEMPT.clear()


class GracefulPreemption:
    """Scope that converts SIGTERM/SIGINT into a graceful-stop request.

    First signal: set the preemption flag (the descent loop notices at the
    next coordinate boundary, finishes the in-flight update, drains the
    checkpointer, raises Preempted).  Second signal: the operator means it
    — raise KeyboardInterrupt immediately.  Handlers install only in the
    main thread (signal module requirement) and are restored on exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._old: Dict[int, object] = {}

    def _handle(self, signum, frame):
        if _PREEMPT.is_set():
            raise KeyboardInterrupt(
                f"second signal {signum} during graceful preemption")
        logger.warning("signal %d: graceful preemption requested — will "
                       "stop after the in-flight coordinate update and "
                       "make the checkpoint durable", signum)
        _PREEMPT.set()

    def __enter__(self) -> "GracefulPreemption":
        clear_preemption()
        if threading.current_thread() is threading.main_thread():
            for sig in self.signals:
                try:
                    self._old[sig] = signal.signal(sig, self._handle)
                except (ValueError, OSError):  # non-main thread / exotic sig
                    pass
        return self

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old.clear()
        clear_preemption()
