"""Multi-process runtime on torch.distributed: bring-up, per-process row
ranges and lost-worker containment (port of
photon_ml_tpu/parallel/multihost.py).

In the port one process is one rank of the mesh: a process drives one
device, so `--num-processes` counts ranks where the JAX package counts
hosts.  Three concerns live here, as in the JAX package:

  * **Process identity** (`process_count`/`process_index`/`is_primary`):
    from `initialize()` state, falling back to the ``PHOTON_NUM_PROCESSES``
    / ``PHOTON_PROCESS_ID`` environment.  `utils/durable.py` consults
    `is_primary()`, so only process 0 performs durable writes.
  * **Bring-up** (`initialize`/`shutdown`): a TCP store at the coordinator
    address (process 0 listens), then `torch.distributed` over it with an
    explicit backend: NCCL by default on CUDA, gloo when asked for or on
    the CPU.  Two NCCL ranks on one card are refused before NCCL starts
    (NCCL cannot run them); nothing switches backend by itself.
  * **Lost-worker containment** (`WorkerWatchdog`): heartbeat files under
    the shared run directory; a silent peer requests graceful preemption
    and, if the loop is wedged inside a collective, the survivor
    hard-exits with the resumable status 75.

Each rank stages only its own row block (`process_row_range`; the mesh's
`Mesh.block` and the placement helpers of parallel/mesh.py), and
`Mesh.assemble` gathers a rank-local block to every rank, the role of the
JAX package's `host_gather`.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

logger = logging.getLogger("photon_ml_tpu_torch")

#: env-var fallbacks for launchers (flags win when passed explicitly)
ENV_COORDINATOR = "PHOTON_COORDINATOR"
ENV_NUM_PROCESSES = "PHOTON_NUM_PROCESSES"
ENV_PROCESS_ID = "PHOTON_PROCESS_ID"

_LOCK = threading.Lock()
_STATE: Dict[str, object] = {
    "initialized": False,     # torch.distributed started here (a group exists)
    "declared": False,        # identity declared (covers num_processes == 1)
    "coordinator": None,
    "num_processes": 1,
    "process_id": 0,
    "backend": None,
    "watchdog": None,
}


class MultihostInitError(RuntimeError):
    """Bring-up failed or was re-attempted with different parameters; the
    message names the coordinator address and process id."""


class WorkerLost(RuntimeError):
    """A peer process missed its heartbeat deadline (SIGKILL, OOM,
    partition).  Carries the lost process id."""

    def __init__(self, process_id: int, silent_s: float):
        super().__init__(
            f"worker process {process_id} lost: no heartbeat for "
            f"{silent_s:.1f}s — surviving processes exit resumably "
            "(status 75) so a relaunch can re-chunk over the survivors")
        self.process_id = process_id
        self.silent_s = silent_s


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def process_count() -> int:
    """Processes (ranks) in this run, without touching torch.distributed."""
    if _STATE["declared"]:
        return int(_STATE["num_processes"])  # type: ignore[arg-type]
    return _env_int(ENV_NUM_PROCESSES) or 1


def process_index() -> int:
    if _STATE["declared"]:
        return int(_STATE["process_id"])  # type: ignore[arg-type]
    return _env_int(ENV_PROCESS_ID) or 0


def is_primary() -> bool:
    """True on the one process that owns durable writes (checkpoints,
    models, summaries)."""
    return process_index() == 0


def active() -> bool:
    """True when this run spans more than one process."""
    return process_count() > 1


def group_started() -> bool:
    """True when `initialize` started a torch.distributed group."""
    return bool(_STATE["initialized"])


def default_backend(device) -> str:
    """NCCL on CUDA, gloo on the CPU: the rule when no backend is asked
    for.  Ranks that share a card must ask for gloo."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def parse_address(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise MultihostInitError(
            f"coordinator address {address!r} is not HOST:PORT")
    return host, int(port)


def duplicate_cards(cards: Sequence[str]) -> Optional[Tuple[int, int, str]]:
    """(rank a, rank b, card) for the first two ranks that name the same
    card, else None."""
    seen: Dict[str, int] = {}
    for rank, card in enumerate(cards):
        if card in seen:
            return seen[card], rank, card
        seen[card] = rank
    return None


def _card_id(device) -> str:
    import torch
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def _check_distinct_cards(store, device, num_processes: int,
                          process_id: int, timeout_s: float) -> None:
    """Refuse NCCL when two ranks sit on one card: every rank publishes
    its card in the store and reads the others' before NCCL starts."""
    store.set(f"photon/card/{process_id}", _card_id(device))
    keys = [f"photon/card/{r}" for r in range(num_processes)]
    store.wait(keys, datetime.timedelta(seconds=timeout_s))
    cards = [store.get(k).decode() for k in keys]
    # process 0 holds the store: it leaves only after every other rank has
    # read every card and said so, and a rank that has said so touches the
    # store no more before it decides
    deadline = time.time() + timeout_s
    if process_id == 0:
        while (int(store.add("photon/cards_read", 0)) < num_processes - 1
               and time.time() < deadline):
            time.sleep(0.01)
    else:
        store.add("photon/cards_read", 1)
    dup = duplicate_cards(cards)
    if dup is not None:
        a, b, card = dup
        raise MultihostInitError(
            f"ranks {a} and {b} are both on card {card}: NCCL cannot run "
            "two ranks on one card.  Give each rank its own card, or ask "
            "for the gloo backend (--dist-backend gloo), which takes "
            "co-located CUDA ranks")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               *, timeout_s: float = 120.0, backend: Optional[str] = None,
               device=None) -> None:
    """Join (or declare) a multi-process run.  Idempotent: a second call
    with the same parameters is a no-op; different parameters raise.

    All parameters fall back to ``PHOTON_COORDINATOR`` /
    ``PHOTON_NUM_PROCESSES`` / ``PHOTON_PROCESS_ID``.  With
    ``num_processes <= 1`` and no coordinator the identity is declared
    locally and no group starts (the relaunch-over-survivors path); a
    coordinator starts a group even for one process.  `backend` defaults
    to NCCL for a CUDA `device` (None means cuda) and gloo for the CPU;
    NCCL on the CPU and two NCCL ranks on one card raise.  A rank that
    cannot reach the coordinator raises MultihostInitError after
    `timeout_s`, naming the address and its process id."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR) or None
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)
    num_processes = int(num_processes or 1)
    process_id = int(process_id or 0)

    with _LOCK:
        if _STATE["declared"]:
            same = (_STATE["coordinator"] == coordinator_address
                    and _STATE["num_processes"] == num_processes
                    and _STATE["process_id"] == process_id
                    and backend in (None, _STATE["backend"]))
            if same:
                return  # idempotent double-init
            raise MultihostInitError(
                f"multihost already initialized as process "
                f"{_STATE['process_id']}/{_STATE['num_processes']} "
                f"(coordinator {_STATE['coordinator']!r}, backend "
                f"{_STATE['backend']!r}); refusing re-init as process "
                f"{process_id}/{num_processes} (coordinator "
                f"{coordinator_address!r}, backend {backend!r})")
        if num_processes <= 1 and coordinator_address is None:
            _STATE.update(declared=True, initialized=False, coordinator=None,
                          num_processes=1, process_id=0, backend=None)
            return
        if coordinator_address is None:
            raise MultihostInitError(
                f"num_processes={num_processes} requires a coordinator "
                "address (--coordinator HOST:PORT or "
                f"${ENV_COORDINATOR}) naming process 0's endpoint")
        if not (0 <= process_id < num_processes):
            raise MultihostInitError(
                f"process_id {process_id} out of range for "
                f"num_processes={num_processes} (coordinator "
                f"{coordinator_address!r})")
        from photon_ml_tpu_torch import resolve_device
        device = resolve_device(device)
        backend = backend or default_backend(device)
        if backend not in ("nccl", "gloo"):
            raise MultihostInitError(
                f"backend {backend!r}: the port runs on 'nccl' or 'gloo'")
        if backend == "nccl" and device.type != "cuda":
            raise MultihostInitError(
                f"backend 'nccl' needs CUDA ranks; device {device} is not "
                "one (use gloo on the CPU)")
        host, port = parse_address(coordinator_address)
        timeout = datetime.timedelta(seconds=timeout_s)
        try:
            store = dist.TCPStore(host, port, world_size=num_processes,
                                  is_master=process_id == 0, timeout=timeout,
                                  wait_for_workers=True)
            if backend == "nccl":
                if device.index is None:
                    device = torch.device("cuda", torch.cuda.current_device())
                torch.cuda.set_device(device)
                _check_distinct_cards(store, device, num_processes,
                                      process_id, timeout_s)
            dist.init_process_group(backend, store=store, rank=process_id,
                                    world_size=num_processes, timeout=timeout)
        except MultihostInitError:
            raise
        except Exception as e:
            raise MultihostInitError(
                f"process {process_id}/{num_processes} failed to join the "
                f"run at coordinator {coordinator_address!r} within "
                f"{timeout_s:.0f}s: {e}") from e
        _STATE.update(declared=True, initialized=True,
                      coordinator=coordinator_address,
                      num_processes=num_processes, process_id=process_id,
                      backend=backend)
        logger.info("multihost: process %d/%d joined run at %s (%s)",
                    process_id, num_processes, coordinator_address, backend)


def _exit_resumably(reason: str, lost) -> None:
    from photon_ml_tpu_torch.utils import faults
    logger.error("multihost: %s worker %s — hard-exiting resumably "
                 "(status %d)", reason, lost, faults.EXIT_PREEMPTED)
    logging.shutdown()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # pragma: no cover
        pass
    os._exit(faults.EXIT_PREEMPTED)


def shutdown() -> None:
    """Tear down the run: stop the watchdog, destroy the process group
    (when this process started one), reset identity.  Idempotent; safe
    from a finally block whether or not initialize() ran.  After a lost
    peer the group cannot be torn down cleanly (a teardown barrier would
    wait for the dead rank), so the survivor exits with status 75."""
    with _LOCK:
        wd = _STATE.get("watchdog")
        lost = (wd is not None
                and getattr(wd, "lost_process", None) is not None)
        if wd is not None:
            wd.stop()  # type: ignore[union-attr]
            _STATE["watchdog"] = None
        if _STATE["initialized"] and lost:
            _exit_resumably("the process group cannot close after losing",
                            wd.lost_process)  # type: ignore[union-attr]
        elif _STATE["initialized"]:
            import torch.distributed as dist
            try:
                if dist.is_initialized():
                    dist.destroy_process_group()
            except Exception:  # pragma: no cover - peer already gone
                logger.warning("destroy_process_group failed "
                               "(peer already gone?)", exc_info=True)
        _STATE.update(declared=False, initialized=False, coordinator=None,
                      num_processes=1, process_id=0, backend=None)


def set_watchdog(watchdog: Optional["WorkerWatchdog"]) -> None:
    """Register the run's watchdog so shutdown() stops it."""
    _STATE["watchdog"] = watchdog


# -- per-process placement ----------------------------------------------------

def process_row_range(n: int, *, count: Optional[int] = None,
                      index: Optional[int] = None) -> range:
    """This process's contiguous block of a length-`n` leading axis (the
    1/P of rows it stages, balanced to within one row)."""
    p = count if count is not None else process_count()
    i = index if index is not None else process_index()
    return range((n * i) // p, (n * (i + 1)) // p)


# -- lost-worker containment --------------------------------------------------

class WorkerWatchdog:
    """Per-process heartbeat files + peer staleness detection over the
    shared run directory (the filesystem the checkpoints live on).

    Every `interval_s` the daemon thread rewrites this process's
    ``heartbeats/proc-<i>.json`` and checks each peer's file.  A peer
    silent past `timeout_s` (and not marked done) is LOST: `on_lost` fires
    once (by default a graceful preemption request, so the training loop
    exits 75 at the next coordinate boundary with the newest checkpoint
    durable), and if the process is still alive `escalate_s` later
    (blocked inside a collective whose peer is gone) the watchdog
    hard-exits with the same status 75."""

    def __init__(self, directory: str, *,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 interval_s: float = 0.5, timeout_s: float = 10.0,
                 escalate_s: float = 10.0,
                 on_lost: Optional[Callable[[int], None]] = None):
        self.directory = os.path.join(directory, "heartbeats")
        self.num_processes = (num_processes if num_processes is not None
                              else process_count())
        self.process_id = (process_id if process_id is not None
                           else process_index())
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.escalate_s = float(escalate_s)
        self._on_lost = on_lost
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0
        # set once by whichever thread detects the loss first (the sweep
        # or the main thread's confirm_lost), through _publish_loss
        self._loss_lock = threading.Lock()
        self._lost_at: Optional[float] = None  # photonlint: guarded-by=atomic
        self.lost_process: Optional[int] = None  # photonlint: guarded-by=atomic

    def _publish_loss(self, lost: WorkerLost) -> bool:
        """First-writer-wins publication of a detected loss; True when this
        caller published it."""
        with self._loss_lock:
            if self.lost_process is not None:
                return False
            self._lost_at = time.time()
            self.lost_process = lost.process_id
        logger.error("multihost: %s", lost)
        return True

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"proc-{pid}.json")

    def _beat(self, done: bool = False) -> None:
        from photon_ml_tpu_torch.utils import durable
        durable.atomic_write_json(  # photonlint: all-process
            self._path(self.process_id),
            {"process_id": self.process_id, "pid": os.getpid(),
             "time": time.time(), "done": done},
            fsync=False, all_process=True)

    def start(self) -> "WorkerWatchdog":
        if self.num_processes <= 1:
            return self  # nothing to watch
        os.makedirs(self.directory, exist_ok=True)
        self._started_at = time.time()
        self._beat()
        self._thread = threading.Thread(
            target=self._run, name="photon-multihost-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Clean exit: mark this process done (peers finishing later do not
        take its silence for a crash) and stop the thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4 + 1.0)
            self._thread = None
        if self.num_processes > 1 and self._started_at:
            try:
                self._beat(done=True)
            except OSError:  # pragma: no cover - run dir removed under us
                pass

    def confirm_lost(self, wait_s: Optional[float] = None) -> Optional[int]:
        """Decide synchronously whether a peer is dead: a failed collective
        surfaces in the main thread before a heartbeat interval passes, so
        poll the peers' heartbeats for up to `wait_s` (default timeout_s
        plus slack).  Returns the lost process id, or None."""
        if self.num_processes <= 1:
            return None
        wait_s = (self.timeout_s + 2.0 * self.interval_s + 1.0
                  if wait_s is None else float(wait_s))
        deadline = time.time() + wait_s
        while self.lost_process is None:
            lost = self.check_peers()
            if lost is not None:
                self._publish_loss(lost)
                break
            if time.time() >= deadline:
                break
            time.sleep(min(self.interval_s, 0.25))
        return self.lost_process

    def check_peers(self, now: Optional[float] = None) -> Optional[WorkerLost]:
        """One sweep over the peers' heartbeats."""
        now = time.time() if now is None else now
        for pid in range(self.num_processes):
            if pid == self.process_id:
                continue
            try:
                with open(self._path(pid)) as f:
                    beat = json.load(f)
            except (OSError, ValueError):
                beat = None  # not written yet, or torn mid-replace
            if beat is None:
                silent = now - self._started_at
            elif beat.get("done"):
                continue
            else:
                silent = now - float(beat.get("time", 0.0))
            if silent > self.timeout_s:
                return WorkerLost(pid, silent)
        return None

    def _run(self) -> None:
        from photon_ml_tpu_torch import telemetry
        from photon_ml_tpu_torch.utils import faults
        while not self._stop.wait(self.interval_s):
            try:
                self._beat()
            except OSError:  # pragma: no cover - disk full / dir gone
                logger.warning("multihost watchdog: heartbeat write failed",
                               exc_info=True)
            lost = self.check_peers()
            if lost is None:
                continue
            if self._publish_loss(lost):
                telemetry.counter("multihost.worker_lost").inc()
                if self._on_lost is not None:
                    self._on_lost(lost.process_id)
                else:
                    faults.request_preemption()
            elif time.time() - self._lost_at > self.escalate_s:
                # the loop never reached a boundary: it is blocked inside a
                # collective whose peer is dead
                _exit_resumably(
                    f"still alive {time.time() - self._lost_at:.1f}s after "
                    "losing", self.lost_process)


def free_port() -> int:
    """A free TCP port on this host (for a local coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(base: Optional[dict] = None) -> dict:
    """The environment for a spawned rank: the launcher's identity
    variables are dropped, since the child takes its identity from flags."""
    env = dict(os.environ if base is None else base)
    for k in (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID):
        env.pop(k, None)
    return env

