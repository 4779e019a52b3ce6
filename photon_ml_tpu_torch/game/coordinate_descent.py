"""Block coordinate descent over GAME coordinates, the outer training loop
(port of photon_ml_tpu/game/coordinate_descent.py).

reference: CoordinateDescent (photon-lib/.../algorithm/CoordinateDescent.scala:40-385):
per iteration, per coordinate: partial score = full score - own score ->
update the model with the residual offsets -> rescore -> update the running
objective -> validate -> track the best full model by the first validation
evaluator.  Every coordinate's scores are one dense [n] tensor in canonical
row order, so the score algebra is `total - own` / `partial + new`.

Two timing modes, as the JAX package's: "pipelined" (the default) keeps
each update's objective and validation metrics as device scalars in a
pending list and reads them back in one batched copy per outer iteration,
with best-model tracking deferred to that boundary; "strict" ends every
update in a readback before the next begins, so each PhaseTimings span
holds the device work it launched.  Both run the same programs in the same
order, so their histories are equal bit for bit.

Fault containment, as the JAX package's:
  * checkpoints after every outer iteration (`checkpoint_dir`): sealed
    `iter-KKKK/` and `best-KKKK/` directories (size+sha256 manifest
    written last, a self-contained record.json inside) and an atomically
    replaced `state.json`; two records retained; written by a background
    thread in pipelined mode (AsyncCheckpointer) from host snapshots taken
    right after the iteration's read-back, synchronously in strict mode;
  * resume (`read_checkpoint`): stale `*.tmp` files and unverified partial
    directories pruned, state.json verified against its manifests, else the
    newest verified record, else a fresh start; a record written under
    another configuration fingerprint is refused;
  * the non-finite solve quarantine (game/quarantine.py): a device-side
    rollback at once, the health flag read back with the objective in the
    one copy per outer iteration, then one tightened retry or a freeze;
  * graceful preemption (utils/faults.py): after a SIGTERM the in-flight
    update finishes, the newest record is made durable and `Preempted` is
    raised.

Solver schedules (optim/schedule.py) cap each visit's solves; the budget of
every solve lands in its tracker.  Under an HBM budget a residency manager
(game/residency.py) rotates device residency around each visit, and a
streamed fixed effect's per-visit chunk-stream accounting lands in its
tracker (`stream`).  On a mesh (parallel/mesh.py) every rank runs this loop
in lockstep over replicated [n] score vectors (the coordinates assemble
their scores on every rank), so every rank computes the same objective
and takes the same branches; each visit's staged bytes (cold static data
vs warm offsets and x0, parallel/mesh_residency.py) land in its tracker
(`staged_bytes`), and only process 0 writes checkpoints (the JAX
package's multi-host branches).

Telemetry, as the JAX package's: the loop opens `outer_iteration` ->
`coordinate_visit` -> solve/objective/validation spans when the tracer is
armed, counts checkpoint writes, coalesced snapshots and recoveries, and
sets the `train.host_blocked_s`/`_frac` gauges at the fit's end.  Every
attribute and gauge is a host value: telemetry adds no device read.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import threading
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator, MultiEvaluator
from photon_ml_tpu_torch.game import quarantine as quarantine_mod
from photon_ml_tpu_torch.game.coordinates import Coordinate
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES, PointwiseLoss
from photon_ml_tpu_torch.optim.schedule import QuarantineRetrySchedule
from photon_ml_tpu_torch.optim.types import ConvergenceReason
from photon_ml_tpu_torch.telemetry.timings import PhaseTimings
from photon_ml_tpu_torch.utils import durable, faults, locktrace

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass
class ValidationSpec:
    """A validation evaluator, optionally grouped by an entity-index column
    (reference: MultiEvaluator id columns)."""

    evaluator: Evaluator | MultiEvaluator
    group_column: Optional[str] = None

    @property
    def name(self) -> str:
        return self.evaluator.name

    def evaluate(self, dataset: GameDataset, scores) -> float:
        """On the host: score + offset (Evaluator.scala:35-45), float64."""
        s = (scores.detach().cpu().numpy() if isinstance(scores, torch.Tensor)
             else np.asarray(scores)).astype(np.float64)
        if dataset.offsets is not None:
            s = s + dataset.offsets
        if self.group_column is not None:
            return self.evaluator.evaluate_grouped(
                dataset.entity_indices[self.group_column], s,
                dataset.response, dataset.weights)
        return self.evaluator(s, dataset.response, dataset.weights)


# PhaseTimings lives in telemetry/timings.py, as in the JAX package;
# re-imported above so `from photon_ml_tpu_torch.game.coordinate_descent
# import PhaseTimings` keeps working.


@dataclasses.dataclass
class TrackerSummary:
    """Host-side per-solve record: iterations (summed over entities for a
    batched solve), value+gradient passes of LBFGS/OWLQN (`fg_count`,
    likewise; None under TRON) or Hessian-vector products of TRON
    (`hv_count`, likewise; None otherwise), the solve's wall clock and
    ConvergenceReason counts over its lanes.  A factored random effect's
    update sums its latent-space and projection-refit solves.
    `iteration_cap`/`tolerance` record the inexactness budget the solve
    ran under (None: a full solve); `containment` records a quarantine
    outcome for the visit (None: a healthy solve; "rolled_back",
    "retry_ok" or "frozen", game/quarantine.py).  A frozen visit solves
    nothing: no iterations and no passes."""

    iterations: int
    fg_count: Optional[int]
    wall_s: float
    reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    # a random-effect update's batched solves, one per S-bucket
    # (game/coordinates.py::BucketSolve); None for a fixed effect
    buckets: Optional[list] = None
    hv_count: Optional[int] = None
    # a factored random effect's update: per inner iteration, its
    # latent-space solve's rounds and its projection refit's iterations
    # and passes (parallel/factored.py FactoredSolveResult.inner)
    inner: Optional[list] = None
    iteration_cap: Optional[int] = None
    tolerance: Optional[float] = None
    containment: Optional[str] = None
    # kernel builds and library loads during THIS visit (telemetry's
    # counterpart of the JAX package's compile watch, core.py): a warm fit
    # shows 0 everywhere.  None when the tracer is disarmed (the counter
    # only advances while a tracer is armed)
    retraces: Optional[int] = None
    # chunk-stream accounting delta of THIS visit (streamed fixed effects
    # only, a StreamStats snapshot diff): staged bytes/chunks, local epochs,
    # examples processed and examples_per_staged_byte.  None when resident
    stream: Optional[Dict[str, object]] = None
    # mesh bytes this rank staged during THIS visit ({"cold": b, "warm": b},
    # a TransferStats delta): a warm visit stages no cold bytes.  None on
    # fits without a mesh
    staged_bytes: Optional[Dict[str, int]] = None


def _summarize(result, wall_s: float, buckets=None, budget=None) -> TrackerSummary:
    """A solve's summary; a factored update's two solves (the latent-space
    and the projection refit of its last inner iteration) merged.
    `budget` is the (cap, tolerance) plan the solve ran under; a frozen
    visit (`result` None) has no solve."""
    cap, tol = (None, None) if budget is None else budget
    if result is None:
        return TrackerSummary(iterations=0, fg_count=0, wall_s=wall_s,
                              iteration_cap=cap, tolerance=tol)
    parts = [r for r in (getattr(result, "random_effect_result", None),
                         getattr(result, "latent_result", None)) if r is not None]
    parts = parts or [result]
    host = lambda v: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

    def total(field):
        vals = [getattr(r, field) for r in parts if getattr(r, field) is not None]
        return None if not vals else sum(int(np.sum(host(v))) for v in vals)
    reasons: Dict[str, int] = {}
    for r in parts:
        codes = np.atleast_1d(host(r.reason))
        for code, count in zip(*np.unique(codes, return_counts=True)):
            name = ConvergenceReason(int(code)).name
            reasons[name] = reasons.get(name, 0) + int(count)
    return TrackerSummary(iterations=total("iterations"), fg_count=total("fg_count"),
                          wall_s=wall_s, reasons=reasons, buckets=buckets,
                          hv_count=total("hv_count"), inner=getattr(result, "inner", None),
                          iteration_cap=cap, tolerance=tol)


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel                       # final full model
    best_model: GameModel                  # best by first validation evaluator
    objective_history: List[float]         # after each coordinate update
    validation_history: Dict[str, List[float]]
    # contiguous phase spans: "init/transfer", "init/score",
    # "init/validation_score", "{it}/{coord}/solve|objective|validation"
    # (+ the estimator adds "build/coordinates")
    timings: PhaseTimings
    # "it/coord" -> compact host-side solve summary
    trackers: Dict[str, TrackerSummary] = dataclasses.field(default_factory=dict)
    # factored coordinate -> the sibling random effect whose solution gave
    # it its projection at its first visit
    warm_starts: Dict[str, str] = dataclasses.field(default_factory=dict)
    # quarantine containment log (game/quarantine.py QuarantineMonitor
    # events: rollbacks, tightened-budget retries, freezes); empty on a
    # healthy fit
    containment_events: List[dict] = dataclasses.field(default_factory=list)
    frozen_coordinates: List[str] = dataclasses.field(default_factory=list)

    def total_iterations(self) -> int:
        return sum(t.iterations for t in self.trackers.values())

    def solver_diagnostics(self) -> Dict[str, dict]:
        """Per-coordinate solver totals for the fit summary, in the JAX
        package's shape: solve count, inner iterations, ConvergenceReason
        counts, the iteration cap of each visit (None: a full solve),
        containment outcome counts and the host-blocked seconds of the
        coordinate's spans; beyond the JAX package's keys, the
        value+gradient passes (each one launch of the fixed effect's
        kernel on the card), and, when a tracer was armed, the kernel
        builds and loads per coordinate (`retraces`)."""
        out: Dict[str, dict] = {}
        for key, t in sorted(self.trackers.items(),
                             key=lambda kv: (int(kv[0].split("/")[0]), kv[0])):
            coord = key.split("/", 1)[1]
            d = out.setdefault(coord, {"solves": 0, "iterations": 0,
                                       "reasons": {}, "iteration_caps": [],
                                       "containment": {},
                                       "host_blocked_s": 0.0,
                                       "value_gradient_passes": 0})
            d["solves"] += 1
            d["iterations"] += t.iterations
            # LBFGS/OWLQN count their passes; TRON makes one at x0 and one
            # per trial point (summed over lanes for a batched solve)
            d["value_gradient_passes"] += (t.fg_count if t.fg_count is not None
                                           else t.iterations + 1)
            d["iteration_caps"].append(t.iteration_cap)
            if t.containment is not None:
                d["containment"][t.containment] = \
                    d["containment"].get(t.containment, 0) + 1
            if t.retraces is not None:
                d["retraces"] = d.get("retraces", 0) + t.retraces
            for name, c in t.reasons.items():
                d["reasons"][name] = d["reasons"].get(name, 0) + c
            if t.staged_bytes is not None:
                sb = d.setdefault("staged_bytes", {"cold": 0, "warm": 0})
                sb["cold"] += t.staged_bytes.get("cold", 0)
                sb["warm"] += t.staged_bytes.get("warm", 0)
            if t.stream is not None:
                st = d.setdefault("stream", {
                    "passes": 0, "chunks_staged": 0, "total_bytes": 0,
                    "local_epochs": 0, "examples_processed": 0})
                for k in st:
                    st[k] += t.stream.get(k, 0)
        for label, seconds in self.timings.host_blocked.items():
            parts = label.split("/")
            if len(parts) == 3 and parts[1] in out:
                out[parts[1]]["host_blocked_s"] += seconds
        for d in out.values():
            d["host_blocked_s"] = round(d["host_blocked_s"], 4)
            if "stream" in d:
                st = d["stream"]
                st["examples_per_staged_byte"] = (
                    st["examples_processed"] / st["total_bytes"]
                    if st["total_bytes"] else 0.0)
        return out


_STREAM_KEYS = ("passes", "chunks_staged", "total_bytes", "local_epochs",
                "examples_processed", "retries")


def _stream_snapshot(coord) -> Optional[dict]:
    snap = getattr(coord, "stream_snapshot", None)
    return snap() if callable(snap) else None


def _stream_delta(coord, before: Optional[dict]) -> Optional[dict]:
    """Per-visit StreamStats delta of a streamed coordinate (None
    otherwise): the chunk-stream work and bytes THIS visit moved, and the
    derived examples_per_staged_byte."""
    after = _stream_snapshot(coord)
    if after is None:
        return None
    before = before or {}
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in _STREAM_KEYS}
    delta["examples_per_staged_byte"] = (
        delta["examples_processed"] / delta["total_bytes"]
        if delta["total_bytes"] else 0.0)
    return delta


def _data_term(total_scores, base_offsets, labels, weights,
               loss: PointwiseLoss) -> torch.Tensor:
    """Weighted data-loss sum."""
    l = loss.loss(total_scores + base_offsets, labels)
    return torch.sum(l if weights is None else weights * l)


def _sync(spans: PhaseTimings, label: str, *tensors) -> None:  # photonlint: flush-point
    """Wait for the device through one scalar readback per tensor, timed
    as host-blocked."""
    with spans.blocked(label):
        for t in tensors:
            if t is not None and t.numel():
                t.reshape(-1)[-1].item()


def _flush_values(values: List[object]) -> List[float]:  # photonlint: flush-point -- the iteration's one batched read-back of its deferred scalars
    """Host floats of a list of device scalars and host numbers, with one
    copy off the device for all the device scalars (each is widened to
    float64 first, which is exact, so the floats equal `float(t)`)."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    host = (torch.stack([t.reshape(()).to(torch.float64) for t in tensors]).cpu().tolist()
            if tensors else [])
    it = iter(host)
    return [next(it) if isinstance(v, torch.Tensor) else float(v) for v in values]


def _to_host(obj):
    """A copy of a model (or GameModel) whose tensors live on the host: the
    snapshot a background checkpoint write serializes, taken while the
    device is idle at the outer-iteration read-back, so the writer thread
    never reads a device tensor while the next update runs."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, GameModel):
        return GameModel({k: _to_host(m) for k, m in obj.coordinates.items()},
                         obj.task_type)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass
class CheckpointState:
    """One resumable record.  `recovery` documents how the record was
    recovered: {"fallback": bool, "resumed_from_iteration": k, "pruned":
    [paths]}; fallback=True means the primary state.json was missing,
    corrupt or unverifiable and the record came from the newest iter-*
    directory whose manifest verified."""

    completed_iterations: int
    initial_models: Dict[str, object]
    objective_history: List[float]
    validation_history: Dict[str, List[float]]
    best_models: Optional[Dict[str, object]]    # None = same as latest
    best_metric: Optional[float]
    recovery: Optional[dict] = None


# -- crash-safe checkpoint plumbing ------------------------------------------
#
# Write discipline (everything inside the checkpoint directory), the JAX
# package's, so either package resumes the other's records:
#   iter-KKKK/<model files>         save_game_model's npz layout
#   iter-KKKK/record.json           the FULL state record, self-contained
#                                   (relative dir references): the fallback
#                                   unit when state.json is torn
#   iter-KKKK/manifest.json         per-file sizes + sha256, written LAST
#                                   via tmp+rename (+fsync): a directory
#                                   with a verifying manifest is COMPLETE
#   best-KKKK/...                   same manifest discipline
#   state.json                      atomic pointer to the newest record
#                                   (tmp -> fsync -> rename -> dir fsync)
#
# Retention is TWO records: the newest and its predecessor.  Resume order:
# state.json (manifest-verified) -> newest iter-* directory whose manifest
# verifies -> fresh start; stale *.tmp files and orphaned partial
# directories (no or failing manifest, unreferenced) are pruned.


def verify_checkpoint_dir(dirpath: str) -> Tuple[Optional[bool], str]:
    """-> (ok, reason).  ok=True: manifest present and every listed file
    matches size + checksum.  ok=False: torn or corrupt.  ok=None: no
    manifest (a pre-manifest record, or a partial write that died before
    the manifest landed: the caller decides by reference)."""
    mpath = os.path.join(dirpath, "manifest.json")
    if not os.path.isdir(dirpath):
        return False, "missing directory"
    if not os.path.exists(mpath):
        return None, "no manifest"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for rel, want in manifest["files"].items():
            p = os.path.join(dirpath, rel)
            if not os.path.exists(p):
                return False, f"missing file {rel}"
            if os.path.getsize(p) != want["bytes"]:
                return False, f"size mismatch for {rel}"
            if durable.file_sha256(p) != want["sha256"]:
                return False, f"checksum mismatch for {rel}"
    except (OSError, ValueError, KeyError, TypeError) as e:
        return False, f"unreadable manifest ({e})"
    return True, "ok"


def _write_checkpoint(directory: str, iteration: int, model: GameModel,
                      objective_history: List[float],
                      validation_history: Dict[str, List[float]],
                      best_model: GameModel,
                      best_metric: Optional[float],
                      fingerprint: Optional[str]) -> None:
    """Persist the latest model, the best-so-far model and a state record
    after an outer iteration: {dir}/iter-{k:04d}/ and {dir}/best-{k:04d}/
    (save_game_model's layout, each sealed by a manifest.json written LAST)
    and {dir}/state.json, replaced ATOMICALLY after an fsync and LAST, so a
    crash mid-save leaves the previous record intact.  Each iter directory
    also embeds its full state record (record.json), so a torn state.json
    falls back to the newest verified record.  The two newest records are
    retained; older model directories are pruned."""
    from photon_ml_tpu_torch.models.io import save_game_model
    from photon_ml_tpu_torch.parallel import multihost

    # process 0 owns every durable artifact (the descent loop passes no
    # checkpoint directory off the primary; this is defense in depth)
    if not multihost.is_primary():
        return

    faults.fire("checkpoint.write", iteration=iteration)
    try:
        with open(os.path.join(directory, "state.json")) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        prev = None

    path = os.path.join(directory, f"iter-{iteration:04d}")
    save_game_model(model, path)
    # the best-so-far model is only meaningful with validation tracking;
    # without it the final model IS the result
    best_path = None
    if best_metric is not None:
        if (prev is not None and prev.get("best_metric") == best_metric
                and prev.get("best_model_dir")
                and os.path.isdir(prev["best_model_dir"])):
            # best unchanged since the previous record: point at the
            # existing directory instead of re-serializing the model
            best_path = prev["best_model_dir"]
        else:
            best_path = os.path.join(directory, f"best-{iteration:04d}")
            save_game_model(best_model, best_path)
            durable.write_manifest(best_path)
    state = {"completed_iterations": iteration + 1,
             "model_dir": path,
             "best_model_dir": best_path,
             "best_metric": best_metric,
             "config_fingerprint": fingerprint,
             "objective_history": objective_history,
             "validation_history": validation_history}
    # self-contained fallback record: directory references by BASENAME so
    # the record stays valid wherever the checkpoint directory lives
    record = dict(state,
                  model_dir=os.path.basename(path),
                  best_model_dir=(os.path.basename(best_path)
                                  if best_path else None))
    durable.atomic_write_json(os.path.join(path, "record.json"), record,
                              indent=1, fsync=False)  # the manifest fsyncs it
    durable.write_manifest(path)  # seals the iter dir (covers record.json)

    # retention of TWO records: remember the predecessor so resume can
    # fall back past a record whose files turn out corrupt
    state["previous"] = (
        {k: prev.get(k) for k in ("completed_iterations", "model_dir",
                                  "best_model_dir")}
        if prev is not None else None)
    # a "kill" injected at the before_replace hook is the canonical torn
    # checkpoint: the new record is complete and sealed, state.json still
    # points at the old one, and state.json.tmp is left for resume to prune
    durable.atomic_write_json(
        os.path.join(directory, "state.json"), state, indent=1,
        before_replace=lambda: faults.fire("checkpoint.fsync",
                                           iteration=iteration))
    # prune the dirs the GRANDPARENT record referenced; a foreign or
    # corrupt state.json may point anywhere, so only paths inside the
    # checkpoint directory are deleted
    grand = (prev or {}).get("previous") or {}
    keep = {p for p in (path, best_path, (prev or {}).get("model_dir"),
                        (prev or {}).get("best_model_dir")) if p}
    root = os.path.realpath(directory)
    for key in ("model_dir", "best_model_dir"):
        old = grand.get(key)
        if not old or old in keep or not os.path.isdir(old):
            continue
        real = os.path.realpath(old)
        if os.path.commonpath([root, real]) != root or real == root:
            logger.warning(
                "checkpoint state referenced %s outside the checkpoint "
                "directory %s; refusing to prune it", old, directory)
            continue
        shutil.rmtree(real, ignore_errors=True)
    telemetry.counter("checkpoint.written").inc()
    logger.info("checkpoint: iteration %d saved to %s", iteration, path)


class AsyncCheckpointer:
    """Background checkpoint writer: iteration k's models serialize while
    iteration k+1 trains.

      - writes run on ONE worker thread through `_write_checkpoint`, so the
        write-state-last and prune discipline is untouched and records land
        in submission order;
      - keep-latest coalescing: a snapshot superseded before its write
        STARTS is dropped (only the newest record is ever resumed from);
      - durability: after `shutdown()` (called at fit end) the LAST
        submitted iteration is on disk; mid-fit, the newest record is
        whichever submission last finished;
      - a worker failure surfaces at the next submit() or at shutdown(),
        never silently.

    The caller submits host snapshots (`_to_host`), so the worker never
    touches a device tensor."""

    def __init__(self, directory: str):
        self.directory = directory
        self._cv = locktrace.tracked(threading.Condition(),
                                     "AsyncCheckpointer._cv")
        self._pending: Optional[tuple] = None
        self._busy = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="photon-async-checkpoint", daemon=True)
        self._thread.start()

    def submit(self, iteration: int, model: GameModel,
               objective_history: List[float],
               validation_history: Dict[str, List[float]],
               best_model: GameModel, best_metric: Optional[float],
               fingerprint: Optional[str]) -> None:
        """Enqueue one snapshot (the histories are copied here)."""
        snap = (iteration, model, list(objective_history),
                {k: list(v) for k, v in validation_history.items()},
                best_model, best_metric, fingerprint)
        with self._cv:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError(
                    "async checkpoint write failed in the background "
                    "writer") from err
            if self._closed:
                raise RuntimeError("AsyncCheckpointer already shut down")
            if self._pending is not None:
                telemetry.counter("checkpoint.coalesced").inc()
            self._pending = snap
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None:
                    return
                snap, self._pending = self._pending, None
                self._busy = True
            try:
                # the span runs on THIS background thread: checkpoint
                # serialization gets its own track in the trace
                with telemetry.span("checkpoint_write", iteration=snap[0]):
                    _write_checkpoint(self.directory, *snap)
            except BaseException as e:  # surfaced at submit/shutdown
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def shutdown(self, raise_errors: bool = True) -> None:
        """Drain the queue (the final snapshot always writes), stop the
        worker, and re-raise any worker failure at once: the fit-end record
        is part of the fit's durability contract.  Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            while self._pending is not None or self._busy:
                self._cv.wait()
        self._thread.join()
        if raise_errors and self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed: the final fit-end record "
                "did not persist") from err


def _prune_stale_tmp(directory: str) -> List[str]:
    """Remove *.tmp files a kill during a write left behind
    (state.json.tmp, manifest.json.tmp, ...)."""
    pruned = []
    if not os.path.isdir(directory):
        return pruned
    for root, _, names in os.walk(directory):
        for fn in names:
            if fn.endswith(".tmp"):
                p = os.path.join(root, fn)
                try:
                    os.remove(p)  # photonlint: all-process
                    pruned.append(p)
                except OSError:
                    pass
    if pruned:
        logger.warning("checkpoint at %s: pruned %d stale tmp file(s) left "
                       "by an interrupted write: %s", directory, len(pruned),
                       pruned)
    return pruned


def _checkpoint_record_dirs(directory: str):
    """iter-*/best-* subdirectories, newest first."""
    out = []
    for fn in os.listdir(directory):
        if fn.startswith(("iter-", "best-")):
            p = os.path.join(directory, fn)
            if os.path.isdir(p):
                out.append(p)
    return sorted(out, reverse=True)


def _prune_orphan_dirs(directory: str, keep: set) -> List[str]:
    """Remove iter-*/best-* directories that are partial writes: not
    referenced by the record being resumed and lacking a VERIFYING
    manifest.  Verified but unreferenced directories (a record sealed right
    before a kill at the fsync) are kept: they are complete, and the re-run
    of their iteration overwrites them."""
    pruned = []
    for p in _checkpoint_record_dirs(directory):
        if os.path.realpath(p) in keep:
            continue
        ok, reason = verify_checkpoint_dir(p)
        if ok is True:
            continue
        shutil.rmtree(p, ignore_errors=True)  # photonlint: all-process
        pruned.append(p)
        logger.warning("checkpoint at %s: pruned orphaned partial write %s "
                       "(%s)", directory, p, reason)
    return pruned


def _state_to_checkpoint(directory: str, state: dict, relative: bool,
                         recovery: dict, device, dtype
                         ) -> Optional[CheckpointState]:
    """Load the models a (top-level or embedded) state record references
    onto `device` in `dtype`.  `relative` resolves the model directories
    against the checkpoint directory (record.json stores basenames)."""
    from photon_ml_tpu_torch.models.io import load_game_model

    def resolve(p):
        return os.path.join(directory, p) if relative else p

    try:
        model, _ = load_game_model(resolve(state["model_dir"]), device=device,
                                   dtype=dtype)
        best = None
        if state.get("best_model_dir"):
            best_dir = resolve(state["best_model_dir"])
            ok, reason = verify_checkpoint_dir(best_dir)
            if ok is False:
                logger.warning(
                    "checkpoint best-model directory %s failed verification "
                    "(%s); resuming without best-model restoration",
                    best_dir, reason)
            else:
                best_model, _ = load_game_model(best_dir, device=device,
                                                dtype=dtype)
                best = dict(best_model.coordinates)
        return CheckpointState(
            completed_iterations=int(state["completed_iterations"]),
            initial_models=dict(model.coordinates),
            objective_history=list(state["objective_history"]),
            validation_history={k: list(v) for k, v in
                                state.get("validation_history", {}).items()},
            best_models=best,
            best_metric=state.get("best_metric"),
            recovery=recovery)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        logger.warning("checkpoint record in %s unreadable (%s)",
                       directory, e)
        return None


def _note_recovery(recovery: dict) -> None:
    """Publish a successful checkpoint recovery: counters always, a run-log
    event when the tracer is armed (correlated by span id with whatever
    stage triggered the resume)."""
    telemetry.counter("checkpoint.recoveries").inc()
    if recovery.get("fallback"):
        telemetry.counter("checkpoint.recovery_fallbacks").inc()
    telemetry.event(
        "checkpoint_recovery", fallback=recovery.get("fallback"),
        resumed_from_iteration=recovery.get("resumed_from_iteration"),
        pruned=len(recovery.get("pruned") or ()))


def _fingerprint_mismatch(state: dict, fingerprint: Optional[str],
                          directory: str) -> bool:
    recorded = state.get("config_fingerprint")
    if fingerprint is not None and recorded is not None \
            and recorded != fingerprint:
        logger.warning(
            "checkpoint at %s was written under a different training "
            "configuration (fingerprint %s != %s); starting fresh",
            directory, recorded, fingerprint)
        return True
    return False


def read_checkpoint(directory: str,
                    fingerprint: Optional[str] = None, *,
                    device=None, dtype: torch.dtype = torch.float32
                    ) -> Optional[CheckpointState]:
    """The resume half of the checkpoint flow, fault-contained:

      1. prune stale *.tmp files left by a kill during a write;
      2. resume from state.json IF its model directories verify against
         their size+checksum manifests (a record without manifests is
         accepted with a note);
      3. otherwise FALL BACK to the newest iter-* directory whose manifest
         verifies, using its embedded record.json, and prune orphaned
         partial writes;
      4. otherwise: no checkpoint (better to retrain than to crash).

    `fingerprint` guards against resuming under a CHANGED configuration:
    a record written with another coordinate or optimization config (the
    outer iteration count excluded: raising it is the intended resume use)
    is refused with a warning.  The models load onto `device` (None means
    cuda) in `dtype`.  Records written by the JAX package load too."""
    dev = resolve_device(device)
    state_path = os.path.join(directory, "state.json")
    if not os.path.isdir(directory):
        return None
    pruned = _prune_stale_tmp(directory)

    state = None
    try:
        with open(state_path) as f:
            state = json.load(f)
    except OSError:
        state = None  # no checkpoint yet (or unreadable): try the fallback
    except ValueError as e:
        logger.warning("checkpoint at %s unreadable (%s); trying verified "
                       "fallback", directory, e)
        state = None

    if state is not None:
        if _fingerprint_mismatch(state, fingerprint, directory):
            return None
        ok, reason = verify_checkpoint_dir(state.get("model_dir") or "")
        if ok is None:
            logger.info("checkpoint at %s carries no manifest; resuming "
                        "unverified", directory)
        if ok is not False:
            result = _state_to_checkpoint(
                directory, state, relative=False,
                recovery={"fallback": False, "pruned": pruned,
                          "resumed_from_iteration":
                              int(state.get("completed_iterations", 0)) - 1},
                device=dev, dtype=dtype)
            if result is not None:
                keep = {os.path.realpath(p) for p in
                        (state.get("model_dir"), state.get("best_model_dir"),
                         *(((state.get("previous") or {}).get(k)) for k in
                           ("model_dir", "best_model_dir")))
                        if p}
                result.recovery["pruned"] += _prune_orphan_dirs(directory,
                                                                keep)
                _note_recovery(result.recovery)
                return result
            logger.warning("checkpoint at %s: primary record unusable; "
                           "trying verified fallback", directory)
        else:
            logger.warning(
                "checkpoint at %s: model directory %s failed manifest "
                "verification (%s); trying verified fallback", directory,
                state.get("model_dir"), reason)

    # fallback: newest iter-* directory with a verifying manifest and an
    # embedded record
    for p in _checkpoint_record_dirs(directory):
        if not os.path.basename(p).startswith("iter-"):
            continue
        ok, _ = verify_checkpoint_dir(p)
        if ok is not True:
            continue
        try:
            with open(os.path.join(p, "record.json")) as f:
                record = json.load(f)
        except (OSError, ValueError):
            continue  # no embedded record: cannot self-resume
        if _fingerprint_mismatch(record, fingerprint, directory):
            return None
        result = _state_to_checkpoint(
            directory, record, relative=True,
            recovery={"fallback": True, "pruned": pruned,
                      "resumed_from_iteration":
                          int(record.get("completed_iterations", 0)) - 1},
            device=dev, dtype=dtype)
        if result is None:
            continue
        keep = {os.path.realpath(p)}
        if record.get("best_model_dir"):
            keep.add(os.path.realpath(
                os.path.join(directory, record["best_model_dir"])))
        result.recovery["pruned"] += _prune_orphan_dirs(directory, keep)
        logger.warning(
            "checkpoint at %s: fell back to verified record %s "
            "(completed_iterations=%d)", directory, os.path.basename(p),
            result.completed_iterations)
        _note_recovery(result.recovery)
        return result

    if state is not None or _checkpoint_record_dirs(directory):
        logger.warning("checkpoint at %s has no verifiable record; "
                       "starting fresh", directory)
        _prune_orphan_dirs(directory, set())
    return None


def run_coordinate_descent(
    coordinates: Dict[str, Coordinate],
    updating_sequence: Sequence[str],
    num_iterations: int,
    dataset: GameDataset,
    task_type: str,
    validation_dataset: Optional[GameDataset] = None,
    validation_specs: Sequence[ValidationSpec] = (),
    initial_models: Optional[Dict[str, object]] = None,
    timings: Optional[PhaseTimings] = None,
    timing_mode: str = "pipelined",
    device=None,
    dtype: torch.dtype = torch.float32,
    checkpoint_dir: Optional[str] = None,
    resume: Optional[CheckpointState] = None,
    checkpoint_fingerprint: Optional[str] = None,
    solver_schedules: Optional[Dict[str, object]] = None,
    residency=None,
) -> CoordinateDescentResult:
    """reference: CoordinateDescent.run/optimize (scala:57-385).

    `timing_mode`:
      - "pipelined" (default): per-update objectives, validation metrics
        and health flags stay device scalars, read back in ONE batched copy
        per outer iteration (the flush, timed as the span "{it}/flush");
        tracker summaries, best-model tracking and quarantine containment
        happen there, and checkpoints are written by a background thread.
      - "strict": every update syncs before the next begins, so the spans
        are attributable to the device work they launched.
    The math is identical: histories and models match bit for bit.  The
    flat [n] vectors live on `device` (None means cuda) in `dtype`.
    Validation metrics with a device form are computed on the device;
    grouped and custom metrics on the host, in both modes.

    `checkpoint_dir` persists the latest and best-so-far models and a state
    record after every outer iteration; `resume` (a CheckpointState from
    read_checkpoint) continues from such a record.  `solver_schedules`
    ({coordinate name -> optim/schedule.py SolverSchedule or None}) caps
    each visit's solves; the budget each solve ran under lands in its
    tracker.  Scheduling is pure arithmetic in (outer iteration,
    num_iterations), so a resume reproduces the trajectory.

    `residency` (a game/residency.py ResidencyManager) rotates device
    residency under an HBM budget: after a coordinate's update, score,
    objective and validation rescore, its device blocks are evicted and
    the next visit copies them again from the host.  The flat [n] score
    vectors stay on the device.  Without a budget the manager only keeps
    byte accounts."""
    if timing_mode not in ("pipelined", "strict"):
        raise ValueError(f"timing_mode must be 'pipelined' or 'strict', "
                         f"got {timing_mode!r}")
    pipelined = timing_mode == "pipelined"
    dev = resolve_device(device)
    # mesh transfer accounting: per-visit staged-bytes deltas (host ints)
    mesh_snap = None
    if any(getattr(c, "mesh", None) is not None for c in coordinates.values()):
        from photon_ml_tpu_torch.parallel.mesh_residency import transfer_snapshot
        mesh_snap = transfer_snapshot
    if checkpoint_dir is not None:
        from photon_ml_tpu_torch.parallel import multihost
        if not multihost.is_primary():
            # one writer: every process runs this loop in lockstep, and N
            # processes racing one state.json replace would corrupt it;
            # the others resume from process 0's records on relaunch
            logger.info("multihost: process %d skips checkpoint writes "
                        "(process 0 owns %s)", multihost.process_index(),
                        checkpoint_dir)
            checkpoint_dir = None

    def staged_delta(before):
        if before is None:
            return None
        after = mesh_snap()
        return {"cold": after["cold_bytes"] - before["cold_bytes"],
                "warm": after["warm_bytes"] - before["warm_bytes"]}
    loss = TASK_LOSSES[task_type]
    on_dev = lambda a: (None if a is None else torch.as_tensor(a).to(
        device=dev, dtype=dtype))
    spans = PhaseTimings() if timings is None else timings
    with spans.span("init/transfer"):
        labels = on_dev(dataset.response)
        weights = on_dev(dataset.weights)
        base_offsets = (torch.zeros(dataset.num_rows, dtype=dtype, device=dev)
                        if dataset.offsets is None else on_dev(dataset.offsets))
        _sync(spans, "init/transfer", labels, weights, base_offsets)

    # per-coordinate regularization terms as device scalars, recomputed only
    # for the updated coordinate
    reg_terms: Dict[str, object] = {}

    def objective(total_scores) -> torch.Tensor:
        return (_data_term(total_scores, base_offsets, labels, weights, loss)
                + sum(reg_terms.values()))

    # a resume record overrides the initial models and restores the
    # histories and best-model tracking
    start_iteration = 0
    if resume is not None and resume.completed_iterations > num_iterations:
        logger.warning(
            "checkpoint covers %d outer iterations but this fit requests "
            "only %d; ignoring the checkpoint (delete it to silence this)",
            resume.completed_iterations, num_iterations)
        resume = None
    if resume is not None:
        start_iteration = min(resume.completed_iterations, num_iterations)
        if initial_models:
            logger.warning("resuming from a checkpoint: the provided "
                           "initial/warm-start models are superseded by the "
                           "checkpointed models")
        initial_models = resume.initial_models

    # factored coordinates that start from their cold default model take
    # their projection from a sibling plain random effect's solution at
    # their first visit (by then the sibling has been fit this iteration);
    # provided and resumed models are never overridden
    cold_factored: set = set()
    warm_starts: Dict[str, str] = {}
    with spans.span("init/score"):
        zeros = torch.zeros(dataset.num_rows, dtype=dtype, device=dev)
        models, scores = {}, {}
        for name in updating_sequence:
            provided = (initial_models or {}).get(name)
            if provided is None:
                # zero-coefficient initial models score exactly zero; their
                # regularization is zero too, except a factored
                # coordinate's, whose Gaussian projection carries the
                # latent problem's penalty
                factored = hasattr(coordinates[name], "warm_start_latent")
                if factored:
                    cold_factored.add(name)
                models[name] = coordinates[name].initial_model()
                scores[name] = zeros
                reg_terms[name] = (coordinates[name].regularization_term(models[name])
                                   if factored else 0.0)
            else:
                if residency is not None:
                    residency.before_update(name)
                models[name] = provided
                scores[name] = coordinates[name].score(provided)
                reg_terms[name] = coordinates[name].regularization_term(provided)
                if residency is not None:
                    # warm-start scoring touched this coordinate's blocks;
                    # under budget pressure they drop until its first visit
                    residency.after_update(name)
        total = sum(scores.values(), zeros)
        if not pipelined:
            _sync(spans, "init/score", total)

    objective_history: List[float] = list(
        resume.objective_history if resume is not None else [])
    validation_history: Dict[str, List[float]] = {
        s.name: list((resume.validation_history if resume is not None
                      else {}).get(s.name, [])) for s in validation_specs}
    trackers: Dict[str, TrackerSummary] = {}
    best_model = GameModel(dict(models), task_type)
    best_metric: Optional[float] = None
    if resume is not None and resume.best_metric is not None:
        best_metric = resume.best_metric
        if resume.best_models is not None:
            best_model = GameModel(dict(resume.best_models), task_type)

    do_validation = validation_dataset is not None and bool(validation_specs)
    val_scores_by_coord: Dict[str, torch.Tensor] = {}
    if do_validation:
        with spans.span("init/validation_score"):
            val_zeros = torch.zeros(validation_dataset.num_rows, dtype=dtype, device=dev)
            val_scores_by_coord = {
                name: (val_zeros if (initial_models or {}).get(name) is None
                       else models[name].score_dataset(validation_dataset))
                for name in updating_sequence}
            val_labels = on_dev(validation_dataset.response)
            val_weights = on_dev(validation_dataset.weights)
            val_offsets = on_dev(validation_dataset.offsets)
            if not pipelined:
                _sync(spans, "init/validation_score", *val_scores_by_coord.values())

    def evaluate(spec: ValidationSpec, val_total: torch.Tensor, label: str):
        """One validation metric: a device scalar where the metric has a
        device form (read back at once in strict mode), else a host float
        (the scores' copy to the host timed as host-blocked)."""
        device_eval = getattr(spec.evaluator, "evaluate_on_device", None)
        if spec.group_column is None and device_eval is not None:
            s = val_total if val_offsets is None else val_total + val_offsets
            v = device_eval(s, val_labels, val_weights)
            if v is not None:
                if pipelined:
                    return v
                with spans.blocked(label):
                    return float(v)
        with spans.blocked(label):
            return spec.evaluate(validation_dataset, val_total)

    def record(obj: float, metric_vals: Sequence[float],
               snapshot: Dict[str, object], healthy: bool = True) -> None:
        """History appends and best-model tracking for one update (a
        rolled-back update never becomes the best model)."""
        nonlocal best_metric, best_model
        objective_history.append(obj)
        for k, (spec, v) in enumerate(zip(validation_specs, metric_vals)):
            validation_history[spec.name].append(v)
            if k == 0 and healthy and (best_metric is None
                                       or spec.evaluator.better_than(v, best_metric)):
                # best FULL model by the first evaluator (ref 294-335)
                best_metric = v
                best_model = GameModel(dict(snapshot), task_type)

    # non-finite solve quarantine (game/quarantine.py): the device-side
    # guard already rolled a NaN/Inf solve back when it happened; the
    # monitor applies the host-side policy (one tightened retry, else a
    # freeze) when the health flags land
    monitor = quarantine_mod.QuarantineMonitor()

    def host_rollback(name: str, prev_model) -> None:
        """Rare path: finite coefficients but a non-finite objective (data
        term overflow).  The device-side guard passed the model through,
        so roll the coordinate back here and recompute its score."""
        nonlocal total
        coord = coordinates[name]
        if residency is not None:
            residency.before_update(name)
        models[name] = prev_model
        sc = coord.score(prev_model)
        total = (total - scores[name]) + sc
        scores[name] = sc
        reg_terms[name] = coord.regularization_term(prev_model)
        if residency is not None:
            residency.after_update(name)

    def quarantine_rerun(it: int, name: str) -> bool:
        """The ONE tightened-budget retry after a rollback, run where the
        divergence is discovered (the outer-iteration boundary in
        pipelined mode); its small health read-back is the rare path."""
        nonlocal total
        coord = coordinates[name]
        if residency is not None:
            residency.before_update(name)
        partial = total - scores[name]
        new_model, _ = coord.update(
            models[name], base_offsets + partial,
            schedule=QuarantineRetrySchedule(), outer_iteration=it,
            num_outer_iterations=num_iterations)
        guarded, flag = quarantine_mod.guard(new_model, models[name])
        sc = coord.score(guarded)
        new_total = partial + sc
        old_reg = reg_terms[name]
        reg_terms[name] = coord.regularization_term(guarded)
        obj_dev = objective(new_total)
        ok_v, obj_v = _flush_values(
            [quarantine_mod.combine_health(flag, obj_dev), obj_dev])
        ok = bool(ok_v)
        if ok:
            models[name] = guarded
            scores[name] = sc
            total = new_total
            monitor.on_retry_result(it, name, True, obj_v)
        else:
            reg_terms[name] = old_reg
            monitor.on_retry_result(it, name, False)
        if residency is not None:
            residency.after_update(name)
        return ok

    def contain(it: int, name: str) -> str:
        """Apply the quarantine policy once an unhealthy flag is on the
        host; the containment label for the visit's tracker."""
        if monitor.on_divergence(it, name) == "retry":
            return "retry_ok" if quarantine_rerun(it, name) else "frozen"
        return "frozen"

    # pipelined mode: per-update records awaiting the boundary readback
    pending: List[dict] = []

    def flush_pending() -> None:  # photonlint: flush-point
        """ONE copy off the device for every objective, health flag and
        metric of the outer iteration, then the deferred host bookkeeping
        and the quarantine containment."""
        values = iter(_flush_values([v for p in pending for v in
                                     [p["objective"], p["health"], *p["metrics"]]]))
        divergent = []
        for p in pending:
            obj, health = next(values), next(values)
            metric_vals = [next(values) for _ in p["metrics"]]
            healthy = bool(health)
            key = f"{p['it']}/{p['name']}"
            if not healthy:
                if not math.isfinite(obj):
                    # finite coefficients, non-finite objective: roll back
                    # on the host and log the pre-update objective
                    host_rollback(p["name"], p["prev_model"])
                    obj = float(objective(total))
                divergent.append(p)
            trackers[key] = _summarize(p["result"], spans[p["solve_key"]],
                                       p["buckets"], p["budget"])
            trackers[key].containment = ("rolled_back" if not healthy
                                         else p["containment"])
            trackers[key].stream = p["stream"]
            trackers[key].retraces = p["retraces"]
            trackers[key].staged_bytes = p["staged"]
            record(obj, metric_vals, p["models"], healthy)
        pending.clear()
        # containment AFTER the iteration's bookkeeping: the retry runs at
        # the boundary, not inside any one entry's slot in the history
        for p in divergent:
            trackers[f"{p['it']}/{p['name']}"].containment = contain(p["it"], p["name"])

    checkpointer: Optional[AsyncCheckpointer] = None
    # the host copy of best_model last submitted, and the metric it had:
    # best_model changes only with best_metric, so an unchanged metric
    # reuses the copy
    host_best: Optional[Tuple[Optional[float], GameModel]] = None

    def preempt(completed: int):
        """Graceful-preemption exit: the in-flight update is finished; make
        the newest checkpoint record durable, then raise the resumable
        signal (cli.train maps it to exit 75)."""
        nonlocal checkpointer
        logger.warning("graceful preemption: stopping after %d completed "
                       "outer iteration(s)", completed)
        if checkpointer is not None:
            with spans.span("checkpoint/join"):
                checkpointer.shutdown(raise_errors=True)
            checkpointer = None
        raise faults.Preempted(
            completed, checkpoint_dir is not None and completed > 0,
            checkpoint_dir)

    loop_ok = False
    try:
        for it in range(start_iteration, num_iterations):
            # the trace's outer_iteration -> coordinate_visit ->
            # solve/objective/validation spans; push/pop keeps the loop
            # body as it is, and an exception path (Preempted, a fatal
            # staging error) leaves them open for Tracer.finish() to heal
            it_span = telemetry.push("outer_iteration", iteration=it)
            for name in updating_sequence:
                visit_span = telemetry.push("coordinate_visit",
                                            coordinate=name, iteration=it)
                retraces0 = (telemetry.retrace_count() if telemetry.armed()
                             else None)
                coord = coordinates[name]
                solve_key = f"{it}/{name}/solve"
                frozen = monitor.is_frozen(name)
                prev_model = models[name]
                sched = (solver_schedules or {}).get(name)
                budget = None
                if sched is not None and not frozen:
                    base = coord.config.optimization.optimizer.resolved()
                    budget = sched.plan(it, num_iterations, base.max_iterations,
                                        base.tolerance)
                result = None
                health = None
                stream_before = _stream_snapshot(coord)
                mesh_before = mesh_snap() if mesh_snap is not None else None
                with spans.span(solve_key, name="solve", coordinate=name,
                                iteration=it):
                    if not frozen:
                        if residency is not None:
                            residency.before_update(name)
                        if name in cold_factored:
                            cold_factored.discard(name)
                            warm = coord.warm_start_latent(models[name], models)
                            if warm is not None:
                                models[name] = warm
                                prev_model = warm
                                warm_starts[name] = coord.warm_start_source
                        # partial = full - own (reference line 186-193)
                        partial = total - scores[name]
                        new_model, result = coord.update(
                            models[name], base_offsets + partial,
                            schedule=sched, outer_iteration=it,
                            num_outer_iterations=num_iterations)
                        if faults.fire("solve.poison", coordinate=name,
                                       iteration=it) == "poison":
                            new_model = quarantine_mod.poison_model(new_model)
                        # device-side containment: a non-finite solve rolls
                        # back to the last good coefficients here, so later
                        # coordinates never see poisoned scores; the flag
                        # rides the boundary read-back
                        models[name], health = quarantine_mod.guard(new_model,
                                                                    prev_model)
                        scores[name] = coord.score(models[name])
                        total = partial + scores[name]
                    if not pipelined:
                        _sync(spans, solve_key, total)
                buckets = getattr(coord, "last_buckets", None) if not frozen else None
                key = f"{it}/{name}"
                if not pipelined:
                    trackers[key] = _summarize(result, spans[solve_key], buckets, budget)
                    if frozen:
                        trackers[key].containment = "frozen"

                obj_key = f"{it}/{name}/objective"
                with spans.span(obj_key, name="objective", coordinate=name,
                                iteration=it):
                    if not frozen:
                        reg_terms[name] = coord.regularization_term(models[name])
                    obj_dev = objective(total)
                    health_dev = (True if health is None else
                                  quarantine_mod.combine_health(health, obj_dev))
                    if not pipelined:
                        with spans.blocked(obj_key):
                            obj = float(obj_dev)
                            # strict mode reads back per update by design
                            healthy = health_dev is True or bool(health_dev)  # photonlint: disable=PH001
                if not pipelined and not healthy:
                    if not math.isfinite(obj):
                        host_rollback(name, prev_model)
                        obj = float(objective(total))
                    trackers[key].containment = contain(it, name)

                metrics: List[object] = []
                if do_validation:
                    val_key = f"{it}/{name}/validation"
                    with spans.span(val_key, name="validation",
                                    coordinate=name, iteration=it):
                        val_scores_by_coord[name] = \
                            models[name].score_dataset(validation_dataset)
                        val_total = sum(val_scores_by_coord.values(), val_zeros)
                        metrics = [evaluate(spec, val_total, val_key)
                                   for spec in validation_specs]
                if residency is not None:
                    # update, own score, objective and the validation rescore
                    # (which reads the validation dataset's shards) are all
                    # launched: under budget pressure this coordinate's
                    # training blocks drop now; queued kernels keep theirs
                    residency.after_update(name)
                stream = _stream_delta(coord, stream_before)
                staged = staged_delta(mesh_before)
                # kernel loads during this visit: a library loads when a
                # wrapper first launches its kernel, so the count is
                # settled here in pipelined mode too
                retraces = (telemetry.retrace_count() - retraces0
                            if retraces0 is not None else None)
                if pipelined:
                    pending.append({"it": it, "name": name,
                                    "solve_key": solve_key, "result": result,
                                    "buckets": buckets, "budget": budget,
                                    "objective": obj_dev, "health": health_dev,
                                    "metrics": metrics, "models": dict(models),
                                    "prev_model": prev_model, "stream": stream,
                                    "retraces": retraces, "staged": staged,
                                    "containment": "frozen" if frozen else None})
                else:
                    trackers[key].stream = stream
                    trackers[key].retraces = retraces
                    trackers[key].staged_bytes = staged
                    record(obj, metrics, models)
                telemetry.pop(visit_span)

                if faults.preemption_requested() and name != updating_sequence[-1]:
                    # the in-flight update is done: settle the iteration's
                    # device scalars, then exit resumably (the newest
                    # durable record covers the completed iterations; this
                    # partial iteration retrains)
                    if pipelined:
                        with spans.span(f"{it}/flush", host_blocked=True,
                                        name="flush", iteration=it):
                            flush_pending()
                    preempt(it)
            if pipelined:
                # outer-iteration boundary: the one host sync of the iteration
                with spans.span(f"{it}/flush", host_blocked=True,
                                name="flush", iteration=it):
                    flush_pending()

            if checkpoint_dir is not None:
                with spans.span(f"{it}/checkpoint", name="checkpoint",
                                iteration=it):
                    ckpt_model = GameModel(dict(models), task_type)
                    if pipelined:
                        # host snapshots, taken while the device is idle
                        # after the flush: the writer thread never reads a
                        # device tensor
                        if checkpointer is None:
                            checkpointer = AsyncCheckpointer(checkpoint_dir)
                        if host_best is None or host_best[0] != best_metric:
                            host_best = (best_metric, _to_host(best_model))
                        checkpointer.submit(it, _to_host(ckpt_model),
                                            objective_history, validation_history,
                                            host_best[1], best_metric,
                                            checkpoint_fingerprint)
                    else:
                        _write_checkpoint(checkpoint_dir, it, ckpt_model,
                                          objective_history, validation_history,
                                          best_model, best_metric,
                                          checkpoint_fingerprint)
            telemetry.pop(it_span)
            if faults.preemption_requested():
                # iteration boundary: this iteration's record is submitted
                # (pipelined) or on disk (strict): drain and exit
                preempt(it + 1)
        loop_ok = True
    finally:
        if checkpointer is not None:
            # drain and stop the writer; on the success path a worker
            # failure must surface, on an exception path it must not mask
            # the original error
            with spans.span("checkpoint/join"):
                checkpointer.shutdown(raise_errors=loop_ok)

    if (do_validation and resume is not None and start_iteration >= num_iterations
            and any(not validation_history[s.name] for s in validation_specs)):
        # resumed past the last iteration and the record lacks metrics for
        # some spec: evaluate the restored model once for those specs
        val_total = sum(val_scores_by_coord.values(), val_zeros)
        for k, spec in enumerate(validation_specs):
            if validation_history[spec.name]:
                continue
            v = spec.evaluate(validation_dataset, val_total)
            validation_history[spec.name].append(v)
            if k == 0 and (best_metric is None
                           or spec.evaluator.better_than(v, best_metric)):
                best_metric = v
                best_model = GameModel(dict(models), task_type)

    # host-blocked accounting into the registry: host floats only
    wall = spans.total()
    blocked = spans.host_blocked_total()
    telemetry.gauge("train.host_blocked_s").set(round(blocked, 4))
    telemetry.gauge("train.host_blocked_frac").set(
        round(blocked / wall, 6) if wall > 0 else 0.0)

    final = GameModel(dict(models), task_type)
    if not do_validation:
        best_model = final
    return CoordinateDescentResult(
        model=final, best_model=best_model,
        objective_history=objective_history,
        validation_history=validation_history, timings=spans,
        trackers=trackers, warm_starts=warm_starts,
        containment_events=monitor.events,
        frozen_coordinates=monitor.frozen)
