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
order, so their histories are equal bit for bit.  Checkpoints and resume
and non-finite-solve quarantine (ROADMAP.md queue A item 14; the JAX
package interleaves the checkpoint writer and the quarantine monitor with
the pipelined flush), device residency under an HBM budget (item 15),
solver schedules (item 16) and the multi-host wait (item 20) are not
ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator, MultiEvaluator
from photon_ml_tpu_torch.game.coordinates import Coordinate
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.ops.losses import TASK_LOSSES, PointwiseLoss
from photon_ml_tpu_torch.optim.types import ConvergenceReason


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


class PhaseTimings(dict):
    """Contiguous per-fit span accounting: label -> seconds.  Spans are
    contiguous over the descent loop, so their sum accounts for the fit's
    wall clock.  `host_blocked` holds, per label, the seconds the host spent
    waiting on device readbacks."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_blocked: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[label] = self.get(label, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def blocked(self, label: str):
        """Time a host-blocking readback into `host_blocked` without opening
        a new accounting span."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_blocked(label, time.perf_counter() - t0)

    def add_blocked(self, label: str, seconds: float) -> None:
        self.host_blocked[label] = self.host_blocked.get(label, 0.0) + seconds

    def host_blocked_total(self) -> float:
        return float(sum(self.host_blocked.values()))

    def total(self) -> float:
        return float(sum(self.values()))


@dataclasses.dataclass
class TrackerSummary:
    """Host-side per-solve record: iterations (summed over entities for a
    batched solve), value+gradient passes of LBFGS/OWLQN (`fg_count`,
    likewise; None under TRON) or Hessian-vector products of TRON
    (`hv_count`, likewise; None otherwise), the solve's wall clock and
    ConvergenceReason counts over its lanes.  A factored random effect's
    update sums its latent-space and projection-refit solves."""

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


def _summarize(result, wall_s: float, buckets=None) -> TrackerSummary:
    """A solve's summary; a factored update's two solves (the latent-space
    and the projection refit of its last inner iteration) merged."""
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
                          hv_count=total("hv_count"), inner=getattr(result, "inner", None))


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

    def total_iterations(self) -> int:
        return sum(t.iterations for t in self.trackers.values())

    def solver_diagnostics(self) -> Dict[str, dict]:
        """Per-coordinate solver totals for the fit summary, in the JAX
        package's shape: solve count, inner iterations, ConvergenceReason
        counts, the iteration cap of each visit (None: a full solve; the
        port has no solver schedules yet), containment outcomes (none: the
        port has no quarantine yet) and the host-blocked seconds of the
        coordinate's spans; beyond the JAX package's keys, the
        value+gradient passes (each one launch of the fixed effect's
        kernel on the card)."""
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
            d["iteration_caps"].append(None)
            for name, c in t.reasons.items():
                d["reasons"][name] = d["reasons"].get(name, 0) + c
        for label, seconds in self.timings.host_blocked.items():
            parts = label.split("/")
            if len(parts) == 3 and parts[1] in out:
                out[parts[1]]["host_blocked_s"] += seconds
        for d in out.values():
            d["host_blocked_s"] = round(d["host_blocked_s"], 4)
        return out


def _data_term(total_scores, base_offsets, labels, weights,
               loss: PointwiseLoss) -> torch.Tensor:
    """Weighted data-loss sum."""
    l = loss.loss(total_scores + base_offsets, labels)
    return torch.sum(l if weights is None else weights * l)


def _sync(spans: PhaseTimings, label: str, *tensors) -> None:
    """Wait for the device through one scalar readback per tensor, timed
    as host-blocked."""
    with spans.blocked(label):
        for t in tensors:
            if t is not None and t.numel():
                t.reshape(-1)[-1].item()


def _flush_values(values: List[object]) -> List[float]:
    """Host floats of a list of device scalars and host numbers, with one
    copy off the device for all the device scalars (each is widened to
    float64 first, which is exact, so the floats equal `float(t)`)."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    host = (torch.stack([t.reshape(()).to(torch.float64) for t in tensors]).cpu().tolist()
            if tensors else [])
    it = iter(host)
    return [next(it) if isinstance(v, torch.Tensor) else float(v) for v in values]


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
) -> CoordinateDescentResult:
    """reference: CoordinateDescent.run/optimize (scala:57-385).

    `timing_mode`:
      - "pipelined" (default): per-update objectives and validation metrics
        stay device scalars, read back in ONE batched copy per outer
        iteration (the flush, timed as the span "{it}/flush"); tracker
        summaries and best-model tracking happen there.
      - "strict": every update syncs before the next begins, so the spans
        are attributable to the device work they launched.
    The math is identical: histories and models match bit for bit.  The
    flat [n] vectors live on `device` (None means cuda) in `dtype`.
    Validation metrics with a device form are computed on the device;
    grouped and custom metrics on the host, in both modes.
    `checkpoint_dir` (checkpoints and resume) is ROADMAP.md queue A item
    14 and raises."""
    if timing_mode not in ("pipelined", "strict"):
        raise ValueError(f"timing_mode must be 'pipelined' or 'strict', "
                         f"got {timing_mode!r}")
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoints and resume are not ported yet (ROADMAP.md queue A "
            "item 14)")
    pipelined = timing_mode == "pipelined"
    dev = resolve_device(device)
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

    # factored coordinates that start from their cold default model take
    # their projection from a sibling plain random effect's solution at
    # their first visit (by then the sibling has been fit this iteration);
    # provided models are never overridden
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
                models[name] = provided
                scores[name] = coordinates[name].score(provided)
                reg_terms[name] = coordinates[name].regularization_term(provided)
        total = sum(scores.values(), zeros)
        if not pipelined:
            _sync(spans, "init/score", total)

    objective_history: List[float] = []
    validation_history: Dict[str, List[float]] = {s.name: [] for s in validation_specs}
    trackers: Dict[str, TrackerSummary] = {}
    best_model = GameModel(dict(models), task_type)
    best_metric: Optional[float] = None

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
               snapshot: Dict[str, object]) -> None:
        """History appends and best-model tracking for one update."""
        nonlocal best_metric, best_model
        objective_history.append(obj)
        for k, (spec, v) in enumerate(zip(validation_specs, metric_vals)):
            validation_history[spec.name].append(v)
            if k == 0 and (best_metric is None
                           or spec.evaluator.better_than(v, best_metric)):
                # best FULL model by the first evaluator (ref 294-335)
                best_metric = v
                best_model = GameModel(dict(snapshot), task_type)

    # pipelined mode: per-update records awaiting the boundary readback
    pending: List[dict] = []

    def flush_pending() -> None:
        """ONE copy off the device for every objective and metric of the
        outer iteration, then the deferred host bookkeeping."""
        values = iter(_flush_values([v for p in pending
                                     for v in [p["objective"], *p["metrics"]]]))
        for p in pending:
            row = [next(values) for _ in range(1 + len(p["metrics"]))]
            trackers[p["key"]] = _summarize(p["result"], spans[p["solve_key"]],
                                            p["buckets"])
            record(row[0], row[1:], p["models"])
        pending.clear()

    for it in range(num_iterations):
        for name in updating_sequence:
            coord = coordinates[name]
            solve_key = f"{it}/{name}/solve"
            with spans.span(solve_key):
                if name in cold_factored:
                    cold_factored.discard(name)
                    warm = coord.warm_start_latent(models[name], models)
                    if warm is not None:
                        models[name] = warm
                        warm_starts[name] = coord.warm_start_source
                # partial = full - own (reference line 186-193)
                partial = total - scores[name]
                models[name], result = coord.update(models[name],
                                                    base_offsets + partial)
                scores[name] = coord.score(models[name])
                total = partial + scores[name]
                if not pipelined:
                    _sync(spans, solve_key, total)
            buckets = getattr(coord, "last_buckets", None)
            if not pipelined:
                trackers[f"{it}/{name}"] = _summarize(result, spans[solve_key], buckets)

            obj_key = f"{it}/{name}/objective"
            with spans.span(obj_key):
                reg_terms[name] = coord.regularization_term(models[name])
                obj_dev = objective(total)
                if not pipelined:
                    with spans.blocked(obj_key):
                        obj = float(obj_dev)

            metrics: List[object] = []
            if do_validation:
                val_key = f"{it}/{name}/validation"
                with spans.span(val_key):
                    val_scores_by_coord[name] = \
                        models[name].score_dataset(validation_dataset)
                    val_total = sum(val_scores_by_coord.values(), val_zeros)
                    metrics = [evaluate(spec, val_total, val_key)
                               for spec in validation_specs]
            if pipelined:
                pending.append({"key": f"{it}/{name}",
                                "solve_key": solve_key, "result": result,
                                "buckets": buckets, "objective": obj_dev,
                                "metrics": metrics, "models": dict(models)})
            else:
                record(obj, metrics, models)
        if pipelined:
            # outer-iteration boundary: the one host sync of the iteration
            with spans.span(f"{it}/flush"):
                with spans.blocked(f"{it}/flush"):
                    flush_pending()

    final = GameModel(dict(models), task_type)
    if not do_validation:
        best_model = final
    return CoordinateDescentResult(
        model=final, best_model=best_model,
        objective_history=objective_history,
        validation_history=validation_history, timings=spans,
        trackers=trackers, warm_starts=warm_starts)
