"""Non-finite solve quarantine: contain a diverged coordinate, don't let it
poison the descent (port of photon_ml_tpu/game/quarantine.py).

A single NaN/Inf inner solve would otherwise be terminal: the coordinate's
scores go non-finite, `total = partial + scores` goes non-finite, and every
downstream coordinate then solves against poisoned residual offsets.

Three pieces, all batched or rare:

  * `guard(new, prev)`: a DEVICE bool tensor (every coefficient finite)
    and a `where(flag, new, old)` rollback over the coordinate's
    coefficient tensors.  A poisoned solve then behaves, for every
    downstream consumer, as if the coordinate had been frozen for the
    visit.  When the solve is healthy, `where(True, new, old)` is bitwise
    `new`, so strict/pipelined parity is unaffected.  The flag stays on
    the device: it is combined with the objective's finiteness
    (`combine_health`) and read back with the objective in the one batched
    copy per outer iteration, so the check adds no host read-back.
  * `QuarantineMonitor`: the host-side policy, applied when the flag lands:
    record the event, re-run the coordinate once at a tightened budget
    (optim/schedule.py QuarantineRetrySchedule: a quarter of the
    configured iteration cap, a 10x looser tolerance); if the re-run also
    diverges, or the coordinate diverges again at a later visit, freeze it
    for the rest of the fit while the other coordinates keep descending.
  * `poison_model`: the fault-injection corruption (site "solve.poison"):
    the solve result times NaN.

Objective-only divergence (finite coefficients, non-finite data term) is
caught by the same combined flag; its rollback is host-side at the flush.
Each containment action increments `train.quarantine.<action>` and emits a
`quarantine` event, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import (
    FactoredRandomEffectModel, FixedEffectModel, MatrixFactorizationModel,
    RandomEffectModel,
)

logger = logging.getLogger("photon_ml_tpu_torch")


def coefficient_arrays(model) -> Optional[Tuple[torch.Tensor, ...]]:
    """The tensors a solve writes, per coordinate-model kind; None for
    kinds the descent loop never produces (no guard applied)."""
    if isinstance(model, FixedEffectModel):
        return (model.glm.coefficients.means,)
    if isinstance(model, FactoredRandomEffectModel):
        return (model.latent_coefficients, model.projection)
    if isinstance(model, RandomEffectModel):
        return (model.coefficients,)
    if isinstance(model, MatrixFactorizationModel):
        return (model.row_factors, model.col_factors)
    return None


def _with_coefficient_arrays(model, arrays):
    if isinstance(model, FixedEffectModel):
        (means,) = arrays
        coeffs = Coefficients(means, model.glm.coefficients.variances)
        return FixedEffectModel(model.glm.with_coefficients(coeffs),
                                model.feature_shard)
    if isinstance(model, FactoredRandomEffectModel):
        latent, proj = arrays
        return dataclasses.replace(model, latent_coefficients=latent,
                                   projection=proj)
    if isinstance(model, RandomEffectModel):
        (coeffs,) = arrays
        return dataclasses.replace(model, coefficients=coeffs)
    if isinstance(model, MatrixFactorizationModel):
        rows, cols = arrays
        return dataclasses.replace(model, row_factors=rows, col_factors=cols)
    raise TypeError(f"unknown coordinate model type {type(model)}")


def _all_finite(arrays) -> torch.Tensor:
    flag = torch.isfinite(arrays[0]).all()
    for a in arrays[1:]:
        flag = flag & torch.isfinite(a).all()
    return flag


def guard(new_model, prev_model):
    """-> (guarded model, device bool flag).  The guarded model equals
    `new_model` bitwise when every coefficient is finite, `prev_model`'s
    coefficients otherwise.  Unknown model kinds pass through unguarded
    with a constant-True flag."""
    new_arrays = coefficient_arrays(new_model)
    if new_arrays is None:
        return new_model, torch.ones((), dtype=torch.bool)
    flag = _all_finite(new_arrays)
    old_arrays = coefficient_arrays(prev_model)
    guarded = _with_coefficient_arrays(
        new_model, tuple(torch.where(flag, a, b)
                         for a, b in zip(new_arrays, old_arrays)))
    return guarded, flag


def combine_health(flag: torch.Tensor, objective_scalar: torch.Tensor
                   ) -> torch.Tensor:
    """Coefficient finiteness AND objective finiteness as ONE device bool
    (the scalar that rides the batched outer-iteration read-back)."""
    return flag & torch.isfinite(objective_scalar)


def poison_model(model):
    """Corrupt a solve result with NaNs (fault-injection site
    "solve.poison")."""
    arrays = coefficient_arrays(model)
    if arrays is None:
        return model
    return _with_coefficient_arrays(model, tuple(a * float("nan") for a in arrays))


class QuarantineMonitor:
    """Host-side containment policy and event log.

    Lifecycle per coordinate: healthy -> (divergence) -> rolled back + ONE
    re-run at the tightened budget -> healthy again, OR frozen for the
    rest of the fit.  A second divergence at any later visit freezes at
    once (two strikes)."""

    def __init__(self):
        self.events: List[dict] = []
        self._retried: set = set()
        self._frozen: set = set()

    def is_frozen(self, name: str) -> bool:
        return name in self._frozen

    @property
    def frozen(self) -> List[str]:
        return sorted(self._frozen)

    def _event(self, iteration: int, coordinate: str, action: str,
               **extra) -> dict:
        e = {"iteration": int(iteration), "coordinate": coordinate,
             "action": action, **extra}
        self.events.append(e)
        # containment is observable outside the fit result too: a counter
        # per action in the registry, and — when the tracer is armed — a
        # run-log event correlated by span id with the coordinate visit
        # whose flush discovered the divergence
        telemetry.counter(f"train.quarantine.{action}").inc()
        telemetry.event("quarantine", iteration=int(iteration),
                        coordinate=coordinate, action=action)
        logger.warning("quarantine: iter %d coordinate %-16s %s %s",
                       iteration, coordinate, action, extra or "")
        return e

    def on_divergence(self, iteration: int, coordinate: str) -> str:
        """Policy decision when a non-finite flag lands: 'retry' (first
        strike: the caller re-runs once at the tightened budget) or
        'freeze' (second strike)."""
        self._event(iteration, coordinate, "rolled_back")
        if coordinate in self._retried:
            self._frozen.add(coordinate)
            self._event(iteration, coordinate, "frozen",
                        reason="diverged again after a successful "
                               "quarantine retry")
            return "freeze"
        self._retried.add(coordinate)
        return "retry"

    def on_retry_result(self, iteration: int, coordinate: str,
                        ok: bool, objective: Optional[float] = None) -> None:
        if ok:
            self._event(iteration, coordinate, "retry_ok",
                        objective=objective)
        else:
            self._frozen.add(coordinate)
            self._event(iteration, coordinate, "frozen",
                        reason="quarantine retry at the tightened budget "
                               "also diverged")
