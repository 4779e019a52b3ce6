"""Input-data sanity checks, gated by validation intensity
(a copy of photon_ml_tpu/data/validators.py; host code).

Rebuild of photon-client/.../data/DataValidators.scala:33-332 and
DataValidationType: per-task row checks (finite features/offset/weight for
every task; finite label for linear/Poisson; binary label for logistic and
smoothed hinge; non-negative label for Poisson), run over the FULL dataset, a
10% SAMPLE, or DISABLED.

TPU-first divergence from the reference: the reference folds a per-row
predicate over the RDD and can only report *that* a check failed; here the
checks are vectorized numpy reductions over the struct-of-arrays GameDataset,
which is both orders of magnitude faster host-side and lets the error name
the first offending row (and feature column for feature checks).
"""
from __future__ import annotations

import enum
from typing import List

import numpy as np

from photon_ml_tpu_torch.data.game_data import GameDataset


class DataValidationType(str, enum.Enum):
    """reference: DataValidationType.scala (VALIDATE_FULL/SAMPLE/DISABLED)."""

    VALIDATE_FULL = "full"
    VALIDATE_SAMPLE = "sample"
    VALIDATE_DISABLED = "disabled"


SAMPLE_FRACTION = 0.10  # reference: sanityCheckData sample(fraction = 0.10)


class DataValidationError(ValueError):
    """Validation failure; message names every failed check with the first
    offending row (reference raises IllegalArgumentException with the
    aggregated message list, DataValidators.scala:244-247)."""


def _first_bad(mask: np.ndarray) -> int:
    return int(np.argmax(mask))


def _positive_weight_errors(dataset: GameDataset) -> List[str]:
    """'Verify and reject' non-positive sample weights, like the GAME
    training job's checkData (reference: cli/game/training/Driver.scala:215-240
    — "Found N data points with weights <= 0. Please fix data set.").
    Always counts the FULL array: the 1-D scan is cheap and a sampled
    count would understate the problem."""
    if dataset.weights is None:
        return []
    w = np.asarray(dataset.weights)
    nonpos = np.isfinite(w) & (w <= 0.0)
    if not nonpos.any():
        return []
    return [f"Found {int(nonpos.sum())} data points with weights <= 0 "
            f"(first at row {_first_bad(nonpos)}). Please fix data set."]


def _check_positive_weights(dataset: GameDataset) -> None:
    errors = _positive_weight_errors(dataset)
    if errors:
        raise DataValidationError(
            "Data Validation failed:\n" + "\n".join(errors))


def _check_label(task_type: str, y: np.ndarray, rows: np.ndarray) -> List[str]:
    errors = []
    if task_type in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        bad = ~((y == 0.0) | (y == 1.0))
        if bad.any():
            i = _first_bad(bad)
            errors.append(
                f"Data contains row(s) with non-binary label(s): first at row "
                f"{int(rows[i])} (label={y[i]!r})")
    else:
        bad = ~np.isfinite(y)
        if bad.any():
            i = _first_bad(bad)
            errors.append(
                f"Data contains row(s) with non-finite label(s): first at row "
                f"{int(rows[i])} (label={y[i]!r})")
        if task_type == "poisson_regression":
            bad = np.isfinite(y) & (y < 0)
            if bad.any():
                i = _first_bad(bad)
                errors.append(
                    f"Data contains row(s) with negative label(s): first at "
                    f"row {int(rows[i])} (label={y[i]!r})")
    return errors


def validate_game_dataset(
    dataset: GameDataset,
    task_type: str,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
    seed: int = 0,
    check_weights: bool = True,
) -> None:
    """Raise DataValidationError naming every failed check, or return None.

    reference: DataValidators.sanityCheckData / sanityCheckDataFrameForTraining
    (task dispatch at DataValidators.scala:221-229, gating at 231-247).
    """
    validation_type = DataValidationType(validation_type)
    if validation_type is DataValidationType.VALIDATE_DISABLED:
        # the weights <= 0 rejection still runs by default: the reference
        # gates its checkData on a SEPARATE on-by-default flag, not on
        # validation intensity (cli/game/training/Driver.scala:215-240,
        # GameTrainingParams checkData) — and like that flag it has its own
        # opt-out (`check_weights=False` / CLI --no-weight-check)
        if check_weights:
            _check_positive_weights(dataset)
        return
    n = dataset.num_rows
    if validation_type is DataValidationType.VALIDATE_SAMPLE:
        rng = np.random.default_rng(seed)
        rows = np.flatnonzero(rng.random(n) < SAMPLE_FRACTION)
        if len(rows) == 0:
            rows = np.arange(n)
        take = lambda a: np.asarray(a)[rows]
    else:
        # FULL: reduce over the arrays in place — fancy-indexing with
        # arange(n) would copy every (possibly multi-GB) shard
        rows = np.arange(n)
        take = np.asarray

    errors: List[str] = []
    errors.extend(_check_label(task_type, take(dataset.response), rows))
    from photon_ml_tpu_torch.data.game_data import _is_sparse
    for shard, x in dataset.feature_shards.items():
        if _is_sparse(x):
            # sparse shard (wide-FE path): validate the STORED values; the
            # implicit zeros are finite by construction.  Row slice first
            # under SAMPLE so the check stays proportional; the COO copy is
            # built only to NAME the offending row/column once a non-finite
            # value is known to exist.
            xs = (x.tocsr()[rows]
                  if validation_type is DataValidationType.VALIDATE_SAMPLE
                  else x)
            if not np.isfinite(xs.data).all():
                coo = xs.tocoo()
                i = _first_bad(~np.isfinite(coo.data))
                errors.append(
                    f"Data contains row(s) with non-finite feature(s): first "
                    f"at row {int(rows[coo.row[i]])}, shard {shard!r} column "
                    f"{int(coo.col[i])}")
            continue
        vals = take(x)
        if not np.isfinite(vals).all():
            bad_rows, bad_cols = np.nonzero(~np.isfinite(vals))
            errors.append(
                f"Data contains row(s) with non-finite feature(s): first at "
                f"row {int(rows[bad_rows[0]])}, shard {shard!r} column "
                f"{int(bad_cols[0])}")
    for name, arr in (("offset", dataset.offsets), ("weight", dataset.weights)):
        if arr is None:
            continue
        vals = take(arr)
        bad = ~np.isfinite(vals)
        if bad.any():
            i = _first_bad(bad)
            errors.append(
                f"Data contains row(s) with non-finite {name}(s): first at "
                f"row {int(rows[i])} ({name}={vals[i]!r})")
    if check_weights:
        errors.extend(_positive_weight_errors(dataset))
    if errors:
        raise DataValidationError(
            "Data Validation failed:\n" + "\n".join(errors))
