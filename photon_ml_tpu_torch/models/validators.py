"""Composable trained-model validity checks (port of
photon_ml_tpu/models/validators.py; predictions and labels may be tensors
on any device, and the checks run on host copies in float64 where given).

Rebuild of the reference's ModelValidator suite (photon-api/src/integTest/
.../supervised/{ModelValidator, PredictionFiniteValidator,
BinaryPredictionValidator, NonNegativePredictionValidator,
MaximumDifferenceValidator, BinaryClassifierAUCValidator,
CompositeModelValidator}.scala): after training, assert that a model's
predictions over a dataset are sane — finite, in-range for the task,
within an error bound, above a minimum AUC — and raise with a count of
offending rows otherwise.  The reference filters RDDs per check; here each
check is one vectorized pass over the prediction array, and a composite
runs every check on a single shared prediction computation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, _BinaryClassifier

#: reference: MathConst.POSITIVE_RESPONSE_THRESHOLD
POSITIVE_RESPONSE_THRESHOLD = 0.5


class ModelValidationError(ValueError):
    """A trained model failed a validity check (reference raises
    IllegalStateException)."""


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _predictions(model: GeneralizedLinearModel, x, offsets=None) -> np.ndarray:
    """Mean predictions (inverse link), one device round trip shared by
    every check in a composite."""
    return _host(model.predict(x, offsets))


@dataclasses.dataclass(frozen=True)
class PredictionFiniteValidator:
    """reference: PredictionFiniteValidator — no NaN/±Inf predictions."""

    def validate(self, model, x, labels=None, offsets=None,
                 predictions: Optional[np.ndarray] = None) -> None:
        p = _predictions(model, x, offsets) if predictions is None else _host(predictions)
        bad = int((~np.isfinite(p)).sum())
        if bad:
            raise ModelValidationError(
                f"found [{bad}] samples with invalid (NaN or +/-Inf) "
                "predictions")


@dataclasses.dataclass(frozen=True)
class BinaryPredictionValidator:
    """reference: BinaryPredictionValidator — class predictions at the
    positive-response threshold must be exactly 0 or 1."""

    threshold: float = POSITIVE_RESPONSE_THRESHOLD

    def validate(self, model, x, labels=None, offsets=None,
                 predictions=None) -> None:
        if not isinstance(model, _BinaryClassifier):
            raise ModelValidationError(
                f"binary-prediction validation requires a classifier, got "
                f"{type(model).__name__}")
        if predictions is not None and type(model).predict_class is \
                _BinaryClassifier.predict_class:
            # mean-threshold classifiers derive classes from the shared
            # prediction array; only margin-threshold overrides (the
            # smoothed-hinge SVM) need their own pass
            cls = (_host(predictions) >= self.threshold).astype(int)
        else:
            cls = _host(model.predict_class(x, offsets,
                                                 threshold=self.threshold))
        bad = int(((cls != 0.0) & (cls != 1.0)).sum())
        if bad:
            raise ModelValidationError(
                f"found [{bad}] samples with invalid class predictions "
                "(expected 0 or 1)")


@dataclasses.dataclass(frozen=True)
class NonNegativePredictionValidator:
    """reference: NonNegativePredictionValidator / PredictionNonNegative —
    predictions must be >= 0 (Poisson means, probabilities, counts)."""

    def validate(self, model, x, labels=None, offsets=None,
                 predictions=None) -> None:
        p = _predictions(model, x, offsets) if predictions is None else _host(predictions)
        bad = int((p < 0).sum())
        if bad:
            raise ModelValidationError(
                f"found [{bad}] samples with invalid negative predictions")


@dataclasses.dataclass(frozen=True)
class MaximumDifferenceValidator:
    """reference: MaximumDifferenceValidator — |prediction - label| must
    not exceed `maximum_difference` on any row."""

    maximum_difference: float

    def __post_init__(self):
        if not self.maximum_difference > 0:
            raise ValueError("maximum_difference must be > 0")

    def validate(self, model, x, labels, offsets=None,
                 predictions=None) -> None:
        p = _predictions(model, x, offsets) if predictions is None else _host(predictions)
        bad = int((np.abs(p - _host(labels))
                   > self.maximum_difference).sum())
        if bad:
            raise ModelValidationError(
                f"found [{bad}] instances where the magnitude of the "
                f"prediction error is greater than "
                f"[{self.maximum_difference}]")


@dataclasses.dataclass(frozen=True)
class BinaryClassifierAUCValidator:
    """reference: BinaryClassifierAUCValidator — AUROC of mean predictions
    (with offsets) must reach `minimum_auc`."""

    minimum_auc: float

    def __post_init__(self):
        if not 0.5 <= self.minimum_auc <= 1.0:
            raise ValueError("minimum_auc must be in [0.5, 1.0]")

    def validate(self, model, x, labels, offsets=None,
                 predictions=None) -> None:
        from photon_ml_tpu_torch.evaluation.evaluators import AUC
        p = _predictions(model, x, offsets) if predictions is None else _host(predictions)
        auc = AUC(p, _host(labels))
        if not auc >= self.minimum_auc:  # NaN AUC fails too
            raise ModelValidationError(
                f"computed AUROC [{auc}] is smaller than minimum required "
                f"[{self.minimum_auc}]")


_NEEDS_LABELS = (MaximumDifferenceValidator, BinaryClassifierAUCValidator)


@dataclasses.dataclass(frozen=True)
class CompositeModelValidator:
    """reference: CompositeModelValidator — run every check in order; the
    mean-prediction array is computed once and shared.  Accepts either an
    iterable of validators or them as positional args."""

    validators: Sequence[object]

    def __init__(self, *validators, **kw):
        # CompositeModelValidator(v1, v2), CompositeModelValidator([v1, v2])
        # and dataclasses.replace(c, validators=[...]) all work
        if kw:
            if validators or set(kw) != {"validators"}:
                raise TypeError(
                    "pass validators positionally, as one iterable, or as "
                    "the 'validators' keyword")
            validators = tuple(kw["validators"])
        elif len(validators) == 1 and not hasattr(validators[0], "validate"):
            validators = tuple(validators[0])
        object.__setattr__(self, "validators", tuple(validators))

    def validate(self, model, x, labels=None, offsets=None,
                 predictions=None) -> None:
        if labels is None:
            needy = [type(v).__name__ for v in self.validators
                     if isinstance(v, _NEEDS_LABELS)]
            if needy:
                raise ModelValidationError(
                    f"validators {needy} require labels")
        if predictions is None:
            predictions = _predictions(model, x, offsets)
        for v in self.validators:
            v.validate(model, x, labels, offsets, predictions=predictions)
