"""Generalized linear model classes (port of photon_ml_tpu/models/glm.py).

Each model pairs Coefficients with its PointwiseLoss; scoring is the margin
and `predict` applies the inverse link (`loss.mean`).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops import losses as L


@dataclasses.dataclass
class GeneralizedLinearModel:
    """Base GLM: margin scoring + mean prediction."""

    coefficients: Coefficients

    loss: ClassVar[L.PointwiseLoss] = L.SQUARED
    task_type: ClassVar[str] = "none"

    def compute_score(self, x: torch.Tensor,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Margin z = x.w (+ offset)."""
        z = self.coefficients.compute_score(x)
        return z if offsets is None else z + offsets

    def predict(self, x: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean response."""
        return type(self).loss.mean(self.compute_score(x, offsets))

    def validate_coefficients(self) -> bool:
        """reference: GeneralizedLinearModel.validateCoefficients (all finite)."""
        return bool(torch.isfinite(self.coefficients.means).all())

    def with_coefficients(self, coefficients: Coefficients):
        return dataclasses.replace(self, coefficients=coefficients)


class _BinaryClassifier(GeneralizedLinearModel):
    """Threshold API of the reference's BinaryClassifier trait."""

    def predict_class(self, x, offsets=None, threshold: float = 0.5) -> torch.Tensor:
        return (self.predict(x, offsets) >= threshold).to(torch.int32)


class LogisticRegressionModel(_BinaryClassifier):
    loss: ClassVar[L.PointwiseLoss] = L.LOGISTIC
    task_type: ClassVar[str] = "logistic_regression"


class SmoothedHingeLossLinearSVMModel(_BinaryClassifier):
    loss: ClassVar[L.PointwiseLoss] = L.SMOOTHED_HINGE
    task_type: ClassVar[str] = "smoothed_hinge_loss_linear_svm"

    def predict_class(self, x, offsets=None, threshold: float = 0.0) -> torch.Tensor:
        # raw-margin classifier: threshold on the margin itself
        return (self.compute_score(x, offsets) >= threshold).to(torch.int32)


class LinearRegressionModel(GeneralizedLinearModel):
    loss: ClassVar[L.PointwiseLoss] = L.SQUARED
    task_type: ClassVar[str] = "linear_regression"


class PoissonRegressionModel(GeneralizedLinearModel):
    loss: ClassVar[L.PointwiseLoss] = L.POISSON
    task_type: ClassVar[str] = "poisson_regression"


TASK_MODELS = {
    cls.task_type: cls
    for cls in (LogisticRegressionModel, LinearRegressionModel,
                PoissonRegressionModel, SmoothedHingeLossLinearSVMModel)
}


def model_for_task(task_type: str, coefficients: Coefficients) -> GeneralizedLinearModel:
    return TASK_MODELS[task_type](coefficients)
