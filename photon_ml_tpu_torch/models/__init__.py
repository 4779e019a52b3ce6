from photon_ml_tpu_torch.models.coefficients import Coefficients  # noqa: F401
from photon_ml_tpu_torch.models.glm import (  # noqa: F401
    TASK_MODELS, GeneralizedLinearModel, LinearRegressionModel,
    LogisticRegressionModel, PoissonRegressionModel,
    SmoothedHingeLossLinearSVMModel, model_for_task,
)
from photon_ml_tpu_torch.models.training import (  # noqa: F401
    TrainedModel, best_model_by_validation, train_glm,
)
