from photon_ml_tpu_torch.hyperparameter.kernels import RBF, Matern52, StationaryKernel  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.slice_sampler import SliceSampler  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.gp import (  # noqa: F401
    GaussianProcessEstimator, GaussianProcessModel, cholesky_solve,
)
from photon_ml_tpu_torch.hyperparameter.search import (  # noqa: F401
    ConfidenceBound, EvaluationFunction, ExpectedImprovement,
    GaussianProcessSearch, RandomSearch,
)
from photon_ml_tpu_torch.hyperparameter.game_evaluation import (  # noqa: F401
    GameEstimatorEvaluationFunction,
)
from photon_ml_tpu_torch.hyperparameter.vectorized import SweepEvaluator  # noqa: F401
