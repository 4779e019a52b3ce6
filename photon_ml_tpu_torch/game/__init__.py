from photon_ml_tpu_torch.game.config import (  # noqa: F401
    FactoredRandomEffectCoordinateConfig, FixedEffectCoordinateConfig,
    GameTrainingConfig, GLMOptimizationConfig, RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.game.coordinate_descent import (  # noqa: F401
    CoordinateDescentResult, ValidationSpec, run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import (  # noqa: F401
    FixedEffectCoordinate, RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.estimator import GameEstimator, GameResult, select_best_result  # noqa: F401
