from photon_ml_tpu_torch.optim.config import (  # noqa: F401
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType, solve,
)
from photon_ml_tpu_torch.optim.lbfgs import lbfgs, owlqn  # noqa: F401
from photon_ml_tpu_torch.optim.schedule import (  # noqa: F401
    QuarantineRetrySchedule, RegWeights, SolveBudget, SolverSchedule, StochasticPlan,
)
from photon_ml_tpu_torch.optim.types import ConvergenceReason, SolveResult  # noqa: F401
