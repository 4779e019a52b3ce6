from photon_ml_tpu_torch.ops.losses import (  # noqa: F401
    BY_NAME, LOGISTIC, POISSON, SMOOTHED_HINGE, SQUARED, TASK_LOSSES, PointwiseLoss,
)
from photon_ml_tpu_torch.ops.normalization import (  # noqa: F401
    NormalizationContext, NormalizationType, build_normalization_context, no_normalization,
)
from photon_ml_tpu_torch.ops.objective import GLMObjective  # noqa: F401
from photon_ml_tpu_torch.ops import (  # noqa: F401
    aggregators, features, hopper_kernels, sparse_kernels,
)
