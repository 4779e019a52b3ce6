from photon_ml_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, FEATURE_AXIS, WORLD_AXIS, CollectiveStats, Mesh, data_sharding,
    feature_sharding, initialize_multihost, make_mesh,
)
from photon_ml_tpu_torch.parallel import multihost  # noqa: F401
from photon_ml_tpu_torch.parallel.fixed_effect import (  # noqa: F401
    fit_fixed_effect, fit_fixed_effect_admm, score_fixed_effect,
    stage_objective,
)
from photon_ml_tpu_torch.parallel.mesh_residency import (  # noqa: F401
    MeshResidency, TransferStats, default_residency, transfer_snapshot,
)
