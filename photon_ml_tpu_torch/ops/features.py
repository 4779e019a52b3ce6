"""Feature-matrix products (port of photon_ml_tpu/ops/features.py).

Dense [n, d] tensors only.  The JAX package's other representations
(PaddedSparse ELL, BCOO, KroneckerDesign) are not ported yet: they raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch

from photon_ml_tpu_torch import resolve_device

FeatureMatrix = torch.Tensor

_NOT_PORTED = ("only dense feature matrices are ported; {kind} is "
               "ROADMAP.md queue A item 4 (PaddedSparse ELL, BCOO, "
               "KroneckerDesign)")


def _dense(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.ndim == 2 and x.layout == torch.strided:
        return x
    raise NotImplementedError(_NOT_PORTED.format(kind=type(x).__name__))


def as_feature_matrix(x, device=None, dtype=None) -> FeatureMatrix:
    """Ingest adapter: a dense array or tensor -> a dense tensor on
    `device` (None means cuda).  Sparse inputs raise NotImplementedError."""
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        if hasattr(x, "tocsr"):  # scipy.sparse
            raise NotImplementedError(_NOT_PORTED.format(kind=type(x).__name__))
        x = torch.as_tensor(x)
    return _dense(x).to(device=dev, dtype=dtype)


def num_features(x: FeatureMatrix) -> int:
    return _dense(x).shape[-1]


def num_rows(x: FeatureMatrix) -> int:
    return _dense(x).shape[0]


def matvec(x: FeatureMatrix, v: torch.Tensor) -> torch.Tensor:
    """X @ v -> [n].  The margin product."""
    return torch.mv(_dense(x), v)


def rmatvec(x: FeatureMatrix, u: torch.Tensor) -> torch.Tensor:
    """X^T @ u -> [d].  The gradient-assembly product."""
    return torch.mv(_dense(x).T, u)


def sq_rmatvec(x: FeatureMatrix, u: torch.Tensor) -> torch.Tensor:
    """(X*X)^T @ u -> [d], for the Hessian diagonal."""
    x = _dense(x)
    return torch.mv((x * x).T, u)
