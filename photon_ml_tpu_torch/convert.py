"""Carry parameters across from the JAX package as numpy arrays.

The JAX package's models and normalization contexts hold jax arrays; pass
them through `np.asarray(...)` and these build the port's counterparts on
a device (None means cuda): GLMs, normalization contexts, GAME models,
PaddedSparse feature matrices and sparse COO/CSR tensors (a BCOO's data,
indices and shape).  numpy holds no bf16 here, so a bf16 array comes as
its uint16 bits (or as an extension bfloat16 array): `bf16_from_numpy`
makes the port's host tensor of it, and only that tensor (or the
extension array) is taken as bf16 (data/streaming.py `bf16_bits` gives
the bits back); a plain uint16 array stays integers.
Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext


def _tensor(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def glm_from_numpy(task_type: str, means, variances=None,
                   device=None) -> GeneralizedLinearModel:
    """A model of `task_type` from coefficient means (and variances)."""
    dev = resolve_device(device)
    return model_for_task(task_type,
                          Coefficients(_tensor(means, dev), _tensor(variances, dev)))


def normalization_from_numpy(factors, shifts, intercept_index: Optional[int],
                             device=None) -> NormalizationContext:
    """A normalization context from factors/shifts (either may be None)."""
    dev = resolve_device(device)
    return NormalizationContext(_tensor(factors, dev), _tensor(shifts, dev),
                                intercept_index)


def padded_sparse_from_numpy(indices, values, num_cols: int, csc_row=None,
                             csc_val=None, csc_end=None, device=None):
    """A PaddedSparse from a JAX PaddedSparse's arrays, layout unchanged
    (ELL slots, padding and column view as they are), with kernel B's tile
    map of the view."""
    from photon_ml_tpu_torch.ops.features import PaddedSparse
    from photon_ml_tpu_torch.ops.sparse_kernels import tile_map
    dev = resolve_device(device)
    tiles = None if csc_end is None else tile_map(np.asarray(csc_end))
    return PaddedSparse(_tensor(indices, dev), _tensor(values, dev), int(num_cols),
                        _tensor(csc_row, dev), _tensor(csc_val, dev),
                        _tensor(csc_end, dev), _tensor(tiles, dev))


def bf16_from_numpy(bits) -> torch.Tensor:
    """A bf16 host block from its bits (a uint16 array, or an array of an
    extension bfloat16 dtype) as a CPU torch.bfloat16 tensor sharing its
    memory (a copy only when the array is not contiguous)."""
    a = np.asarray(bits)
    if a.dtype != np.uint16 and a.dtype.name != "bfloat16":
        raise TypeError(f"bf16 bits come as uint16 (or bfloat16); got {a.dtype}")
    u16 = np.ascontiguousarray(a).view(np.uint16)
    return torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)


def sparse_from_numpy(data, indices, shape, layout: str = "coo", device=None):
    """A sparse tensor from a BCOO's (data [nnz], indices [nnz, 2], shape)
    as numpy arrays: layout "coo" keeps the entries as they are (every
    product sums duplicates, as a BCOO's do), "csr" coalesces them into
    CSR.  bf16 data comes as a CPU torch.bfloat16 tensor (raw bits through
    `bf16_from_numpy`) or an extension bfloat16 array and gives bf16
    values; unsigned integers widen to int64 (torch's sparse ops take no
    uint16 or uint32) and every other array keeps its dtype."""
    if layout not in ("coo", "csr"):
        raise ValueError(f"layout is 'coo' or 'csr'; got {layout!r}")
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        vals = data.cpu()
    else:
        data = np.asarray(data)
        if data.dtype.name == "bfloat16":
            vals = bf16_from_numpy(data)
        else:
            vals = torch.from_numpy(np.array(data, np.int64 if data.dtype.kind == "u" else None))
    idx = torch.from_numpy(np.asarray(indices, dtype=np.int64).reshape(-1, 2).T.copy())
    coo = torch.sparse_coo_tensor(idx, vals, tuple(int(s) for s in shape),
                                  check_invariants=True).to(dev)
    return coo if layout == "coo" else coo.coalesce().to_sparse_csr()


def game_model_from_numpy(task_type: str, coordinates: Dict[str, dict],
                          device=None):
    """A GameModel from numpy parameters, coordinate by coordinate in
    updating order.  Each entry is either

      {"kind": "fixed_effect", "feature_shard", "means"[, "variances"]}

    (a JAX FixedEffectModel's `glm.coefficients`), or

      {"kind": "random_effect", "random_effect_type", "feature_shard",
       "coefficients" [E, d_local], "entity_ids" [E], "projection"
       [E, d_local] or None, "global_dim"[, "variances",
       "projection_matrix" [d_local, d_global]]}

    (a JAX RandomEffectModel's fields), or

      {"kind": "factored_random_effect", "random_effect_type",
       "feature_shard", "latent_coefficients" [E, k], "projection" [k, d],
       "entity_ids" [E], "global_dim"}

    (a JAX FactoredRandomEffectModel's), or

      {"kind": "matrix_factorization", "row_effect_type",
       "col_effect_type", "row_factors" [R, k], "row_ids" [R],
       "col_factors" [C, k], "col_ids" [C]}

    (a JAX MatrixFactorizationModel's)."""
    from photon_ml_tpu_torch.models.game import (
        FactoredRandomEffectModel, FixedEffectModel, GameModel,
        MatrixFactorizationModel, RandomEffectModel,
    )
    dev = resolve_device(device)
    models = {}
    for name, c in coordinates.items():
        if c["kind"] == "fixed_effect":
            models[name] = FixedEffectModel(
                glm_from_numpy(task_type, c["means"], c.get("variances"), dev),
                c["feature_shard"])
        elif c["kind"] == "random_effect":
            proj = c.get("projection")
            models[name] = RandomEffectModel(
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"], task_type=task_type,
                coefficients=_tensor(c["coefficients"], dev),
                entity_ids=np.asarray(c["entity_ids"]),
                projection=None if proj is None else np.asarray(proj),
                global_dim=int(c["global_dim"]),
                variances=_tensor(c.get("variances"), dev),
                projection_matrix=_tensor(c.get("projection_matrix"), dev))
        elif c["kind"] == "factored_random_effect":
            models[name] = FactoredRandomEffectModel(
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"], task_type=task_type,
                latent_coefficients=_tensor(c["latent_coefficients"], dev),
                projection=_tensor(c["projection"], dev),
                entity_ids=np.asarray(c["entity_ids"]),
                global_dim=int(c["global_dim"]))
        elif c["kind"] == "matrix_factorization":
            models[name] = MatrixFactorizationModel(
                row_effect_type=c["row_effect_type"],
                col_effect_type=c["col_effect_type"],
                row_factors=_tensor(c["row_factors"], dev),
                row_ids=np.asarray(c["row_ids"]),
                col_factors=_tensor(c["col_factors"], dev),
                col_ids=np.asarray(c["col_ids"]))
        else:
            raise ValueError(f"coordinate {name!r}: unknown kind {c['kind']!r}")
    return GameModel(models, task_type)
