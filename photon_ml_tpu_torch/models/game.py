"""GAME model containers: fixed effect, random effect, factored random
effect, matrix factorization and the composite (port of
photon_ml_tpu/models/game.py).

A model's score is ITS margin contribution only (no base offset: evaluators
add score + offset), and rows whose entity a random-effect model does not
know contribute 0, the reference's missing-score default.  Models score on
the device and in the dtype of their coefficients.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.game_data import GameDataset
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as L
from photon_ml_tpu_torch.parallel.random_effect import (
    scatter_local_to_global, score_entities_matmul, score_entities_plain,
    score_entities_scatter,
)


@dataclasses.dataclass
class FixedEffectModel:
    """One global GLM bound to a feature shard."""

    glm: GeneralizedLinearModel
    feature_shard: str

    @property
    def task_type(self) -> str:
        return type(self.glm).task_type

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        c = self.glm.coefficients.means
        return self.glm.compute_score(
            dataset.device_shard(self.feature_shard, c.device, c.dtype))


def _lanes_for(dataset: GameDataset, re_type: str,
               entity_ids: np.ndarray) -> np.ndarray:
    """Map the dataset's entity-index column to model lanes by raw id (the
    static gather that replaces the reference's data-keyBy(REId) join)."""
    vocab = dataset.entity_vocabs[re_type]
    lookup = {v: i for i, v in enumerate(np.asarray(entity_ids).tolist())}
    vocab_to_lane = np.asarray([lookup.get(v, -1) for v in vocab.tolist()],
                               dtype=np.int64)
    idx = dataset.entity_indices[re_type]
    return np.where(idx >= 0, vocab_to_lane[np.maximum(idx, 0)], -1)


def _cached(dataset: GameDataset, kind: str, re_type: str, source, build,
            device: torch.device) -> torch.Tensor:
    """Device copy of `build()`, memoized on the dataset per `source` (a
    host array the models of one coordinate share: a plain and a factored
    random effect of one entity type keep their own lane maps)."""
    key = (kind, re_type, str(device), id(source))
    hit = dataset._scoring_cache.get(key)
    if hit is None or hit[0] is not source:
        hit = (source, torch.as_tensor(build(), device=device))
        dataset._scoring_cache[key] = hit
    return hit[1]


def _device_lanes(dataset: GameDataset, re_type: str, entity_ids: np.ndarray,
                  device: torch.device) -> torch.Tensor:
    return _cached(dataset, "lanes", re_type, entity_ids,
                   lambda: _lanes_for(dataset, re_type, entity_ids), device)


@dataclasses.dataclass
class RandomEffectModel:
    """Per-entity coefficients in a (possibly projected) local space: the
    compact local-space coefficients plus the projection back to the global
    shard space; entity identity is carried as raw id values so the model
    scores datasets with other vocabularies."""

    random_effect_type: str
    feature_shard: str
    task_type: str
    coefficients: torch.Tensor            # [E, d_local]
    entity_ids: np.ndarray                # [E] raw entity id values
    projection: Optional[np.ndarray]      # [E, d_local] global cols, -1 pad
    global_dim: int
    variances: Optional[torch.Tensor] = None  # [E, d_local]
    # dense shared random-projection matrix [d_local, d_global] (reference:
    # ProjectionMatrixBroadcast), exclusive with the index `projection`
    projection_matrix: Optional[torch.Tensor] = None

    def __post_init__(self):
        # on the coefficients' device and in their dtype once: scoring runs
        # every coordinate-descent update
        if self.projection_matrix is not None:
            c = self.coefficients
            self.projection_matrix = torch.as_tensor(
                self.projection_matrix).to(device=c.device, dtype=c.dtype)

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    def global_coefficients(self) -> torch.Tensor:
        """[E, d_global] via scatter along the projection columns, or the
        dense product c @ projection_matrix."""
        if self.projection_matrix is not None:
            return self.coefficients @ self.projection_matrix
        return scatter_local_to_global(self.coefficients, self.projection,
                                       self.global_dim)

    def lanes_for(self, dataset: GameDataset) -> np.ndarray:
        return _lanes_for(dataset, self.random_effect_type, self.entity_ids)

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        c = self.coefficients
        x = dataset.device_shard(self.feature_shard, c.device, c.dtype)
        lanes = _device_lanes(dataset, self.random_effect_type, self.entity_ids,
                              c.device)
        if self.projection_matrix is not None:
            return score_entities_matmul(c, self.projection_matrix, x, lanes)
        if self.projection is not None:
            proj = _cached(dataset, "proj", self.random_effect_type, self.projection,
                           lambda: self.projection, c.device)
            return score_entities_scatter(c, proj, x, lanes,
                                          global_dim=self.global_dim)
        return score_entities_plain(c, x, lanes)


@dataclasses.dataclass
class FactoredRandomEffectModel:
    """Per-entity latent factors [E, k] and a shared latent projection
    [k, d] (reference: FactoredRandomEffectModel.scala:33 =
    modelsInProjectedSpace + ProjectionMatrixBroadcast).  The effective
    per-entity coefficients in the shard's space are C @ P."""

    random_effect_type: str
    feature_shard: str
    task_type: str
    latent_coefficients: torch.Tensor     # [E, k]
    projection: torch.Tensor              # [k, d_global]
    entity_ids: np.ndarray                # [E] raw entity id values
    global_dim: int

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def latent_dim(self) -> int:
        return self.latent_coefficients.shape[1]

    def global_coefficients(self) -> torch.Tensor:
        return self.latent_coefficients @ self.projection

    def to_random_effect_model(self) -> RandomEffectModel:
        """The shard-space view (reference: FactoredRandomEffectModel
        .toRandomEffectModel)."""
        return RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard=self.feature_shard, task_type=self.task_type,
            coefficients=self.global_coefficients(), entity_ids=self.entity_ids,
            projection=None, global_dim=self.global_dim)

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        c = self.latent_coefficients
        return score_entities_matmul(
            c, self.projection,
            dataset.device_shard(self.feature_shard, c.device, c.dtype),
            _device_lanes(dataset, self.random_effect_type, self.entity_ids, c.device))


@dataclasses.dataclass
class MatrixFactorizationModel:
    """score(row, col) = rowFactor . colFactor (reference:
    MatrixFactorizationModel.scala:36-291): two dense [*, k] factor tables
    and their raw id arrays.  Task-agnostic, as the reference's
    (task_type "none", exempt from GameModel's consistency check)."""

    row_effect_type: str
    col_effect_type: str
    row_factors: torch.Tensor             # [R, k]
    row_ids: np.ndarray                   # [R] raw entity id values
    col_factors: torch.Tensor             # [C, k]
    col_ids: np.ndarray                   # [C] raw entity id values
    task_type: str = "none"

    @property
    def num_latent_factors(self) -> int:
        """reference: MatrixFactorizationModel.numLatentFactors."""
        if self.row_factors.shape[0]:
            return self.row_factors.shape[1]
        if self.col_factors.shape[0]:
            return self.col_factors.shape[1]
        return 0

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        """rowFactor . colFactor per row; a row whose either entity is
        unseen scores 0 (the reference's inner join default)."""
        dev = self.row_factors.device
        rl = _device_lanes(dataset, self.row_effect_type, self.row_ids, dev)
        cl = _device_lanes(dataset, self.col_effect_type, self.col_ids, dev)
        ok = (rl >= 0) & (cl >= 0)
        if not (self.row_factors.shape[0] and self.col_factors.shape[0]):
            return torch.zeros(rl.shape[0], dtype=self.row_factors.dtype, device=dev)
        rf = self.row_factors[torch.clamp(rl, min=0)]
        cf = self.col_factors[torch.clamp(cl, min=0)]
        s = torch.sum(rf * cf, dim=-1)
        return torch.where(ok, s, torch.zeros_like(s))

    @staticmethod
    def from_factored(model: FactoredRandomEffectModel, col_effect_type: str,
                      col_ids: np.ndarray) -> "MatrixFactorizationModel":
        """When the factored random effect's shard is a one-hot indicator of
        a second entity (no intercept), c_e . (P x) == c_e . P[:, col]: rows
        are the random effect's entities, columns the projection's."""
        if len(col_ids) != model.projection.shape[1]:
            raise ValueError(
                f"col_ids has {len(col_ids)} entries but the projection has "
                f"{model.projection.shape[1]} columns — the feature shard "
                "must be a one-hot column indicator")
        return MatrixFactorizationModel(
            row_effect_type=model.random_effect_type,
            col_effect_type=col_effect_type,
            row_factors=model.latent_coefficients,
            row_ids=model.entity_ids,
            col_factors=model.projection.T,
            col_ids=np.asarray(col_ids))


CoordinateModel = (FixedEffectModel | RandomEffectModel
                   | FactoredRandomEffectModel | MatrixFactorizationModel)


@dataclasses.dataclass
class GameModel:
    """Ordered coordinate -> model map; the total score is the sum
    (reference: GameModel.scala:32-168, with its consistent-task check)."""

    coordinates: Dict[str, CoordinateModel]
    task_type: str

    def __post_init__(self):
        for name, m in self.coordinates.items():
            if m.task_type not in (self.task_type, "none"):
                raise ValueError(
                    f"coordinate {name!r} has task {m.task_type!r}, "
                    f"expected {self.task_type!r} (reference: GameModel task "
                    "consistency check)")

    @property
    def loss(self) -> L.PointwiseLoss:
        return L.TASK_LOSSES[self.task_type]

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        """Sum of coordinate margins."""
        total = None
        for m in self.coordinates.values():
            s = m.score_dataset(dataset)
            total = s if total is None else total + s
        if total is None:
            return torch.zeros(dataset.num_rows, dtype=torch.float64)
        return total

    def predict(self, dataset: GameDataset) -> torch.Tensor:
        z = self.score_dataset(dataset)
        if dataset.offsets is not None:
            z = z + torch.as_tensor(dataset.offsets, device=z.device, dtype=z.dtype)
        return self.loss.mean(z)
