"""GAME model containers: fixed effect, random effect and the composite
(port of photon_ml_tpu/models/game.py).

A model's score is ITS margin contribution only (no base offset: evaluators
add score + offset), and rows whose entity a random-effect model does not
know contribute 0, the reference's missing-score default.  Models score on
the device and in the dtype of their coefficients.

The factored random-effect and matrix-factorization models are not ported
yet (ROADMAP.md queue A item 13, BASELINE config 5).
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
    scatter_local_to_global, score_entities_plain, score_entities_scatter,
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

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    def global_coefficients(self) -> torch.Tensor:
        """[E, d_global] via scatter along the projection columns."""
        return scatter_local_to_global(self.coefficients, self.projection,
                                       self.global_dim)

    def lanes_for(self, dataset: GameDataset) -> np.ndarray:
        return _lanes_for(dataset, self.random_effect_type, self.entity_ids)

    def _cached(self, dataset: GameDataset, kind: str, source, build):
        """Device copy of `build()`, memoized on the dataset while `source`
        (a host array the models of one coordinate share) stays the same."""
        c = self.coefficients
        key = (kind, self.random_effect_type, str(c.device))
        hit = dataset._scoring_cache.get(key)
        if hit is None or hit[0] is not source:
            hit = (source, torch.as_tensor(build(), device=c.device))
            dataset._scoring_cache[key] = hit
        return hit[1]

    def score_dataset(self, dataset: GameDataset) -> torch.Tensor:
        c = self.coefficients
        x = dataset.device_shard(self.feature_shard, c.device, c.dtype)
        lanes = self._cached(dataset, "lanes", self.entity_ids,
                             lambda: self.lanes_for(dataset))
        if self.projection is not None:
            proj = self._cached(dataset, "proj", self.projection,
                                lambda: self.projection)
            return score_entities_scatter(c, proj, x, lanes,
                                          global_dim=self.global_dim)
        return score_entities_plain(c, x, lanes)


CoordinateModel = FixedEffectModel | RandomEffectModel


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
