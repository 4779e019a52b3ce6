"""Feature index maps: (name, term) <-> dense column index
(a copy of photon_ml_tpu/data/index_map.py; host code).

Rebuild of the reference's feature-identity machinery:
  - NameAndTerm / feature-key building (photon-client/.../data/avro/NameAndTerm.scala,
    util/Utils.getFeatureKey — key = name + DELIMITER + term)
  - IndexMap / DefaultIndexMap / DefaultIndexMapLoader
    (photon-api/.../util/{IndexMap,DefaultIndexMap,DefaultIndexMapLoader}.scala)
  - PalDBIndexMap + FeatureIndexingJob (photon-api/.../util/PalDBIndexMap.scala:43-278,
    photon-client/.../FeatureIndexingJob.scala:56-307)

The PalDB off-heap store existed because JVM heaps choke on 1e8-entry hash
maps; here a plain columnar file (npz of two string arrays + json metadata)
holds the same map compactly, memory-maps instantly, and needs no partition
offset arithmetic.  The INTERCEPT pseudo-feature matches the reference's
Constants.INTERCEPT_KEY convention: always present, always the LAST index
(so factor/shift pinning and warm starts stay aligned).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

DELIMITER = "\x01"       # reference: Constants name.term delimiter
INTERCEPT_NAME = "(INTERCEPT)"  # reference: Constants intercept key
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER


def feature_key(name: str, term: str = "") -> str:
    """reference: Utils.getFeatureKey — identity is the (name, term) pair."""
    return f"{name}{DELIMITER}{term}"


@dataclasses.dataclass
class IndexMap:
    """Immutable bidirectional feature map for one feature shard."""

    key_to_index: Dict[str, int]
    index_to_key: np.ndarray  # [d] object array of keys

    @property
    def size(self) -> int:
        return len(self.index_to_key)

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self.key_to_index

    @property
    def intercept_index(self) -> Optional[int]:
        return self.key_to_index.get(INTERCEPT_KEY)

    def index_of(self, name: str, term: str = "") -> int:
        """-1 for unseen features (reference IndexMap.getIndex miss -> -1)."""
        return self.key_to_index.get(feature_key(name, term), -1)

    def key_of(self, index: int) -> str:
        return str(self.index_to_key[index])

    def name_term(self, index: int) -> tuple[str, str]:
        name, _, term = self.key_of(index).partition(DELIMITER)
        return name, term

    # -- persistence (replaces PalDB store files) -----------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                            keys=self.index_to_key.astype(object))

    @staticmethod
    def load(path: str) -> "IndexMap":
        data = np.load(path if path.endswith(".npz") else path + ".npz",
                       allow_pickle=True)
        keys = data["keys"]
        return IndexMap({str(k): i for i, k in enumerate(keys)}, keys)

    @staticmethod
    def from_keys(keys: Sequence[str], add_intercept: bool = True) -> "IndexMap":
        """Deterministic map: sorted unique keys, intercept last.

        reference: FeatureIndexingJob builds per-partition sorted distinct
        feature names; sorting here gives run-to-run determinism without the
        hash-partition offset bookkeeping."""
        uniq = sorted(set(keys) - {INTERCEPT_KEY})
        if add_intercept:
            uniq.append(INTERCEPT_KEY)
        arr = np.asarray(uniq, dtype=object)
        return IndexMap({k: i for i, k in enumerate(uniq)}, arr)


def build_index_map(
    feature_names: Iterable[tuple[str, str]], add_intercept: bool = True,
) -> IndexMap:
    """FeatureIndexingJob equivalent: scan (name, term) pairs -> IndexMap.
    reference: FeatureIndexingJob.partitionedUniqueFeatures (line 92-138)."""
    return IndexMap.from_keys([feature_key(n, t) for n, t in feature_names],
                              add_intercept=add_intercept)


@dataclasses.dataclass
class IndexMapCollection:
    """Per-feature-shard maps + metadata file (replaces the per-shard PalDB
    namespace dirs of FeatureIndexingJob)."""

    shards: Dict[str, IndexMap]

    def save(self, directory: str) -> None:
        from photon_ml_tpu_torch.utils.durable import atomic_write_json
        os.makedirs(directory, exist_ok=True)
        meta = {"shards": sorted(self.shards)}
        atomic_write_json(os.path.join(directory, "index-maps.json"), meta)
        for shard, imap in self.shards.items():
            imap.save(os.path.join(directory, f"{shard}.index.npz"))

    @staticmethod
    def load(directory: str) -> "IndexMapCollection":
        with open(os.path.join(directory, "index-maps.json")) as f:
            meta = json.load(f)
        return IndexMapCollection({
            shard: IndexMap.load(os.path.join(directory, f"{shard}.index.npz"))
            for shard in meta["shards"]})
