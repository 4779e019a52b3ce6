"""GAME dataset: struct-of-arrays with a fixed canonical row order (port of
photon_ml_tpu/data/game_data.py).

The uid IS the row position: every coordinate keeps its scores as a dense
[n] tensor in this canonical order, so coordinate descent's score algebra
is elementwise tensor arithmetic.  Entity membership per random-effect type
is an int index column (`entity_indices[re_type][row]`), built once at
ingest.

Host columns are numpy (a feature shard may be a scipy CSR matrix);
`device_shard` makes the one device copy of a feature shard that every
consumer shares: a dense tensor, or a PaddedSparse for a CSR shard.
`save_game_dataset`/`load_game_dataset` keep the JAX package's npz layout,
so either package loads the other's file.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.index_map import IndexMap


def _is_sparse(x) -> bool:
    try:
        import scipy.sparse as sp
        return sp.issparse(x)
    except ImportError:  # pragma: no cover
        return False


@dataclasses.dataclass
class InputColumnNames:
    """Remappable input column names (reference: InputColumnsNames.scala)."""

    response: str = "response"
    offset: str = "offset"
    weight: str = "weight"
    uid: str = "uid"


@dataclasses.dataclass(eq=False)  # identity semantics: holds arrays, and the
# random-effect build memo (data/batching.py) weak-keys on dataset identity
class GameDataset:
    """n rows in canonical order; everything else hangs off row position."""

    response: np.ndarray                       # [n] float
    feature_shards: Dict[str, np.ndarray]      # shard -> [n, d_shard] float or CSR
    offsets: Optional[np.ndarray] = None       # [n]
    weights: Optional[np.ndarray] = None       # [n]
    # re_type -> [n] int index into entity_vocabs[re_type]; -1 = missing id
    entity_indices: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # re_type -> [num_entities] entity id values (row i of a random-effect
    # model belongs to entity_vocabs[re_type][i])
    entity_vocabs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # shard -> IndexMap ((name, term) <-> column), when the input named its
    # features (Avro ingest, or maps saved beside the data)
    index_maps: Dict[str, IndexMap] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        n = len(self.response)
        for shard, x in self.feature_shards.items():
            if x.shape[0] != n:
                raise ValueError(f"shard {shard!r} has {x.shape[0]} rows, expected {n}")
        for re_type, idx in self.entity_indices.items():
            if len(idx) != n:
                raise ValueError(f"entity index {re_type!r} has {len(idx)} rows, expected {n}")

    # (shard, device, dtype) -> the device copy, made once and shared by
    # every consumer (coordinate training, scoring, validation rescoring)
    _device_shards: Dict[tuple, object] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # scoring-side memos (entity-lane maps etc.), keyed by consumer
    _scoring_cache: Dict[object, object] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def device_shard(self, shard: str, device=None,
                     dtype: torch.dtype = torch.float32, with_csc: bool = False):
        """The shard on `device` (None means cuda) in `dtype`, built once per
        (shard, device, dtype) and shared: a contiguous dense tensor, or a
        PaddedSparse for a CSR shard.  `with_csc` asks for the sparse
        gradient's column view (ops/features.py as_feature_matrix); once
        attached, it stays on the shared copy."""
        from photon_ml_tpu_torch.ops.features import PaddedSparse, as_feature_matrix
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # "cuda" and "cuda:<current>" name one device: one shared copy
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (shard, str(dev), dtype)
        x = self._device_shards.get(key)
        if x is None:
            x = as_feature_matrix(self.feature_shards[shard], dev, dtype,
                                  with_csc=with_csc)
            if not isinstance(x, PaddedSparse):
                x = x.contiguous()
        elif with_csc and isinstance(x, PaddedSparse) and not x.has_csc:
            x = as_feature_matrix(x, dev, dtype, with_csc=True)
        self._device_shards[key] = x
        return x

    def release_device_shard(self, shard: str) -> None:
        """Drop the shared device copies of a shard (the host copy stays the
        source): streaming stages chunks from the host, and the residency
        manager's rotation evicts between visits."""
        for key in [k for k in self._device_shards if k[0] == shard]:
            del self._device_shards[key]

    @property
    def num_rows(self) -> int:
        return len(self.response)

    def num_entities(self, re_type: str) -> int:
        return len(self.entity_vocabs[re_type])

    def shard_dim(self, shard: str) -> int:
        return self.feature_shards[shard].shape[1]

    def subset(self, rows: np.ndarray) -> "GameDataset":
        """Row slice sharing vocabularies (for train/validation splits)."""
        take = lambda a: None if a is None else a[rows]
        return GameDataset(
            response=self.response[rows],
            feature_shards={s: x[rows] for s, x in self.feature_shards.items()},
            offsets=take(self.offsets),
            weights=take(self.weights),
            entity_indices={t: idx[rows] for t, idx in self.entity_indices.items()},
            entity_vocabs=self.entity_vocabs,
            index_maps=self.index_maps,
        )


def save_game_dataset(dataset: GameDataset, path: str) -> None:
    """Columnar npz persistence of a GameDataset, in the JAX package's
    layout: `response`, `offsets`, `weights`, `shard::<s>` (dense),
    `spshard::<s>::{data,indices,indptr,shape}` (CSR), `entidx::<t>` and
    `entvocab::<t>` (object arrays, as the JAX package writes them)."""
    arrays = {"response": dataset.response}
    if dataset.offsets is not None:
        arrays["offsets"] = dataset.offsets
    if dataset.weights is not None:
        arrays["weights"] = dataset.weights
    for s, x in dataset.feature_shards.items():
        if _is_sparse(x):
            if "::" in s:
                raise ValueError(
                    f"sparse shard name {s!r} may not contain '::' (it is "
                    "the npz key delimiter)")
            csr = x.tocsr()
            arrays[f"spshard::{s}::data"] = csr.data
            arrays[f"spshard::{s}::indices"] = csr.indices
            arrays[f"spshard::{s}::indptr"] = csr.indptr
            arrays[f"spshard::{s}::shape"] = np.asarray(csr.shape)
        else:
            arrays[f"shard::{s}"] = x
    for t, idx in dataset.entity_indices.items():
        arrays[f"entidx::{t}"] = idx
        arrays[f"entvocab::{t}"] = np.asarray(dataset.entity_vocabs[t]).astype(object)
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_game_dataset(path: str) -> GameDataset:
    """The dataset `save_game_dataset` (of either package) wrote.  The
    entity vocabularies are object arrays, so the file is read with
    `allow_pickle=True`, as the JAX package reads it: load only files you
    trust."""
    z = np.load(path if path.endswith(".npz") else path + ".npz",
                allow_pickle=True)
    shards, entidx, entvocab = {}, {}, {}
    sp_names = {k.split("::")[1] for k in z.files if k.startswith("spshard::")}
    for s in sp_names:
        import scipy.sparse as sp
        shards[s] = sp.csr_matrix(
            (z[f"spshard::{s}::data"], z[f"spshard::{s}::indices"],
             z[f"spshard::{s}::indptr"]),
            shape=tuple(z[f"spshard::{s}::shape"]))
    for k in z.files:
        if k.startswith("shard::"):
            shards[k[7:]] = z[k]
        elif k.startswith("entidx::"):
            entidx[k[8:]] = z[k]
        elif k.startswith("entvocab::"):
            entvocab[k[10:]] = z[k]
    return GameDataset(
        response=z["response"],
        feature_shards=shards,
        offsets=z["offsets"] if "offsets" in z.files else None,
        weights=z["weights"] if "weights" in z.files else None,
        entity_indices=entidx,
        entity_vocabs=entvocab)


def build_game_dataset(
    response: np.ndarray,
    feature_shards: Dict[str, np.ndarray],
    *,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    entity_ids: Optional[Dict[str, np.ndarray]] = None,
    entity_vocabs: Optional[Dict[str, np.ndarray]] = None,
    index_maps: Optional[Dict[str, IndexMap]] = None,
) -> GameDataset:
    """Raw id columns -> indexed entity columns.

    `entity_ids[re_type]` is a [n] array of raw ids; ids are interned into
    a sorted vocabulary unless a shared vocab is supplied (scoring against a
    trained model's entity space, where unseen ids map to -1)."""
    entity_indices, vocabs = {}, {}
    for re_type, ids in (entity_ids or {}).items():
        ids = np.asarray(ids)
        if entity_vocabs and re_type in entity_vocabs:
            vocab = np.asarray(entity_vocabs[re_type])
            lookup = {v: i for i, v in enumerate(vocab.tolist())}
            idx = np.asarray([lookup.get(v, -1) for v in ids.tolist()],
                             dtype=np.int32)
        else:
            vocab, idx = np.unique(ids, return_inverse=True)
            idx = idx.astype(np.int32)
        entity_indices[re_type] = idx
        vocabs[re_type] = vocab
    return GameDataset(
        response=np.asarray(response, dtype=np.float64),
        # scipy.sparse shards stay sparse (CSR); device_shard makes them
        # PaddedSparse
        feature_shards={s: (x.tocsr() if _is_sparse(x) else np.asarray(x))
                        for s, x in feature_shards.items()},
        offsets=None if offsets is None else np.asarray(offsets, dtype=np.float64),
        weights=None if weights is None else np.asarray(weights, dtype=np.float64),
        entity_indices=entity_indices,
        entity_vocabs=vocabs,
        index_maps=index_maps or {},
    )
