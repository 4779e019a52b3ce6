"""Entity-sharded serving: the shard map and the margin-merge algebra (a
copy of photon_ml_tpu/fleet/shards.py: host numpy).

Photon ML scaled GAME *training* by sharding per-entity random-effect
sub-problems across executors; this module applies the same partitioning
one level up, to the serving fleet's MEMORY.  A `ShardSpec` deterministically
assigns every entity id to one of `num_shards` shards (sha256 of
``salt:version:id`` — no coordination, no lookup table, stable across
processes and machines), and is versioned + carried on the replication log
(record kind ``shard_map``) so the whole fleet provably agrees on the
partition.  A replica built with a `ShardAssignment` holds only its owned
slice of every random-effect table (fixed-effect and matrix-factorization
coordinates are small and replicated everywhere), filters replicated
deltas/row-state to owned rows, and sizes its tiered-store residency to
the slice — so a 4-shard fleet serves a random-effect space ~4x one
replica's budget.

The merge algebra (`merge_margins`) is what makes fan-out scoring
BIT-IDENTICAL to a monolithic replica: the scorer's compiled program folds
per-coordinate margins with a fixed sequential add chain (FE, then each
RE coordinate in model order, then MF) in the device COMPUTE dtype.
Floating-point addition is commutative but not associative, so a naive
"sum the shard partial scores" merge is NOT exact once a request row
touches two RE coordinates owned by different shards.  Instead every
shard leg returns its PER-COORDINATE margins in the compute dtype; the
front selects, per row and per RE coordinate, the margin computed by the
shard that OWNS that row's entity (the others hold no row for it and
contribute exactly 0.0 — including the sign of a -0.0 the owner
computed), takes FE/MF margins from one designated primary leg, and
re-folds the chain host-side in the same dtype, same order, same
IEEE-754 adds.  Identical operands + identical fold order = identical
bits; the final cast to f64 mirrors the scorer's own output cast.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class ShardMergeError(ValueError):
    """A fan-out merge cannot be completed exactly (missing leg for a
    needed coordinate/owner under the "error" degradation policy, or
    legs that disagree on the coordinate fold order)."""


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The fleet-wide entity partition: pure function of (salt, version,
    num_shards) — every process that holds the same spec assigns every
    entity id to the same shard, forever."""

    num_shards: int
    salt: str = "photon"
    version: int = 1

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")

    def shard_of(self, entity_id) -> int:
        """entity id -> owning shard index in [0, num_shards)."""
        key = f"{self.salt}:{self.version}:{entity_id}".encode()
        h = hashlib.sha256(key).digest()
        return int.from_bytes(h[:8], "big") % self.num_shards

    def owned_mask(self, entity_ids: Iterable, shard_index: int
                   ) -> np.ndarray:
        """Boolean mask over `entity_ids`: True where this shard owns."""
        idx = int(shard_index)
        return np.asarray([self.shard_of(e) == idx for e in entity_ids],
                          dtype=bool)

    def spec_id(self) -> str:
        """Short content hash — what the shard_map log record and the
        fleet agreement checks compare."""
        return hashlib.sha256(
            f"{self.num_shards}:{self.salt}:{self.version}"
            .encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"num_shards": self.num_shards, "salt": self.salt,
                "version": self.version, "spec_id": self.spec_id()}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardSpec":
        spec = cls(num_shards=int(d["num_shards"]),
                   salt=str(d.get("salt", "photon")),
                   version=int(d.get("version", 1)))
        want = d.get("spec_id")
        if want is not None and want != spec.spec_id():
            raise ValueError(
                f"shard spec_id mismatch: record says {want!r} but "
                f"{spec!r} hashes to {spec.spec_id()!r} — the fleet is "
                "running incompatible shard-map builds")
        return spec


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """One replica's slice of the partition: the fleet-wide spec plus
    this replica's shard index."""

    spec: ShardSpec
    index: int

    def __post_init__(self):
        if not (0 <= self.index < self.spec.num_shards):
            raise ValueError(
                f"shard index {self.index} out of range for "
                f"{self.spec.num_shards} shards")

    def owns(self, entity_id) -> bool:
        return self.spec.shard_of(entity_id) == self.index

    def to_dict(self) -> dict:
        return {"index": self.index, **self.spec.to_dict()}


def shards_touched(spec: ShardSpec,
                   coordinates: Sequence[dict],
                   ids: Dict[str, Sequence]) -> List[int]:
    """The shards a request actually needs for its random-effect
    coordinates: {shard_of(id) for every RE coordinate's entity ids}.
    `coordinates` is the scorer's coordinate_meta() (ordered dicts with
    "kind" and, for RE entries, "entity_type")."""
    touched = set()
    for meta in coordinates:
        if meta.get("kind") != "random":
            continue
        for e in np.asarray(ids.get(meta["entity_type"], ())).tolist():
            touched.add(spec.shard_of(e))
    return sorted(touched)


def merge_margins(spec: ShardSpec,
                  coordinates: Sequence[dict],
                  ids: Dict[str, Sequence],
                  legs: Dict[int, Dict[str, np.ndarray]],
                  primary: int,
                  *,
                  missing_policy: str = "error",
                  ) -> Dict[str, object]:
    """Fold per-shard margin legs back into total scores, bit-identically
    to the monolithic scorer's device add chain.

    `legs` maps shard index -> {coordinate name -> [n] margins in the
    scorer's compute dtype — CompiledScorer.score_margins output} (each
    leg scored the SAME request).  `primary` names the leg FE/MF margins
    are taken from (every shard replicates those coordinates in full, so
    any healthy leg is exact; the front passes its lowest-index healthy
    shard).  For each RE coordinate the per-row margin is taken from the
    row's OWNING shard's leg — the bit-exact monolithic value, since the
    owner's partial table holds the identical row and the identical
    compiled dot program produced the margin.

    Rows whose owner leg is absent (that shard is down): under
    ``missing_policy="error"`` raise `ShardMergeError`; under
    ``"partial"`` the missing contribution folds as exactly 0.0 — the
    same value an UNSEEN entity contributes — and the row is reported in
    ``partial_rows``.  Returns {"scores": [n] f64, "partial_rows":
    sorted row indices, "missing_shards": sorted shard indices}.
    """
    if primary not in legs:
        raise ShardMergeError(
            f"primary leg (shard {primary}) is missing from the merge")
    if missing_policy not in ("error", "partial"):
        raise ValueError(f"unknown missing_policy {missing_policy!r}")
    prim = legs[primary]
    n = dtype = None
    for name, m in prim.items():
        m = np.asarray(m)
        if n is None:
            n, dtype = int(m.shape[0]), m.dtype
        elif int(m.shape[0]) != n:
            raise ShardMergeError(
                f"primary leg margin {name!r} has {m.shape[0]} rows, "
                f"expected {n}")
    if n is None:
        raise ShardMergeError("primary leg carries no margins")
    scores = np.zeros(n, dtype)
    partial_rows: set = set()
    missing_shards: set = set()
    for meta in coordinates:
        name = meta["name"]
        if name not in prim:
            raise ShardMergeError(
                f"primary leg is missing margins for coordinate {name!r}")
        if meta.get("kind") != "random":
            contrib = np.asarray(prim[name], dtype)
        else:
            owners = [spec.shard_of(e) for e in
                      np.asarray(ids[meta["entity_type"]]).tolist()]
            if len(owners) != n:
                raise ShardMergeError(
                    f"ids[{meta['entity_type']!r}] has {len(owners)} "
                    f"rows, margins have {n}")
            contrib = np.zeros(n, dtype)
            for i, owner in enumerate(owners):
                leg = legs.get(owner)
                if leg is None:
                    missing_shards.add(owner)
                    if missing_policy == "error":
                        raise ShardMergeError(
                            f"shard {owner} (owner of row {i}'s "
                            f"{meta['entity_type']!r} entity) has no "
                            "healthy replica and the degradation policy "
                            "is 'error'")
                    partial_rows.add(i)
                    continue  # folds as exactly 0.0, like an unseen id
                contrib[i] = np.asarray(leg[name])[i]
        # the same sequential per-coordinate add chain the compiled
        # scorer folds on device, in the same compute dtype: identical
        # operands, identical order, identical bits
        scores = scores + contrib
    return {"scores": np.asarray(scores, np.float64),
            "partial_rows": sorted(partial_rows),
            "missing_shards": sorted(missing_shards)}
