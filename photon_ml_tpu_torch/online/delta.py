"""ModelDelta: row-level model updates for the live scorer (a copy of
photon_ml_tpu/online/delta.py, numpy only).

A delta is the ONLINE counterpart of a full-model hot swap: instead of
building + warming a whole new CompiledScorer, it carries only the CHANGED
rows of the stacked random-effect tables (per coordinate: row indices, new
row values, and the pre-delta row values for exact rollback) plus a version
vector `(base_version, seq)` that pins which full-model version the rows
were solved against — the registry refuses to scatter a delta onto any
other version (StaleDeltaError), because rows solved against stale
residual margins would silently corrupt the live table.

This module is deliberately dependency-light (numpy only): deltas cross
process boundaries (models/io.py serializes them, byte-compatible with
the JAX package's) and must stay importable without pulling in the
serving stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class CoordinateDelta:
    """Changed rows of ONE coordinate's stacked [E, d] table."""

    rows: np.ndarray        # [k] int table-row indices (unique)
    values: np.ndarray      # [k, d] new row values
    prior: np.ndarray       # [k, d] pre-delta row values (rollback source)

    def __post_init__(self):
        self.rows = np.asarray(self.rows, dtype=np.int64)
        self.values = np.asarray(self.values)
        self.prior = np.asarray(self.prior)
        if self.rows.ndim != 1:
            raise ValueError(f"rows must be [k], got shape {self.rows.shape}")
        k = len(self.rows)
        for name, a in (("values", self.values), ("prior", self.prior)):
            if a.ndim != 2 or a.shape[0] != k:
                raise ValueError(
                    f"{name} must be [{k}, d], got shape {a.shape}")
        if self.values.shape != self.prior.shape:
            raise ValueError(
                f"values {self.values.shape} and prior {self.prior.shape} "
                "must agree")
        if len(np.unique(self.rows)) != k:
            raise ValueError("delta rows must be unique (duplicate row "
                             "updates within one delta are ambiguous)")
        if (self.rows < 0).any():
            raise ValueError("delta rows must be non-negative table indices")

    @property
    def num_rows(self) -> int:
        return len(self.rows)


@dataclasses.dataclass
class ModelDelta:
    """Row updates for one or more coordinates + the version vector.

    `base_version` is the full-model version the rows were solved against
    (and the only version they may be applied to); `seq` is the publisher's
    monotonically increasing delta sequence number within that version —
    together they form the version vector surfaced on /healthz and in
    ServingMetrics."""

    base_version: str
    seq: int
    coordinates: Dict[str, CoordinateDelta]
    created_at: float = 0.0          # wall-clock time.time() at build
    #: cross-process trace metadata (telemetry.distributed): the sampled
    #: propagated request ids this delta aggregates, the publisher's
    #: update-cycle span ref, and the oldest intake wall time — rides the
    #: replication record so replica applies join the same trace tree.
    #: Optional and JSON-plain; bit-identity of the model state never
    #: depends on it.
    trace: Dict[str, object] = None

    def __post_init__(self):
        if not self.coordinates:
            raise ValueError("a ModelDelta must update at least one "
                             "coordinate")

    @property
    def num_rows(self) -> int:
        return sum(cd.num_rows for cd in self.coordinates.values())

    def version_vector(self) -> Dict[str, object]:
        return {"base_version": self.base_version, "delta_seq": self.seq}

    def summary(self) -> str:
        per = ", ".join(f"{name}:{cd.num_rows}"
                        for name, cd in sorted(self.coordinates.items()))
        return (f"ModelDelta(base={self.base_version}, seq={self.seq}, "
                f"rows=[{per}])")

    # -- flat array form (what models/io.py persists) ----------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten to named numpy arrays (npz-ready); metadata rides
        separately (models/io.save_model_delta)."""
        out: Dict[str, np.ndarray] = {}
        for name, cd in self.coordinates.items():
            if "::" in name:
                raise ValueError(f"coordinate name {name!r} may not contain "
                                 "'::' (the array-key delimiter)")
            out[f"delta::{name}::rows"] = cd.rows
            out[f"delta::{name}::values"] = cd.values
            out[f"delta::{name}::prior"] = cd.prior
        return out

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray], base_version: str,
                    seq: int, created_at: float = 0.0) -> "ModelDelta":
        names = {k.split("::")[1] for k in arrays if k.startswith("delta::")}
        coords = {
            name: CoordinateDelta(rows=arrays[f"delta::{name}::rows"],
                                  values=arrays[f"delta::{name}::values"],
                                  prior=arrays[f"delta::{name}::prior"])
            for name in sorted(names)}
        return ModelDelta(base_version=base_version, seq=seq,
                          coordinates=coords, created_at=created_at)
