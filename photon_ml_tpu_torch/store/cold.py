"""Cold tier: durable, manifest-sealed row segments on disk — the PalDB
analog (a copy of photon_ml_tpu/store/cold.py: host numpy, byte-compatible
segment files and seals, so a store either package wrote opens in the
other).  Photon ML kept per-entity coefficients in PalDB, an off-heap
store, while GAME iterated (PAPER.md); this module is that durability
floor for the tiered entity store: the FULL row table lives here in
fixed-size segment files, each sealed by a manifest sidecar carrying its
byte size and sha256, written LAST with the atomic tmp+fsync+replace
discipline (utils/durable.py).  At any instant a
segment path holds either the complete old bytes or the complete new
bytes; a torn write is detected by the seal, never trusted.

Reads verify the sha256 once per (open, segment) — a verified segment is
trusted until a spill overwrites it — so steady-state fetches pay one
hash per segment fault-in, not per row.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.utils import durable

_META = "meta.json"


def _seg_name(si: int) -> str:
    return f"seg-{si:05d}.bin"


def _seal_name(si: int) -> str:
    return f"seg-{si:05d}.json"


class ColdStoreError(RuntimeError):
    """A cold segment failed verification (missing, torn, or tampered).
    NOT transient: retrying a corrupt read returns the same corrupt
    bytes — the store surfaces this as a fatal store.fetch failure."""

    transient = False


class ColdStore:
    """One durable row table `[rows, dim]` as `ceil(rows/seg_rows)`
    sealed segment files.  Not thread-safe by itself: the owning
    TieredEntityStore serializes access (reads happen outside its lock,
    but never two writers on one segment)."""

    def __init__(self, directory: str, rows: int, dim: int,
                 dtype: np.dtype, seg_rows: int,
                 entity_ids: Optional[np.ndarray] = None):
        self.directory = directory
        self.rows = int(rows)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.seg_rows = int(seg_rows)
        self.entity_ids = entity_ids
        if self.rows <= 0 or self.dim <= 0 or self.seg_rows <= 0:
            raise ValueError("rows, dim and seg_rows must be positive")
        self._verified: set = set()

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, directory: str, table: np.ndarray, seg_rows: int,
               entity_ids: Optional[np.ndarray] = None) -> "ColdStore":
        """Write a full table as sealed segments (the store bootstrap:
        every row starts cold; warm/hot fill from traffic)."""
        table = np.ascontiguousarray(table)
        if table.ndim != 2:
            raise ValueError(f"table must be [rows, dim], got {table.shape}")
        os.makedirs(directory, exist_ok=True)
        store = cls(directory, table.shape[0], table.shape[1], table.dtype,
                    seg_rows, entity_ids=entity_ids)
        for si in range(store.num_segments):
            lo, hi = store.segment_span(si)
            store.write_segment(si, table[lo:hi], fsync=False)
        meta = {"format_version": 1, "rows": store.rows, "dim": store.dim,
                "dtype": store.dtype.name, "seg_rows": store.seg_rows}
        if entity_ids is not None:
            if len(entity_ids) != store.rows:
                raise ValueError("entity_ids must have one id per row")
            meta["entity_ids"] = [str(v) for v in np.asarray(entity_ids)]
        durable.atomic_write_json(os.path.join(directory, _META), meta)
        return store

    @classmethod
    def open(cls, directory: str) -> "ColdStore":
        meta_path = os.path.join(directory, _META)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise ColdStoreError(
                f"cold store at {directory!r} has no readable {_META} "
                "(not a sealed store, or torn before the final meta "
                "write)") from e
        ids = meta.get("entity_ids")
        return cls(directory, meta["rows"], meta["dim"],
                   np.dtype(meta["dtype"]), meta["seg_rows"],
                   entity_ids=(np.asarray(ids, dtype=object)
                               if ids is not None else None))

    # -- geometry ----------------------------------------------------------

    @property
    def num_segments(self) -> int:
        return -(-self.rows // self.seg_rows)

    def segment_of(self, row: int) -> int:
        return row // self.seg_rows

    def segment_span(self, si: int) -> Tuple[int, int]:
        lo = si * self.seg_rows
        return lo, min(lo + self.seg_rows, self.rows)

    # -- durable IO --------------------------------------------------------

    def write_segment(self, si: int, values: np.ndarray,
                      fsync: bool = True) -> None:
        """Durably replace one segment (the spill path): bytes via
        tmp+fsync+replace, then the sha256 seal written LAST — a crash
        between the two leaves the old seal refusing the new bytes, which
        a re-spill repairs."""
        lo, hi = self.segment_span(si)
        values = np.ascontiguousarray(values, dtype=self.dtype)
        if values.shape != (hi - lo, self.dim):
            raise ValueError(
                f"segment {si} holds rows [{lo}, {hi}): values must be "
                f"[{hi - lo}, {self.dim}], got {values.shape}")
        raw = values.tobytes()
        path = os.path.join(self.directory, _seg_name(si))
        durable.atomic_write_bytes(path, raw, fsync=fsync)
        durable.atomic_write_json(
            os.path.join(self.directory, _seal_name(si)),
            {"bytes": len(raw), "sha256": hashlib.sha256(raw).hexdigest(),
             "rows": hi - lo, "row0": lo}, fsync=fsync)
        self._verified.discard(si)

    def read_segment(self, si: int) -> np.ndarray:
        """One segment's rows, sha256-verified against the seal on the
        first read since open/overwrite.

        A CONCURRENT spill replaces the bytes file and the seal file as
        two atomic renames, so a read landing between them sees new
        bytes under the old seal: on mismatch the read re-reads (bytes
        AND seal) a couple of times before concluding — a replace pair
        completes in microseconds, a genuinely torn or tampered segment
        stays mismatched and raises ColdStoreError (fatal, never
        retried into service)."""
        lo, hi = self.segment_span(si)
        path = os.path.join(self.directory, _seg_name(si))
        seal_path = os.path.join(self.directory, _seal_name(si))
        verify = si not in self._verified
        last_err = None
        for attempt in range(3):
            if attempt:
                time.sleep(0.02 * attempt)
            with open(path, "rb") as f:
                raw = f.read()
            if not verify:
                break
            try:
                with open(seal_path) as f:
                    seal = json.load(f)
            except (OSError, ValueError) as e:
                last_err = ColdStoreError(
                    f"cold segment {si} of {self.directory!r} has no "
                    "readable seal — torn spill or unsealed store")
                last_err.__cause__ = e
                continue
            if seal["bytes"] == len(raw) and \
                    seal["sha256"] == hashlib.sha256(raw).hexdigest():
                self._verified.add(si)
                last_err = None
                break
            last_err = ColdStoreError(
                f"cold segment {si} of {self.directory!r} failed "
                f"sha256 verification ({len(raw)} bytes on disk vs "
                f"{seal['bytes']} sealed) — torn or tampered; refusing "
                "to serve corrupt rows")
        if last_err is not None:
            raise last_err
        return np.frombuffer(raw, dtype=self.dtype).reshape(
            hi - lo, self.dim).copy()

    def read_table(self) -> np.ndarray:
        """The full cold table (audit / training materialization — one
        deliberate full read, never on the serving path)."""
        out = np.empty((self.rows, self.dim), self.dtype)
        for si in range(self.num_segments):
            lo, hi = self.segment_span(si)
            out[lo:hi] = self.read_segment(si)
        return out

    def seal_report(self) -> Dict[str, Dict]:
        """Per-segment seal metadata (bench/debug accounting)."""
        out: Dict[str, Dict] = {}
        for si in range(self.num_segments):
            with open(os.path.join(self.directory, _seal_name(si))) as f:
                out[_seg_name(si)] = json.load(f)
        return out
