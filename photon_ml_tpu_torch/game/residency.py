"""HBM residency budget: decide what lives on the device, evict what does
not fit (port of photon_ml_tpu/game/residency.py).

The resident trainer pins every coordinate's device blocks (FE feature
shards, RE entity blocks) for the whole fit.  With a budget
(GameTrainingConfig.hbm_budget_bytes / `--hbm-budget`) this manager applies
the hierarchy of Snap ML's memory manager (arXiv:1803.06333):

  1. Flat [n] vectors (residual scores, labels, weights, offsets) always
     stay on the device.
  2. A fixed-effect shard whose resident footprint busts the budget runs
     streamed (ChunkedGLMObjective: host shard, two chunks of device
     memory); the per-coordinate `stream` snapshots in `accounting()` show
     the work per staged byte.
  3. When the remaining resident coordinates still exceed the budget, the
     descent loop rotates residency: after a coordinate's update and score
     its device blocks are evicted and re-staged on its next visit (host
     copies kept by keep_host_blocks).

The eviction mechanism is the store's (store/handles.py BlockStore: the
`store.fetch` fault site and the retry discipline on every re-stage); this
manager keeps the policy: the budget math, the evict-inactive decision and
the peak accounting.

On a mesh the budget is PER DEVICE: coordinate blocks shard their leading
axis over the mesh "data" axis, so each rank holds 1/D of every block, and
a streamed coordinate's double buffer is the rank's two chunk blocks (its
plan is built with row_multiple = D); each rank reports its own record.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional

from photon_ml_tpu_torch.store.handles import BlockStore

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass
class CoordinateFootprint:
    name: str
    block_bytes: int            # evictable device blocks (FE shard / RE blocks)
    streamed: bool              # FE chunk streaming (blocks never resident)
    chunk_bytes: int = 0        # 2-chunk double-buffer cost when streamed


class ResidencyManager:
    """Tracks per-coordinate device footprints against the budget and runs
    the eviction rotation inside run_coordinate_descent, through the store's
    block handles.

    Each coordinate exposes `device_block_bytes()`, `evict_device_blocks()`
    and (streamed FE) `streaming_buffer_bytes()` and `stream_snapshot()`.
    Eviction only happens when the budget cannot hold every non-streamed
    coordinate at once; otherwise the manager only keeps accounts and the
    fit runs exactly as without it."""

    def __init__(self, coordinates: Dict[str, object],
                 budget_bytes: Optional[int],
                 flat_vector_bytes: int = 0, mesh=None):
        self.budget_bytes = budget_bytes
        self.flat_vector_bytes = flat_vector_bytes
        # blocks shard their leading axis over the mesh "data" axis: each
        # rank's device holds 1/D of every block
        self.data_devices = 1 if mesh is None else mesh.num_data
        per_dev = lambda b: int(math.ceil(b / self.data_devices))
        self.footprints: Dict[str, CoordinateFootprint] = {}
        self.store = BlockStore()
        self._stream_snapshots = {}
        for name, coord in coordinates.items():
            streamed = bool(getattr(coord, "streamed", False))
            snap_fn = getattr(coord, "stream_snapshot", None)
            if streamed and callable(snap_fn):
                self._stream_snapshots[name] = snap_fn
            block_bytes = (0 if streamed
                           else per_dev(int(coord.device_block_bytes())))
            self.footprints[name] = CoordinateFootprint(
                name=name, block_bytes=block_bytes, streamed=streamed,
                chunk_bytes=(per_dev(int(coord.streaming_buffer_bytes()))
                             if streamed else 0))
            self.store.register(name, evict=coord.evict_device_blocks,
                                block_bytes=block_bytes, streamed=streamed)
        self.resident_block_total = sum(f.block_bytes
                                        for f in self.footprints.values())
        # a streamed coordinate's double buffer is live during ITS update,
        # beside every still-resident coordinate: the no-eviction peak is
        # blocks + flat + the largest chunk buffer
        stream_peak = max((f.chunk_bytes for f in self.footprints.values()
                           if f.streamed), default=0)
        self.evict_inactive = (
            budget_bytes is not None
            and (self.resident_block_total + flat_vector_bytes + stream_peak
                 > budget_bytes)
            and any(not f.streamed for f in self.footprints.values()))
        self._resident: Dict[str, int] = {}
        self.peak_tracked_bytes = 0
        self.evictions = 0
        if self.evict_inactive:
            logger.info(
                "hbm budget %.0f MB < resident coordinate blocks %.0f MB "
                "(+%.0f MB flat vectors): rotating residency — inactive "
                "coordinates evict after their update and re-stream on the "
                "next visit", budget_bytes / 1e6,
                self.resident_block_total / 1e6, flat_vector_bytes / 1e6)

    # -- descent-loop hooks ---------------------------------------------------
    def before_update(self, name: str) -> None:
        """Coordinate `name` is about to update: its blocks re-stage on
        first touch, so count them resident from here (an evicted
        coordinate's re-fetch goes through the store)."""
        f = self.footprints[name]
        self.store.touch(name)
        self._resident[name] = (f.chunk_bytes if f.streamed
                                else f.block_bytes)
        current = sum(self._resident.values()) + self.flat_vector_bytes
        self.peak_tracked_bytes = max(self.peak_tracked_bytes, current)

    def after_update(self, name: str) -> None:
        """Coordinate `name` finished update + score (+ objective): under
        budget pressure its device blocks are dropped now through the
        store's eviction entry point."""
        f = self.footprints[name]
        if f.streamed:
            # the prefetcher released its chunks as the passes drained
            self._resident.pop(name, None)
            return
        if not self.evict_inactive:
            return
        self.store.evict(name)
        self._resident.pop(name, None)
        self.evictions += 1

    # -- reporting ------------------------------------------------------------
    def accounting(self) -> dict:
        """Byte accounting for the training summary, in the JAX package's
        keys."""
        return {
            "budget_bytes": self.budget_bytes,
            "per_device": self.data_devices > 1,
            "data_devices": self.data_devices,
            "flat_vector_bytes": self.flat_vector_bytes,
            "resident_block_bytes": {
                n: f.block_bytes for n, f in self.footprints.items()
                if not f.streamed},
            "streamed_chunk_bytes": {
                n: f.chunk_bytes for n, f in self.footprints.items()
                if f.streamed},
            "resident_block_total": self.resident_block_total,
            "evict_inactive": self.evict_inactive,
            "evictions": self.evictions,
            "peak_tracked_bytes": self.peak_tracked_bytes,
            "under_budget": (self.budget_bytes is None
                             or self.peak_tracked_bytes <= self.budget_bytes),
            "store": self.store.snapshot(),
            "stream": {name: fn()
                       for name, fn in self._stream_snapshots.items()},
        }
