"""The training tenant of the tiered store: evictable coordinate blocks
(port of BlockHandle and BlockStore in photon_ml_tpu/store/handles.py).

Each coordinate registers its evictable device blocks once, and the descent
loop's residency rotation (game/residency.py) drives fetch/evict through
the store: the one eviction entry point, with the `store.fetch` fault site
and the shared retry discipline on every re-stage.  The JAX package's
`ResidencyRegistry` (its one user is the mesh staging layer) waits for
ROADMAP.md queue A item 20.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

from photon_ml_tpu_torch.store.base import StoreStats, with_retries
from photon_ml_tpu_torch.utils import locktrace


class BlockHandle:
    """One registered evictable residency unit (a coordinate's device
    blocks).  State transitions run through the owning BlockStore."""

    def __init__(self, name: str, evict: Callable[[], None],
                 block_bytes: int = 0, streamed: bool = False):
        self.name = name
        self.block_bytes = int(block_bytes)
        self.streamed = bool(streamed)
        self._evict = evict
        # blocks stage lazily: the first visit is a (cold) fetch
        self.resident = False
        self.fetches = 0
        self.evictions = 0


class BlockStore:
    """The training tenant's residency layer: coordinates register their
    evictable device blocks ONCE; the descent loop's rotation then fetches
    and evicts through the store, which owns the accounting, the
    `store.fetch` fault site (with the retry discipline on every
    re-stage), and the single eviction entry point."""

    def __init__(self):
        self.stats = StoreStats()
        self._lock = locktrace.tracked(threading.Lock(), "BlockStore._lock")
        self._handles: Dict[str, BlockHandle] = {}

    def register(self, name: str, *, evict: Callable[[], None],
                 block_bytes: int = 0, streamed: bool = False
                 ) -> BlockHandle:
        h = BlockHandle(name, evict, block_bytes=block_bytes,
                        streamed=streamed)
        with self._lock:
            self._handles[name] = h
        return h

    def handle(self, name: str) -> BlockHandle:
        with self._lock:
            return self._handles[name]

    def touch(self, name: str) -> bool:
        """A visit is about to use block `name`: if it was evicted, mark
        the re-stage (the owner's lazy device views do the transfer on
        first access) under the store.fetch site and retry discipline.
        Returns True when this visit re-fetches."""
        h = self.handle(name)
        if h.streamed or h.resident:
            return False

        def mark():
            h.resident = True
            h.fetches += 1

        with_retries(mark, site="store.fetch", what=f"block {name!r}",
                     on_retry=self.stats.note_retry,
                     tier="device", block=name)
        self.stats.note_fetch()
        return True

    def evict(self, name: str) -> None:
        """THE eviction entry point: drop the block's device residency
        through its registered callback and count it."""
        h = self.handle(name)
        if h.streamed or not h.resident:
            return
        h._evict()
        h.resident = False
        h.evictions += 1
        self.stats.note_eviction()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            handles = dict(self._handles)
        return {
            "blocks": {n: {"resident": h.resident, "streamed": h.streamed,
                           "fetches": h.fetches, "evictions": h.evictions}
                       for n, h in handles.items()},
            **self.stats.snapshot()}
