"""The training tenant of the tiered store: evictable coordinate blocks
(port of photon_ml_tpu/store/handles.py).

Each coordinate registers its evictable device blocks once, and the descent
loop's residency rotation (game/residency.py) drives fetch/evict through
the store: the one eviction entry point, with the `store.fetch` fault site
and the shared retry discipline on every re-stage.  `ResidencyRegistry`
holds the mesh staging layer's keyed entries
(parallel/mesh_residency.py).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from photon_ml_tpu_torch.store.base import StoreStats, with_retries
from photon_ml_tpu_torch.utils import locktrace


def _as_tuple(key) -> tuple:
    return key if isinstance(key, tuple) else (key,)


class ResidencyRegistry:
    """Keyed registry of staged (hot-resident) entries.

    An entry is keyed by an arbitrary tuple and pins the SOURCE object it
    was staged from: `lookup` returns the cached staging only while the
    source identity matches (a rebuilt source re-stages in place —
    per-key staleness, no global flush).  Bounded FIFO: entries pin
    device memory, so the registry caps entries and ages out the oldest.
    Thread-safe; staging itself happens OUTSIDE the lock (callers stage
    on a miss and `commit` re-checks)."""

    def __init__(self, max_entries: int = 256,
                 on_eviction: Optional[Callable[[], None]] = None,
                 on_invalidation: Optional[Callable[[int], None]] = None,
                 prefix_key: Optional[Callable[[tuple], tuple]] = None):
        self.max_entries = max_entries
        self._on_eviction = on_eviction
        self._on_invalidation = on_invalidation
        # the component of a composite key that prefix-invalidation
        # matches against (mesh staging keys are (coordinate key, field,
        # mesh fingerprint): invalidation addresses the coordinate key)
        self._prefix_key = prefix_key or (lambda k: k)
        self._entries: "OrderedDict" = OrderedDict()
        self._lock = locktrace.tracked(threading.Lock(),
                                       "ResidencyRegistry._lock")

    def lookup(self, full_key: tuple, source) -> Tuple[object, bool]:
        """(cached staging | None, replacing): the staging is returned
        only when the cached source IS `source`; `replacing` reports that
        a stale entry exists (the caller counts an invalidation when its
        re-staging commits)."""
        with self._lock:
            entry = self._entries.get(full_key)
            if entry is not None and entry[0] is source:
                self._entries.move_to_end(full_key)
                return entry[1], False
            return None, entry is not None

    def commit(self, full_key: tuple, source, staged) -> None:
        """Install a freshly staged entry (newest position) and age out
        anything over the bound."""
        with self._lock:
            self._entries[full_key] = (source, staged)
            self._entries.move_to_end(full_key)
            evicted = 0
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                evicted += 1
        for _ in range(evicted):
            if self._on_eviction is not None:
                self._on_eviction()

    def invalidate(self, key) -> int:
        """Drop every entry whose key starts with `key` — the
        per-coordinate eviction hook; sibling entries are untouched."""
        prefix = _as_tuple(key)
        with self._lock:
            doomed = [k for k in self._entries
                      if self._prefix_key(k)[: len(prefix)] == prefix]
            for k in doomed:
                del self._entries[k]
        if doomed and self._on_invalidation is not None:
            self._on_invalidation(len(doomed))
        return len(doomed)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        if n and self._on_invalidation is not None:
            self._on_invalidation(n)
        return n

    def num_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> Tuple[tuple, ...]:
        with self._lock:
            return tuple(self._entries)



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
