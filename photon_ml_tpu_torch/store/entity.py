"""TieredEntityStore: one row table spanning device memory, host DRAM, and
disk — the residency layer that serves 10M+ entity models on a ~1M-entity
hot-tier budget (port of photon_ml_tpu/store/entity.py: the hot table is a
torch tensor on the store's device; the warm tier, the cold tier, the slot
maps and the sampled LFU stay host numpy, with the JAX package's own
`np.random.default_rng(0)`, so victim choices and every tier counter match
its store's for the same request sequence).

Tier shape (Snap ML's hierarchical data management, arXiv 1803.06333;
async staging per arXiv 1702.07005; durability per Photon ML's PalDB):

  * HOT — a device-resident `[hot_rows, d]` table holding the most-used
    rows, PLUS a small per-batch STAGING WINDOW.  Scoring batches take
    both as tensors and address rows by SLOT.  A batch's misses
    are staged as a `[overlay_rows, d]` HOST array riding the batch's own
    device transfer (the micro-batch staging window of the Snap ML
    pipeline — no device scatter, no extra dispatch on the miss path),
    so serving a miss never pays a full-hot-table copy; promotion into
    the main hot table is AMORTIZED: missed rows accumulate in a pending
    set and one batched scatter per `flush_rows` promotes them over
    sampled-LFU victims.
  * WARM — host-pinned segment arrays (a bounded LRU of cold segments).
    Row-level online deltas land here ALWAYS (the warm copy is the
    authoritative value of every non-cold row) and in the hot table too
    when the row is resident — so hot is a write-through cache and
    eviction from hot is free.
  * COLD — the full table as manifest-sealed, sha256-verified segment
    files (store/cold.py).  Dirty warm segments write back durably on
    eviction ("spill") and at flush().

Concurrency contract: one lock guards the maps, the warm dict, and the
hot-table swap; every blocking operation — disk reads, durable spills,
retry backoff sleeps — runs OUTSIDE it (segment loads are idempotent and
re-checked at commit; dirty evictions move through a write-back buffer
that readers consult until the spill completes).  Scoring threads get
batch-granularity consistency the same way the serving scorer does: the
hot table is replaced out of place (never mutated: a scatter clones the
table and writes the clone, as XLA's scatter without donation does, so a
batch still reading the old snapshot is untouched), `lookup_slots` returns
the exact snapshot its slots index into, and each batch's staged miss
values are private to that batch.  Every device operation runs on the
device's default stream, which every thread shares, so a snapshot freed by
a swap is reused only after the work queued before the swap.

Out-of-range lanes: JAX drops out-of-range scatter lanes and clamps gather
lanes; on CUDA an out-of-range index is a device-side assert that kills the
context.  So this store pads nothing: scatters take exactly the slots they
write, and the scorer clamps its gathers (parallel/random_effect.py
score_by_entity).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.store.base import StoreError, StoreStats, with_retries
from photon_ml_tpu_torch.store.cold import ColdStore
from photon_ml_tpu_torch.utils import locktrace

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}
_NUMPY_DTYPES = {t: n for n, t in _TORCH_DTYPES.items()}


def scatter_rows(table: torch.Tensor, rows: np.ndarray,
                 values: np.ndarray) -> torch.Tensor:
    """A new table: `table` with `rows` (in range, host int64) replaced by
    `values` (host [k, d]).  Out of place, as XLA's scatter without
    donation: the old table stays valid for every batch still reading it.
    The values are cast to the table's dtype on the host; one
    host-to-device copy of the rows and one of the values."""
    out = table.clone()
    if len(rows):
        idx = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
        val = torch.from_numpy(np.ascontiguousarray(
            values, _NUMPY_DTYPES[table.dtype]))
        out.index_copy_(0, idx.to(table.device), val.to(table.device))
    return out


class _SegmentRaced(Exception):
    """A warm segment vanished between an attempt's load plan and its
    commit (a concurrent thread's LRU eviction won the race).  Transient
    by construction: the retry re-plans and re-loads."""

    transient = True


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Tiering knobs.  `hot_rows` is the device budget (the ~1M-entity
    HBM budget of the 10M-entity gate); `warm_segments * seg_rows` is the
    host budget; the cold tier is unbounded (it holds every row).
    `overlay_rows` bounds one batch's distinct misses (the staging
    window); `flush_rows` is the pending-promotion threshold — ONE
    full-hot-table scatter per that many promoted rows, instead of one
    per missed batch."""

    hot_rows: int = 1 << 20          # device-resident row budget
    warm_segments: int = 64          # host-pinned segment budget
    seg_rows: int = 1 << 14          # rows per cold segment
    overlay_rows: int = 1024         # staging window (>= largest batch)
    flush_rows: int = 4096           # pending rows per promotion flush
    lfu_sample: int = 8192           # eviction candidate sample size
    decay_every: int = 256           # halve LFU counters every N batches

    def __post_init__(self):
        if min(self.hot_rows, self.warm_segments, self.seg_rows,
               self.overlay_rows, self.flush_rows,
               self.lfu_sample, self.decay_every) < 1:
            raise ValueError("every StoreConfig knob must be >= 1")


class TieredEntityStore:
    """One entity-keyed row table behind the three tiers.

    The store is shared by every tenant that touches the table: the
    serving scorer (`lookup_slots` per request chunk), the online updater
    and replication replay (`update_rows` — deltas land in whatever tier
    a row lives in), and training/audit readers (`gather_rows` /
    `full_table`, always bit-exact with the tier state)."""

    def __init__(self, cold: ColdStore, config: StoreConfig,
                 name: str = "table", device=None):
        # cold/config/dtype/device are immutable after construction: read
        # lock-free by every thread
        self.cold = cold  # photonlint: guarded-by=atomic
        self.config = config  # photonlint: guarded-by=atomic
        self.name = name
        self.rows = cold.rows
        self.dim = cold.dim
        self.device = resolve_device(device)
        self.dtype = np.dtype(cold.dtype)  # photonlint: guarded-by=atomic
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(
                f"cold store dtype {cold.dtype} is not a float32 or float64 "
                "table; re-create the store in a supported dtype")
        self.torch_dtype = _TORCH_DTYPES[self.dtype]
        self.hot_rows = min(int(config.hot_rows), self.rows)
        self.overlay_rows = int(config.overlay_rows)
        self.stats = StoreStats()
        self._lock = locktrace.tracked(threading.Lock(),
                                       "TieredEntityStore._lock")
        # id -> row resolution: identity for integer 0..rows-1 ids (the
        # 10M-entity fast path — no 10M-entry python dict), else a sorted
        # array + searchsorted
        ids = cold.entity_ids
        self._identity_ids = ids is None
        if not self._identity_ids:
            ids = np.asarray(ids)
            self._id_order = np.argsort(ids, kind="stable")
            self._sorted_ids = ids[self._id_order]
        # hot-tier state, all guarded by _lock (the tables themselves are
        # replaced functionally and read lock-free at batch granularity)
        self._table = torch.zeros((self.hot_rows, self.dim),
                                  dtype=self.torch_dtype, device=self.device)  # photonlint: guarded-by=atomic
        self._slot_of = np.full(self.rows, -1, np.int32)  # photonlint: guarded-by=_lock
        self._row_of = np.full(self.hot_rows, -1, np.int64)  # photonlint: guarded-by=_lock
        self._freq = np.zeros(self.hot_rows, np.int64)  # photonlint: guarded-by=_lock
        # free-slot stack (vectorized: a 1M-slot hot tier must not pop a
        # python list a million times); _free_n slots remain
        self._free = np.arange(self.hot_rows, dtype=np.int64)  # photonlint: guarded-by=_lock
        self._free_n = self.hot_rows  # photonlint: guarded-by=_lock
        self._pending: set = set()  # photonlint: guarded-by=_lock
        self._batches = 0  # photonlint: guarded-by=_lock
        self._decay_pos = 0  # photonlint: guarded-by=_lock
        self._rng = np.random.default_rng(0)  # photonlint: guarded-by=_lock
        # warm-tier state: seg id -> [seg_rows, d] host array (LRU), the
        # dirty set, and the write-back buffer readers consult while a
        # dirty eviction's durable spill is still in flight
        self._warm: "OrderedDict[int, np.ndarray]" = OrderedDict()  # photonlint: guarded-by=_lock
        self._dirty: set = set()  # photonlint: guarded-by=_lock
        self._spilling: Dict[int, np.ndarray] = {}  # photonlint: guarded-by=_lock
        # durable write-back work queue: commits enqueue under the lock,
        # every public op drains in a finally — spill work enqueued by a
        # commit that later raises (a raced retry) is never lost
        self._spill_queue: List[Tuple[int, np.ndarray]] = []  # photonlint: guarded-by=_lock
        # per-segment mutation counter: a cold read planned at version V
        # must not install into warm at version != V (the bytes it read
        # predate a racing update — the stale-install hazard)
        self._seg_ver: Dict[int, int] = {}  # photonlint: guarded-by=_lock
        self.warmed = False

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, directory: str, table: np.ndarray,
               config: Optional[StoreConfig] = None,
               entity_ids: Optional[np.ndarray] = None,
               name: str = "table", device=None) -> "TieredEntityStore":
        """Bootstrap a store from a full table: every row starts cold
        (sealed to `directory`), hot/warm fill from traffic.  Integer
        ids equal to their own row index need no id map at all."""
        config = config or StoreConfig()
        if entity_ids is not None:
            ids = np.asarray(entity_ids)
            if ids.dtype.kind in "iu" and len(ids) == len(table) \
                    and np.array_equal(ids, np.arange(len(table))):
                entity_ids = None
        cold = ColdStore.create(directory, np.asarray(table),
                                config.seg_rows, entity_ids=entity_ids)
        return cls(cold, config, name=name, device=device)

    @classmethod
    def open(cls, directory: str, config: Optional[StoreConfig] = None,
             name: str = "table", device=None) -> "TieredEntityStore":
        cold = ColdStore.open(directory)
        cfg = config or StoreConfig()
        if cfg.seg_rows != cold.seg_rows:
            cfg = dataclasses.replace(cfg, seg_rows=cold.seg_rows)
        return cls(cold, cfg, name=name, device=device)

    # -- id resolution -----------------------------------------------------

    def resolve(self, ids) -> np.ndarray:
        """Raw entity ids -> global row indices (-1 = unknown entity:
        such rows keep the serving fixed-effect-only fallback)."""
        ids = np.asarray(ids)
        if self._identity_ids:
            if ids.dtype.kind not in "iu":
                try:
                    as_int = ids.astype(np.int64)
                except (TypeError, ValueError):
                    return np.full(len(ids), -1, np.int64)
            else:
                as_int = ids.astype(np.int64)
            ok = (as_int >= 0) & (as_int < self.rows)
            return np.where(ok, as_int, -1)
        pos = np.searchsorted(self._sorted_ids, ids)
        pos = np.minimum(pos, len(self._sorted_ids) - 1)
        ok = self._sorted_ids[pos] == ids
        return np.where(ok, self._id_order[pos], -1).astype(np.int64)

    def resolve_one(self, entity_id) -> int:
        return int(self.resolve(np.asarray([entity_id]))[0])

    # -- hot-tier lookup (the serving path) --------------------------------

    def lookup_slots(self, rows: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor,
                                np.ndarray]:
        """Resolve `rows` (global indices, -1 passthrough) against the
        hot tier and stage this batch's misses into the batch's staging
        window.

        Returns `(slots, stage_slots, table, stage_values)`: per-row
        lanes into the main hot table (-1 where the row is missed or
        unknown), per-row lanes into the staging window (-1 where the
        row is hot or unknown — each known row lives in EXACTLY one of
        the two), the exact hot-table snapshot the slots index into
        (batch-granularity consistency: a concurrent promotion replaces
        the store's table but never mutates this snapshot), and the
        missed rows' HOST values `[k, d]` — the caller ships them with
        the batch's own device transfer and gathers through the staging
        lanes.  Missed rows join the pending set; every `flush_rows` of
        them promote into the main table with ONE amortized scatter."""
        rows = np.asarray(rows, np.int64)
        uniq = np.unique(rows[rows >= 0])
        if len(uniq) > self.overlay_rows:
            raise StoreError(
                f"store {self.name!r}: one batch touches {len(uniq)} "
                f"distinct rows but the staging overlay holds "
                f"{self.overlay_rows} — raise overlay_rows above the "
                "largest scoring batch")
        # one attempt = plan -> cold loads -> locked commit; idempotent,
        # so the retry discipline wraps the WHOLE attempt (a concurrent
        # eviction racing the commit re-plans transparently) and backoff
        # sleeps happen with no lock held
        def attempt():
            to_load = self._plan_loads(uniq)
            loaded = self._load_segments(to_load) if to_load else {}
            return self._stage_commit(rows, uniq, loaded)

        try:
            out, counts = with_retries(
                attempt, site="store.promote", what=f"block {self.name!r}",
                on_retry=self.stats.note_retry,
                coordinate=self.name, rows=int(len(uniq)))
        finally:
            self._drain_spills()
        self.stats.note_lookup(hot=counts[0], warm=counts[1],
                               cold=counts[2])
        if counts[3]:
            self.stats.note_promotion(counts[3])
        return out

    def _plan_loads(self, uniq: np.ndarray) -> List[Tuple[int, int]]:
        """Under the lock: which cold segments this batch's misses need,
        each with its mutation version (idempotent pre-plan; the commit
        refuses a version-skewed install)."""
        with self._lock:
            if not len(uniq):
                return []
            missing = uniq[self._slot_of[uniq] < 0]
            if not len(missing):
                return []
            segs = np.unique(missing // self.cold.seg_rows).tolist()
            return [(s, self._seg_ver.get(s, 0)) for s in segs
                    if s not in self._warm and s not in self._spilling]

    def _load_segments(self, segs: List[Tuple[int, int]]
                       ) -> Dict[int, Tuple[np.ndarray, int]]:
        """Cold segment reads, OUTSIDE the lock (idempotent: the commit
        re-checks warm — and the planned version — before installing)."""
        out = {}
        for si, ver in segs:
            out[si] = (with_retries(
                lambda si=si: self.cold.read_segment(si),
                site="store.fetch", what=f"block {self.name}/seg-{si}",
                on_retry=self.stats.note_retry,
                tier="cold", block=f"{self.name}/seg-{si}"), ver)
            self.stats.note_fetch()
        return out

    def _stage_commit(self, rows, uniq, loaded):
        """Under the lock: fault loaded segments into warm, stage the
        batch's misses into the overlay, build both lane arrays against
        consistent snapshots, and run an amortized promotion flush when
        the pending set is due."""
        with self._lock:
            segs = np.unique(
                uniq[self._slot_of[uniq] < 0] // self.cold.seg_rows
            ).tolist() if len(uniq) else []
            self._ensure_warm(segs, loaded)
            missing = uniq[self._slot_of[uniq] < 0] if len(uniq) \
                else uniq
            k = len(missing)
            # a missed row whose segment came off disk THIS batch is a
            # cold miss; any other miss was staged out of the warm tier
            cold_rows = 0
            if k and loaded:
                cold_rows = int(np.isin(
                    missing // self.cold.seg_rows,
                    np.asarray(sorted(loaded), np.int64)).sum())
            values = (self._warm_gather(missing) if k
                      else np.empty((0, self.dim), self.dtype))
            if k:
                self._pending.update(missing.tolist())
            promoted = 0
            if len(self._pending) >= self.config.flush_rows:
                promoted = self._flush_promotions(protect=uniq)
            # lanes against the post-flush state: rows promoted by THIS
            # flush still carry their overlay lane (hot lanes were
            # resolved before the miss), never both
            hot_slots = np.where(
                rows >= 0, self._slot_of[np.maximum(rows, 0)],
                -1).astype(np.int32)
            stage_slots = np.full(len(rows), -1, np.int32)
            if k:
                pos = np.searchsorted(missing, np.maximum(rows, 0))
                pos = np.minimum(pos, k - 1)
                hit = (rows >= 0) & (missing[pos] == np.maximum(rows, 0))
                stage_slots[hit] = pos[hit].astype(np.int32)
                hot_slots[hit] = -1     # exactly one lane per row
            if len(uniq):
                hs = self._slot_of[uniq]
                np.add.at(self._freq, hs[hs >= 0], 1)
            self._batches += 1
            if self._batches % self.config.decay_every == 0:
                # LFU aging, amortized: halve one rotating 1/16 slice per
                # due batch (a full-table halve on a 1M-slot tier is a
                # multi-ms stall that would land on ONE request's tail)
                step = max(self.hot_rows // 16, 1)
                lo = self._decay_pos
                self._freq[lo: lo + step] >>= 1
                self._decay_pos = (lo + step) % self.hot_rows
            snap = (hot_slots, stage_slots, self._table, values)
        return snap, (int(len(uniq) - k), int(k - cold_rows),
                      int(cold_rows), promoted)

    def _flush_promotions(self, protect: np.ndarray) -> int:
        """Under the lock: promote the pending set into the main hot
        table with one batched scatter over sampled-LFU victims.  Rows
        whose warm segment has aged out are dropped (they will re-miss
        and re-stage — never a correctness event)."""
        pending = np.asarray(sorted(self._pending), np.int64)
        self._pending.clear()
        if not len(pending):
            return 0
        pending = pending[self._slot_of[pending] < 0]
        live = np.asarray([
            r for r in pending.tolist()
            if (r // self.cold.seg_rows) in self._warm
            or (r // self.cold.seg_rows) in self._spilling], np.int64)
        if not len(live):
            return 0
        victims = self._pick_victims(len(live), protect=protect)
        k = min(len(live), len(victims))
        if not k:
            return 0
        live, victims = live[:k], victims[:k]
        values = self._warm_gather(live)
        old = self._row_of[victims]
        self._slot_of[old[old >= 0]] = -1
        self._row_of[victims] = live
        self._slot_of[live] = victims.astype(np.int32)
        self._freq[victims] = 1
        self._table = scatter_rows(self._table, victims, values)
        return k

    def _warm_gather(self, rows: np.ndarray) -> np.ndarray:
        """Under the lock: values of `rows` out of warm / write-back
        segments (the caller faulted every needed segment in), vectorized
        per segment."""
        out = np.empty((len(rows), self.dim), self.dtype)
        segs = rows // self.cold.seg_rows
        for si in np.unique(segs).tolist():
            seg = self._warm.get(si)
            if seg is None:
                seg = self._spilling.get(si)
            if seg is None:
                raise _SegmentRaced(si)
            m = segs == si
            out[m] = seg[rows[m] - si * self.cold.seg_rows]
        return out

    def _ensure_warm(self, segs: List[int],
                     loaded: Dict[int, np.ndarray]) -> None:
        """Under the lock: install loaded segments into warm (LRU), and
        pop over-budget victims into the write-back buffer — never one of
        `segs` (the in-flight operation needs them; a batch touching more
        distinct segments than the warm budget overshoots transiently).
        Dirty evictions join the write-back QUEUE; the public entry
        points drain it durably outside the lock (in a finally, so a
        commit that raises cannot strand enqueued work)."""
        needed = set(segs)
        for si in segs:
            if si in self._warm:
                self._warm.move_to_end(si)
                continue
            if si in self._spilling:
                # resurrect a segment whose spill is in flight: readers
                # must keep seeing the dirty bytes until they are durable
                self._warm[si] = self._spilling[si]
                self._dirty.add(si)
                continue
            if si in loaded:
                arr, planned_ver = loaded[si]
                if self._seg_ver.get(si, 0) != planned_ver:
                    # the segment mutated while our cold read was in
                    # flight: installing these bytes would resurrect the
                    # pre-update values as authoritative
                    raise _SegmentRaced(si)
                self._warm[si] = arr
        while len(self._warm) > self.config.warm_segments:
            vic = next((k for k in self._warm if k not in needed), None)
            if vic is None:
                break
            arr = self._warm.pop(vic)
            self.stats.note_eviction()
            if vic in self._dirty:
                self._dirty.discard(vic)
                self._spilling[vic] = arr
                self._spill_queue.append((vic, arr))

    def _pick_victims(self, k: int, protect: np.ndarray) -> np.ndarray:
        """UP TO k hot slots to overwrite: free slots first, then sampled
        LFU among slots not holding a row the current batch needs.  May
        return fewer than k (a tiny hot tier mostly pinned by the
        in-flight batch): the caller promotes what fits — unpromoted rows
        simply stay warm and re-stage on their next miss."""
        take = min(k, self._free_n)
        out: List[int] = []
        if take:
            self._free_n -= take
            out = self._free[self._free_n: self._free_n + take].tolist()
        need = k - len(out)
        if need:
            protect = protect[protect < self.rows] if len(protect) else protect
            protect_slots = (self._slot_of[protect] if len(protect)
                             else np.empty(0, np.int32))
            protected = np.zeros(self.hot_rows, bool)
            protected[protect_slots[protect_slots >= 0]] = True
            if out:
                protected[np.asarray(out, np.int64)] = True
            sample = self._rng.integers(
                0, self.hot_rows,
                size=max(self.config.lfu_sample, 4 * need))
            sample = np.unique(sample[~protected[sample]])
            if len(sample) < need:      # tiny hot tiers: consider all slots
                sample = np.where(~protected)[0]
            need = min(need, len(sample))
            if need:
                order = np.argpartition(self._freq[sample],
                                        need - 1)[:need]
                out.extend(sample[order].tolist())
        return np.asarray(out, np.int64)

    def warmup(self) -> None:
        """Nothing to compile: the port runs eager torch ops, and a
        promotion or write-through is one out-of-place `index_copy_` of
        whatever row count it carries.  Kept so tenants warm stores the
        way the JAX package's do."""
        self.warmed = True

    def preload_all(self) -> None:
        """Pin the ENTIRE table hot (requires hot_rows == rows): one bulk
        device transfer + identity slot maps.  The all-resident
        configuration — what a budgeted store is benchmarked against."""
        if self.hot_rows != self.rows:
            raise StoreError(
                f"store {self.name!r}: preload_all needs hot_rows == "
                f"rows ({self.hot_rows} != {self.rows})")
        full = torch.from_numpy(self.full_table()).to(self.device)
        with self._lock:
            self._table = full
            self._slot_of = np.arange(self.rows, dtype=np.int32)
            self._row_of = np.arange(self.rows, dtype=np.int64)
            self._freq = np.ones(self.rows, np.int64)
            self._free_n = 0

    def promote_pending(self) -> int:
        """Force-drain the pending promotion set NOW (the pre-warm hook:
        an operator pinning a known-hot working set before taking
        traffic).  Returns rows promoted."""
        with self._lock:
            promoted = self._flush_promotions(
                protect=np.empty(0, np.int64))
        self._drain_spills()
        if promoted:
            self.stats.note_promotion(promoted)
        return promoted

    def table(self) -> torch.Tensor:
        """The current main hot table (atomic reference read; index it
        only with slots returned alongside it by lookup_slots)."""
        return self._table

    # -- row updates (online deltas / replication replay) ------------------

    def update_rows(self, rows: np.ndarray, values: np.ndarray,
                    promote: bool = False) -> Dict[str, int]:
        """Land row values in whatever tier each row lives in: the warm
        copy ALWAYS (authoritative; faulting the segment in from cold if
        needed), the hot table too for resident rows (write-through).
        `promote=True` additionally promotes non-resident rows hot (one
        immediate flush) — the feedback-for-cold-entities path.
        Rollback is this same call with the pre-delta values: bit-exact,
        because every tier stores the exact bytes.  `rows` must be
        unique (duplicate row updates in one call are ambiguous — the
        delta layer already enforces this)."""
        rows = np.asarray(rows, np.int64)
        values = np.asarray(values)
        if values.shape != (len(rows), self.dim):
            raise ValueError(
                f"store {self.name!r}: update values must be "
                f"[{len(rows)}, {self.dim}], got {values.shape}")
        if len(rows) and (rows.min() < 0 or rows.max() >= self.rows):
            raise ValueError(
                f"store {self.name!r}: update rows out of range "
                f"[0, {self.rows})")
        def attempt():
            to_load = self._plan_update_loads(rows)
            loaded = self._load_segments(to_load) if to_load else {}
            return self._update_commit(rows, values, loaded, promote)

        try:
            hot = with_retries(
                attempt, site="store.fetch", what=f"block {self.name!r}",
                on_retry=self.stats.note_retry,
                tier="warm", block=self.name)
        finally:
            self._drain_spills()
        return {"rows": len(rows), "hot": hot}

    def _plan_update_loads(self, rows: np.ndarray) -> List[Tuple[int, int]]:
        with self._lock:
            segs = np.unique(rows // self.cold.seg_rows).tolist()
            return [(s, self._seg_ver.get(s, 0)) for s in segs
                    if s not in self._warm and s not in self._spilling]

    def _update_commit(self, rows, values, loaded, promote):
        with self._lock:
            segs = np.unique(rows // self.cold.seg_rows).tolist()
            spills = self._ensure_warm(segs, loaded)
            row_segs = rows // self.cold.seg_rows
            for si in np.unique(row_segs).tolist():
                seg = self._warm.get(si)
                if seg is None:      # spill in flight: write the shared
                    seg = self._spilling.get(si)   # buffer, resurrect
                    if seg is None:  # evicted clean by a racing thread
                        raise _SegmentRaced(si)
                    self._warm[si] = seg
                m = row_segs == si
                seg[rows[m] - si * self.cold.seg_rows] = values[m]
                self._dirty.add(si)
                self._seg_ver[si] = self._seg_ver.get(si, 0) + 1
            resident = self._slot_of[rows] >= 0
            hot = int(resident.sum())
            if hot:
                self._table = scatter_rows(
                    self._table,
                    self._slot_of[rows[resident]].astype(np.int64),
                    values[resident])
            if promote and hot < len(rows):
                # feedback for cold entities promotes them: traffic that
                # cares enough to update a row will score it next
                self._pending.update(rows[~resident].tolist())
                promoted = self._flush_promotions(protect=rows)
                if promoted:
                    self.stats.note_promotion(promoted)
        return hot

    # -- host reads (training / priors / audit) ----------------------------

    def gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host values of global rows, bit-exact with the tier state
        (warm overlay wins over cold).  Faults segments into warm."""
        rows = np.asarray(rows, np.int64)

        def attempt():
            to_load = self._plan_update_loads(rows)
            loaded = self._load_segments(to_load) if to_load else {}
            return self._gather_commit(rows, loaded)

        try:
            out = with_retries(
                attempt, site="store.fetch", what=f"block {self.name!r}",
                on_retry=self.stats.note_retry,
                tier="warm", block=self.name)
        finally:
            self._drain_spills()
        return out

    def _gather_commit(self, rows, loaded):
        with self._lock:
            segs = np.unique(rows // self.cold.seg_rows).tolist()
            self._ensure_warm(segs, loaded)
            out = self._warm_gather(rows)
        return out

    def full_table(self) -> np.ndarray:
        """The logical table: cold overlaid with every live warm/dirty
        segment (audit + fleet table hashes — one deliberate full read,
        never on the scoring path).

        The overlay snapshot is taken BEFORE the cold read: a dirty
        spill completing in between is then covered either by the
        snapshot (it was still in warm/write-back when we looked) or by
        the cold bytes (its durable write finished before we read) —
        never by neither.  Values mutated mid-call still race, as any
        point-in-time read of a live table must; audit callers compare
        quiescent or version-pinned states."""
        with self._lock:
            overlay = dict(self._spilling)
            overlay.update(self._warm)
            overlay = {si: seg.copy() for si, seg in overlay.items()}
        out = self.cold.read_table()
        for si, seg in overlay.items():
            lo, hi = self.cold.segment_span(si)
            out[lo:hi] = seg[: hi - lo]
        return out

    # -- spill / flush -----------------------------------------------------

    def _drain_spills(self) -> None:
        """Durable write-back of queued dirty-segment evictions, outside
        the lock; readers see the write-back buffer until the bytes are
        sealed.  Every public entry point drains (in a finally), so
        enqueued work survives raised commits and is executed exactly
        once across racing drainers.  A fatal failure names the entity
        block."""
        while True:
            with self._lock:
                if not self._spill_queue:
                    return
                si, arr = self._spill_queue.pop(0)
            with_retries(
                lambda si=si, arr=arr: self.cold.write_segment(si, arr),
                site="store.spill", what=f"block {self.name}/seg-{si}",
                on_retry=self.stats.note_retry,
                block=f"{self.name}/seg-{si}")
            self.stats.note_spill()
            with self._lock:
                # the spilled array object is shared with any resurrected
                # warm entry, so dropping the write-back ref is safe: a
                # reader finds the segment in warm or (now durable) cold
                if self._spilling.get(si) is arr:
                    del self._spilling[si]

    def flush(self) -> int:
        """Spill every dirty warm segment to the cold tier (close/seal
        point: after flush the cold directory alone reproduces the
        logical table).  Returns segments written."""
        with self._lock:
            doomed = [(si, self._warm[si]) for si in sorted(self._dirty)]
            for si, arr in doomed:
                self._dirty.discard(si)
                self._spilling[si] = arr
                self._spill_queue.append((si, arr))
        self._drain_spills()
        return len(doomed)

    # -- reporting ---------------------------------------------------------

    def hit_rate(self) -> Optional[float]:
        return self.stats.hit_rate()

    def residency(self) -> Dict[str, object]:
        with self._lock:
            hot = int((self._row_of >= 0).sum())
            warm = len(self._warm)
            dirty = len(self._dirty)
            pending = len(self._pending)
        return {"rows": self.rows, "dim": self.dim,
                "hot_rows": self.hot_rows, "hot_resident": hot,
                "overlay_rows": self.overlay_rows,
                "pending_promotions": pending,
                "warm_segments": warm, "dirty_segments": dirty,
                "seg_rows": self.cold.seg_rows,
                "cold_segments": self.cold.num_segments,
                "hit_rate": self.hit_rate(),
                **self.stats.snapshot()}


def store_totals(stores: Dict[str, TieredEntityStore]) -> Dict[str, int]:
    """Aggregate counter totals across stores (the ServingMetrics probe:
    counters on both metric surfaces sync to these monotonically)."""
    out = {f: 0 for f in StoreStats.FIELDS}
    for st in stores.values():
        snap = st.stats.snapshot()
        for f in StoreStats.FIELDS:
            out[f] += snap[f]
    return out
