"""FeedbackBuffer: bounded, deduplicating intake for labeled feedback (a
copy of photon_ml_tpu/online/feedback.py: host-only).

The online tier's front door.  Observations arrive as request-shaped
batches (features per shard, raw ids per entity type, labels) and are
COALESCED PER ENTITY under each updatable coordinate: the updater drains
whole entities, so one entity with 40 pending rows costs one anchored
solve, not 40.

Discipline mirrors the serving micro-batcher's:

  * BOUNDED — `max_rows` pending lane-rows total; a batch that would
    overflow is rejected whole with `Overloaded` (the same backpressure
    exception the scoring path sheds with), never partially absorbed.
  * PER-ENTITY DEDUP WINDOW — each (coordinate, entity) keeps only the
    newest `entity_window` observations (older ones coalesce out: with a
    prior-anchored solve the newest rows carry the signal, and an
    unboundedly hot entity must not starve the buffer), and an optional
    per-observation `event_id` is checked against a sliding window of
    recently seen ids so client retries do not double-count feedback.
  * FIFO BY ENTITY — `drain` pops the entities whose oldest pending
    observation is oldest, so feedback-to-publish latency is fair under
    load.

Thread-safe; the buffer itself is scorer-agnostic (the updater resolves
ids -> table rows before offering).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.serving.batcher import Overloaded
from photon_ml_tpu_torch.utils import locktrace


@dataclasses.dataclass
class Observation:
    """One labeled row, shared by every coordinate lane it feeds (the
    feature dict carries ALL shards: the updater re-scores the row against
    the full model to build the residual offset)."""

    features: Dict[str, np.ndarray]     # shard -> [d_shard] row
    ids: Dict[str, object]              # re_type -> raw entity id
    label: float
    weight: float
    offset: float
    enqueued_at: float                  # monotonic clock at intake
    event_id: Optional[str] = None
    trace_id: Optional[str] = None      # propagated request id (X-Photon-
                                        # Trace): rides into the delta's
                                        # replication-record trace metadata
    enqueued_wall_s: float = 0.0        # wall clock at intake (fleet-
                                        # visible latency measures from it)


@dataclasses.dataclass
class EntityFeedback:
    """One drained entity: its pending observations, oldest first."""

    entity_id: object
    row: int                            # scorer table row (resolved at intake)
    observations: List[Observation]
    first_enqueued_at: float


class FeedbackBuffer:
    def __init__(self, max_rows: int = 8192, entity_window: int = 128,
                 dedup_window: int = 8192):
        if max_rows < 1 or entity_window < 1:
            raise ValueError("max_rows and entity_window must be >= 1")
        self.max_rows = int(max_rows)
        self.entity_window = int(entity_window)
        self.dedup_window = int(dedup_window)
        self._lock = locktrace.tracked(threading.Lock(),
                                       "FeedbackBuffer._lock")
        # lane -> OrderedDict[entity_id -> (row, deque[Observation])];
        # OrderedDict insertion order IS the FIFO drain order
        self._lanes: Dict[str, "OrderedDict[object, Tuple[int, deque]]"] = {}
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._pending = 0
        # intake accounting (the updater mirrors these into ServingMetrics)
        self.accepted = 0
        self.deduped = 0
        self.coalesced = 0
        self.shed = 0

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return self._pending

    def pending_entities(self, lane: str) -> int:
        with self._lock:
            return len(self._lanes.get(lane, ()))

    def lanes(self) -> List[str]:
        with self._lock:
            return [lane for lane, ents in self._lanes.items() if ents]

    def _dedup(self, event_id: Optional[str]) -> bool:
        """True = drop (seen within the window).  Caller holds the lock."""
        if event_id is None:
            return False
        if event_id in self._seen:
            return True
        self._seen[event_id] = None
        while len(self._seen) > self.dedup_window:
            self._seen.popitem(last=False)
        return False

    def offer_batch(self, entries: List[Tuple[str, object, int, Observation]]
                    ) -> Dict[str, int]:
        """Enqueue (lane, entity_id, table_row, observation) entries as one
        atomic batch.  Duplicate event_ids are dropped first; if the
        remainder would push pending lane-rows past `max_rows`, the WHOLE
        batch is rejected with Overloaded (all-or-nothing, so a client
        retry after backoff re-offers a consistent batch)."""
        with self._lock:
            fresh = []
            deduped = 0
            # one event_id may legitimately fan out to several lanes
            # (userId AND itemId): dedup per EVENT, not per lane entry
            admitted_events: set = set()
            dropped_events: set = set()
            for lane, entity_id, row, obs in entries:
                eid = obs.event_id
                if eid is not None and eid in admitted_events:
                    fresh.append((lane, entity_id, row, obs))
                    continue
                if eid is not None and eid in dropped_events:
                    deduped += 1
                    continue
                if self._dedup(eid):
                    dropped_events.add(eid)
                    deduped += 1
                    continue
                if eid is not None:
                    admitted_events.add(eid)
                fresh.append((lane, entity_id, row, obs))
            # coalescing frees window overflow slots, so count the rows
            # that will actually remain pending
            if self._pending + len(fresh) > self.max_rows:
                overflow = sum(
                    1 for lane, entity_id, _row, _obs in fresh
                    if len(self._lanes.get(lane, {}).get(entity_id,
                                                         (0, ()))[1])
                    >= self.entity_window)
                if self._pending + len(fresh) - overflow > self.max_rows:
                    self.shed += 1
                    self.deduped += deduped
                    raise Overloaded(
                        f"feedback buffer full ({self._pending} pending "
                        f"rows, max {self.max_rows}); retry after the "
                        "updater drains")
            coalesced = 0
            for lane, entity_id, row, obs in fresh:
                ents = self._lanes.setdefault(lane, OrderedDict())
                slot = ents.get(entity_id)
                if slot is None:
                    slot = (row, deque(maxlen=self.entity_window))
                    ents[entity_id] = slot
                q = slot[1]
                if len(q) == self.entity_window:
                    coalesced += 1      # deque drops the oldest silently
                    self._pending -= 1
                q.append(obs)
                self._pending += 1
            self.accepted += len(fresh)
            self.deduped += deduped
            self.coalesced += coalesced
            return {"accepted": len(fresh), "deduped": deduped,
                    "coalesced": coalesced, "pending_rows": self._pending}

    def drain(self, lane: str, max_entities: int) -> List[EntityFeedback]:
        """Pop up to `max_entities` whole entities from a lane (FIFO by
        first-pending time)."""
        out: List[EntityFeedback] = []
        with self._lock:
            ents = self._lanes.get(lane)
            if not ents:
                return out
            while ents and len(out) < max_entities:
                entity_id, (row, q) = ents.popitem(last=False)
                obs = list(q)
                self._pending -= len(obs)
                out.append(EntityFeedback(
                    entity_id=entity_id, row=row, observations=obs,
                    first_enqueued_at=min(o.enqueued_at for o in obs)))
        return out

    def requeue(self, lane: str, drained: List[EntityFeedback]) -> None:
        """Put drained entities back (stale delta / transient publish
        failure): their observations keep the original enqueue times, so
        feedback-to-publish latency stays honest.  Bypasses the max_rows
        bound — these rows were already admitted once."""
        with self._lock:
            ents = self._lanes.setdefault(lane, OrderedDict())
            for ef in drained:
                slot = ents.get(ef.entity_id)
                if slot is None:
                    slot = (ef.row, deque(maxlen=self.entity_window))
                    ents[ef.entity_id] = slot
                    ents.move_to_end(ef.entity_id, last=False)
                q = slot[1]
                for obs in reversed(ef.observations):
                    if len(q) == self.entity_window:
                        break  # window full: newest survive
                    q.appendleft(obs)
                    self._pending += 1

    def drop_entity(self, lane: str, entity_id) -> int:
        """Discard an entity's pending rows (it was frozen)."""
        with self._lock:
            ents = self._lanes.get(lane)
            if not ents or entity_id not in ents:
                return 0
            _row, q = ents.pop(entity_id)
            self._pending -= len(q)
            return len(q)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pending_rows": self._pending,
                    "accepted": self.accepted, "deduped": self.deduped,
                    "coalesced": self.coalesced, "shed": self.shed}
