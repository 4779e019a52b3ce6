"""Dynamic micro-batching: concurrent requests -> one padded device call
(a copy of photon_ml_tpu/serving/batcher.py, host code).

Per-request device dispatches waste the accelerator (each launch costs the
same whether it scores 1 row or 1024 — the amortize-launches-over-batches
observation of Snap ML, arXiv:1803.06333).  The batcher holds a thread-safe
queue; a worker thread coalesces whatever arrives within `max_wait_s`
(default 2 ms) up to `max_batch` rows and scores it as ONE call.  Load is
shed explicitly instead of queuing without bound:

  - queue full at submit time       -> `Overloaded` (immediate)
  - per-request deadline passes
    while the request is queued     -> `DeadlineExceeded`

so a saturated service degrades to fast failures, never unbounded latency.
A request already handed to the device when its deadline passes is
completed and returned (the deadline bounds QUEUE wait, the only unbounded
stage).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from photon_ml_tpu_torch.utils import locktrace


class ServingError(RuntimeError):
    """Base class for explicit serving failures."""


class Overloaded(ServingError):
    """The request queue is at capacity; the request was shed, not queued."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it reached the device."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Coalescing knobs: wait at most `max_wait_s` for co-travellers, never
    exceed `max_batch` rows per device call, shed beyond `max_queue`
    pending requests."""

    max_wait_s: float = 0.002
    max_batch: int = 1024
    max_queue: int = 4096


class _Request:
    __slots__ = ("features", "ids", "n", "deadline", "event", "scores",
                 "error", "enqueue_t")

    def __init__(self, features, ids, n, deadline):
        self.features = features
        self.ids = ids
        self.n = n
        self.deadline = deadline
        self.event = threading.Event()
        self.scores = None
        self.error = None
        self.enqueue_t = time.monotonic()


class MicroBatcher:
    """Request queue + coalescing worker.

    `score_fn(features, ids, num_requests, queue_wait_s)` is called on the
    worker thread with the concatenated batch and must return an object
    with a `.scores` array in row order (serving.scorer.ScoreBatchResult).
    It is resolved per BATCH, so a registry hot swap takes effect at the
    next batch boundary while in-flight batches finish on the old model.
    """

    def __init__(self, score_fn: Callable, config: BatcherConfig = None,
                 on_shed: Optional[Callable[[], None]] = None,
                 on_deadline: Optional[Callable[[], None]] = None):
        self._score_fn = score_fn
        self.config = config or BatcherConfig()
        if self.config.max_batch < 1 or self.config.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self._on_shed = on_shed
        self._on_deadline = on_deadline
        self._cv = locktrace.tracked(threading.Condition(),
                                     "MicroBatcher._cv")
        self._queue: collections.deque = collections.deque()
        self._open = True
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="photon-serving-batcher")
        self._worker.start()

    # -- client side -------------------------------------------------------

    def score(self, features: Dict[str, np.ndarray],
              ids: Dict[str, np.ndarray], n: int,
              timeout: Optional[float] = None) -> np.ndarray:
        """Block until the batch containing this request is scored.
        `timeout` is the request deadline in seconds (None = no deadline)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        req = _Request(features, ids, n, deadline)
        with self._cv:
            if not self._open:
                raise ServingError("batcher is closed")
            shed = len(self._queue) >= self.config.max_queue
            if not shed:
                self._queue.append(req)
                self._cv.notify()
        if shed:
            # the shed callback runs OUTSIDE the condition: it is
            # arbitrary metrics/listener code, and invoking it under the
            # batcher lock would nest foreign locks inside _cv on the
            # hottest serving path
            if self._on_shed is not None:
                self._on_shed()
            raise Overloaded(
                f"request queue at capacity ({self.config.max_queue} "
                "pending requests)")
        # the worker ALWAYS sets the event (scored, errored, expired, or
        # closed), so an un-set event after deadline + grace means only
        # that the device call itself is still running — keep waiting in
        # grace increments rather than abandoning a result that will come
        while not req.event.wait(
                None if deadline is None
                else max(deadline - time.monotonic(), 0.0) + 30.0):
            pass
        if req.error is not None:
            raise req.error
        return req.scores

    def close(self) -> None:
        with self._cv:
            self._open = False
            self._cv.notify_all()
        self._worker.join(timeout=30.0)

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._queue)

    # -- worker side -------------------------------------------------------

    def _take_batch(self):
        """Wait for work, hold the coalescing window, pop <= max_batch rows
        (FIFO; a single over-sized request rides alone — the scorer chunks
        it)."""
        cfg = self.config
        with self._cv:
            while self._open and not self._queue:
                self._cv.wait()
            if not self._queue:
                return None  # closed and drained
            first_t = time.monotonic()
            while self._open:
                rows = sum(r.n for r in self._queue)
                remaining = cfg.max_wait_s - (time.monotonic() - first_t)
                if rows >= cfg.max_batch or remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch, rows = [], 0
            while self._queue:
                nxt = self._queue[0]
                if batch and rows + nxt.n > cfg.max_batch:
                    break
                batch.append(self._queue.popleft())
                rows += nxt.n
                if rows >= cfg.max_batch:
                    break
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    r.error = DeadlineExceeded(
                        f"deadline passed after {now - r.enqueue_t:.4f}s "
                        "in queue")
                    r.event.set()
                    if self._on_deadline is not None:
                        self._on_deadline()
                else:
                    live.append(r)
            if not live:
                continue
            try:
                if len(live) == 1:
                    feats, ids = live[0].features, live[0].ids
                else:
                    feats = {s: np.concatenate(
                        [np.asarray(r.features[s]) for r in live])
                        for s in live[0].features}
                    ids = {t: np.concatenate(
                        [np.asarray(r.ids[t], dtype=object) for r in live])
                        for t in live[0].ids}
                queue_wait = now - min(r.enqueue_t for r in live)
                result = self._score_fn(feats, ids, num_requests=len(live),
                                        queue_wait_s=queue_wait)
                scores = np.asarray(result.scores)
                off = 0
                for r in live:
                    r.scores = scores[off:off + r.n]
                    off += r.n
                    r.event.set()
            except Exception as e:  # propagate to every waiter, keep serving
                for r in live:
                    r.error = e
                    r.event.set()
