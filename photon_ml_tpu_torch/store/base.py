"""Shared plumbing of the tiered store (port of photon_ml_tpu/store/base.py):
errors, the retry discipline, and the byte/row accounting every tier
reports through.

Everything that crosses a tier boundary goes through `with_retries`: the
same transient/fatal classification and jittered exponential backoff as
the streaming Prefetcher (data/streaming.py), so a flaky transfer is
absorbed bit-exact while a fatal error names the block it killed.  The
counts live on StoreStats and are mirrored into the telemetry registry as
`store.<field>` counters, as in the JAX package.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.utils import faults, locktrace

RETRY_MAX_ATTEMPTS = 3
RETRY_BACKOFF_S = 0.05
RETRY_BACKOFF_JITTER = 0.5


class StoreError(RuntimeError):
    """A tier operation failed after exhausting its retry budget (or hit
    a fatal, non-retryable error).  The message names the block; the
    original failure rides as __cause__."""


def with_retries(fn: Callable[[], object], *, site: str, what: str,
                 on_retry: Optional[Callable[[], None]] = None,
                 jitter: Optional[random.Random] = None,
                 error_cls: type = StoreError,
                 **ctx) -> object:
    """Run `fn` under the chunk-staging retry/backoff discipline with the
    fault-injection site `site` fired before each attempt.  Call it with
    no store lock held: transient retries sleep."""
    jitter = jitter if jitter is not None else random.Random(0)
    attempt = 0
    while True:
        attempt += 1
        try:
            faults.fire(site, **ctx)  # photonlint: disable=PH004
            return fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:
            if isinstance(e, error_cls):
                raise  # a nested retry scope already named the block
            if not faults.is_transient(e):
                raise error_cls(
                    f"{site} failed for {what} (fatal "
                    f"{type(e).__name__}, not retryable)") from e
            if attempt >= RETRY_MAX_ATTEMPTS:
                raise error_cls(
                    f"{site} failed for {what} after "
                    f"{attempt} attempt(s)") from e
            if on_retry is not None:
                on_retry()
            delay = (RETRY_BACKOFF_S * (2 ** (attempt - 1))
                     * (1.0 + RETRY_BACKOFF_JITTER * jitter.random()))
            time.sleep(delay)


class StoreStats:
    """Row/byte accounting for one store, in the JAX package's fields:
    hot/warm/cold counters are PER ROW LOOKUP of the entity store
    (store/entity.py) — a row resolved from the device-resident hot set,
    one staged out of the host warm set, one that needed a cold segment
    read; promotions/spills/evictions count tier movements, and the
    training tenant (store/handles.py) counts evictions, fetches and
    retries.  Thread-safe.  Every note is also
    counted in the registry's `store.<field>` counters."""

    FIELDS = ("hot_hits", "warm_hits", "cold_misses", "promotions",
              "spills", "evictions", "fetches", "retries")

    def __init__(self):
        self._lock = locktrace.tracked(threading.Lock(), "StoreStats._lock")
        for f in self.FIELDS:
            setattr(self, f, 0)

    def _note(self, field: str, n: int) -> None:
        if not n:
            return
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        # registry mirror: telemetry.snapshot() carries the counts without
        # reaching into any store instance
        telemetry.counter(f"store.{field}").inc(n)

    def note_lookup(self, hot: int = 0, warm: int = 0, cold: int = 0) -> None:
        self._note("hot_hits", hot)
        self._note("warm_hits", warm)
        self._note("cold_misses", cold)

    def note_promotion(self, rows: int = 1) -> None:
        self._note("promotions", rows)

    def note_spill(self, n: int = 1) -> None:
        self._note("spills", n)

    def note_eviction(self, n: int = 1) -> None:
        self._note("evictions", n)

    def note_fetch(self, n: int = 1) -> None:
        self._note("fetches", n)

    def note_retry(self) -> None:
        self._note("retries", 1)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}

    def hit_rate(self) -> Optional[float]:
        """Fraction of row lookups served from the hot tier (None before
        any lookup)."""
        with self._lock:
            total = self.hot_hits + self.warm_hits + self.cold_misses
            return (self.hot_hits / total) if total else None
