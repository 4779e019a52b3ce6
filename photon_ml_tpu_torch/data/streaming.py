"""Out-of-core chunk streaming: host shards -> double-buffered device chunks
(port of photon_ml_tpu/data/streaming.py).

  - `ChunkPlan` row-partitions a flat batch into power-of-two-sized chunks
    (utils.math.ceil_pow2), so a stream has at most two chunk shapes: the
    full chunk and the pow-2-padded tail.
  - `Prefetcher` double-buffers: a producer thread stages chunk i+1 while
    chunk i computes, with at most `depth` (default 2) chunks in device
    memory.
  - `StreamStats` is the transfer-size accounting: peak resident chunk
    count/bytes, total bytes staged, retries, and the work done per staged
    byte.

On CUDA the staging is rebuilt for the card (the JAX package's transfer is
one `jnp.asarray` per leaf).  Each chunk goes through a fixed ring of
`depth` device slots:
  - the host->device copy is `non_blocking` on a dedicated copy stream,
    from page-locked host memory: a host array registered in place
    (`pin_host_array`, cudaHostRegister through torch.cuda.cudart()), or,
    for what is not registered (the padded tail, per-update offsets), a
    pinned host ring of `depth` slots allocated once per staging object.
    `CudaStaging.route_bytes` records how many bytes took each route;
  - the consumer's stream waits on the copy's event before it computes;
  - a slot is written again only after an event recorded on the consumer's
    stream behind its last launch on the chunk it held.  The JAX package
    takes "the consumer asked for chunk i+1" to mean "chunk i is done";
    on CUDA, launching work is not finishing it, so the event carries that
    ordering.  So at most `depth` chunks are in device memory, counting
    chunks whose kernels are still running.
Host float64 is cast to the compute dtype on the host, so `total_bytes`
counts device bytes as the JAX package's canonicalized transfer does.

StreamStats mirrors its counts into the telemetry registry (`stream.*`
counters, the `stream.examples_per_staged_byte` gauge), a transient
staging failure emits `stage_retry`, and each chunk's staging is a `stage`
span on the producer thread, as in the JAX package.

On a mesh each rank stages only its own row block of every chunk
(`ChunkPlan.process_block`: data index i owns padded rows [i·per,
(i+1)·per), per = padded_rows // D; feature-axis peers stage the same
block), so StreamStats and the `stream.*` counters count this rank's
staged bytes and real rows, as the JAX package's per-process
`_tree_nbytes` does, and `examples_per_staged_byte` is the rank's own
quotient.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.utils import faults, locktrace
from photon_ml_tpu_torch.utils.math import ceil_pow2

# never plan chunks smaller than this: per-chunk launch overhead would
# dominate
MIN_CHUNK_ROWS = 256

# staging retry policy: transient failures (faults.is_transient) retry up
# to STAGE_MAX_ATTEMPTS with jittered exponential backoff; everything else,
# and always KeyboardInterrupt/SystemExit, propagates at once
STAGE_MAX_ATTEMPTS = 3
STAGE_BACKOFF_S = 0.05
STAGE_BACKOFF_JITTER = 0.5


class ChunkStagingError(RuntimeError):
    """A chunk failed to stage after exhausting its retry budget (or hit a
    fatal, non-retryable error).  The message names the chunk; the original
    failure rides as __cause__."""

    def __init__(self, message: str, chunk_index: int):
        super().__init__(message)
        self.chunk_index = chunk_index


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """One row range [start, stop) padded to `padded_rows` (a power of two).
    Padding rows carry zero features, safe labels and zero weights, and are
    excluded by the chunk mask."""

    index: int
    start: int
    stop: int
    padded_rows: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Static row partition of an [n, ...] batch into pow-2-sized chunks:
    every full chunk shares one shape and the tail is padded to its own
    power of two."""

    num_rows: int
    chunk_rows: int                  # pow2 size of the full chunks
    chunks: Tuple[ChunkSpec, ...]

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def chunk_shapes(self) -> Tuple[int, ...]:
        """Distinct padded sizes, ascending (<= 2 by construction)."""
        return tuple(sorted({c.padded_rows for c in self.chunks}))

    def chunk_bytes(self, bytes_per_row: int) -> int:
        """Device bytes of ONE full chunk (the double-buffer unit)."""
        return self.chunk_rows * bytes_per_row

    def process_block(self, spec: ChunkSpec, *, num_shards: int,
                      shard_lo: int, shard_hi: int) -> Tuple[int, int]:
        """Padded-row offsets [lo, hi) of `spec` owned by data-axis shards
        [shard_lo, shard_hi) of `num_shards`: a rank's share of every
        chunk is the contiguous padded-row block returned here, and it
        fetches, pads and copies only those rows."""
        if spec.padded_rows % num_shards:
            raise ValueError(
                f"chunk {spec.index} pads to {spec.padded_rows} rows, not a "
                f"multiple of {num_shards} data-axis shards; build the plan "
                "with row_multiple=num_shards")
        per = spec.padded_rows // num_shards
        return shard_lo * per, shard_hi * per

    def rank_blocks(self, num_shards: int, shard: int) -> "ChunkPlan":
        """The plan of one data-axis shard's blocks: chunk i's block keeps
        its index, covers the real rows of [start + lo, start + hi) (none
        for a block that lies wholly in the chunk's padding) and pads to
        hi - lo rows.  A Prefetcher over it stages the shard's rows only."""
        blocks = []
        for spec in self.chunks:
            lo, hi = self.process_block(spec, num_shards=num_shards,
                                        shard_lo=shard, shard_hi=shard + 1)
            start = min(spec.start + lo, spec.stop)
            stop = min(spec.start + hi, spec.stop)
            blocks.append(ChunkSpec(index=spec.index, start=start, stop=stop,
                                    padded_rows=hi - lo))
        return ChunkPlan(num_rows=self.num_rows,
                         chunk_rows=self.chunk_rows // num_shards,
                         chunks=tuple(blocks))

    @staticmethod
    def build(num_rows: int, *, chunk_rows: Optional[int] = None,
              hbm_budget_bytes: Optional[int] = None,
              bytes_per_row: Optional[int] = None,
              row_multiple: int = 1) -> "ChunkPlan":
        """Partition `num_rows` rows.

        Either pass `chunk_rows` (rounded up to a power of two) or a device
        budget: the chunk is then the largest power of two such that TWO
        chunks (current + prefetched) fit in `hbm_budget_bytes` given
        `bytes_per_row`.  `row_multiple` rounds every padded chunk size up
        to a multiple (the JAX package's mesh data axis; 1 on one device)."""
        if num_rows < 1:
            raise ValueError(f"num_rows must be >= 1, got {num_rows}")
        if row_multiple < 1:
            raise ValueError(f"row_multiple must be >= 1, got {row_multiple}")
        if chunk_rows is None:
            if hbm_budget_bytes is None or bytes_per_row is None:
                raise ValueError("pass chunk_rows, or hbm_budget_bytes with "
                                 "bytes_per_row")
            per_chunk = max(hbm_budget_bytes // (2 * max(bytes_per_row, 1)), 1)
            chunk_rows = ceil_pow2(per_chunk)
            if chunk_rows > per_chunk:        # ceil overshot the budget
                chunk_rows //= 2
        mult = int(row_multiple)
        ceil_mult = lambda v: -(-int(v) // mult) * mult
        chunk_rows = int(ceil_pow2(max(int(chunk_rows), MIN_CHUNK_ROWS)))
        chunk_rows = min(chunk_rows, int(ceil_pow2(num_rows)))
        chunk_rows = ceil_mult(chunk_rows)
        chunks = []
        start = 0
        while start < num_rows:
            stop = min(start + chunk_rows, num_rows)
            rows = stop - start
            padded = (chunk_rows if rows == chunk_rows
                      else min(ceil_mult(ceil_pow2(rows)), chunk_rows))
            chunks.append(ChunkSpec(index=len(chunks), start=start, stop=stop,
                                    padded_rows=padded))
            start = stop
        return ChunkPlan(num_rows=num_rows, chunk_rows=chunk_rows,
                         chunks=tuple(chunks))


def bf16_bits(x) -> Optional[np.ndarray]:
    """The 2-byte bits of a bf16 host block as a uint16 array (a view,
    made contiguous when x is not), or None for any other block.  A bf16
    block comes in a form that carries its type: a CPU torch.bfloat16
    tensor (`convert.bf16_from_numpy` makes one of raw bits; numpy here
    holds no bf16) or a numpy array of an extension bfloat16 dtype.  A
    plain uint16 array is integers, not bits.  The bits are staged as they
    are and reinterpreted as bf16 on the device (`.view(torch.bfloat16)`):
    no wider copy is made."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.bfloat16 or x.device.type != "cpu":
            return None
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    if isinstance(x, np.ndarray) and x.dtype.name == "bfloat16":
        return np.ascontiguousarray(x).view(np.uint16)
    return None


def stream_row_bytes(d: int, x_bytes: int, leaf_bytes: int) -> int:
    """Bytes one row of a streamed chunk stages: X's d elements at
    `x_bytes` each (2 for a bf16 block's bits) and the four [n] streams
    (labels, weights, offsets, mask) at `leaf_bytes`; ChunkPlan.build's
    `bytes_per_row`."""
    return d * x_bytes + 4 * leaf_bytes


def pad_rows_host(a: np.ndarray, rows: int, fill) -> np.ndarray:
    """Host-side row pad of a [r, ...] slice to [rows, ...] with `fill`."""
    r = a.shape[0]
    if r == rows:
        return a
    out = np.full((rows,) + a.shape[1:], fill, a.dtype)
    out[:r] = a
    return out


class StreamStats:
    """Transfer-size accounting for one streaming consumer.
    `peak_resident_chunks` counts chunks alive in device memory at once
    (staged, or consumed with kernels possibly still running); the
    double-buffer invariant is that it never exceeds the Prefetcher depth.
    `examples_processed / total_bytes` is the out-of-core efficiency
    number: the stochastic lane raises it by pinning each chunk for K
    local epochs."""

    def __init__(self):
        self._lock = locktrace.tracked(threading.Lock(),
                                       "StreamStats._lock")
        self.total_bytes = 0
        self.chunks_staged = 0
        self.passes = 0
        self.resident_chunks = 0
        self.resident_bytes = 0
        self.peak_resident_chunks = 0
        self.peak_resident_bytes = 0
        self.retries = 0
        self.gave_up = 0
        self.local_epochs = 0
        self.examples_processed = 0

    def note_retry(self) -> None:
        with self._lock:
            self.retries += 1
        telemetry.counter("stream.retries").inc()

    def note_gave_up(self) -> None:
        with self._lock:
            self.gave_up += 1
        telemetry.counter("stream.gave_up").inc()

    def note_staged(self, nbytes: int) -> None:
        with self._lock:
            self.total_bytes += nbytes
            self.chunks_staged += 1
            self.resident_chunks += 1
            self.resident_bytes += nbytes
            self.peak_resident_chunks = max(self.peak_resident_chunks,
                                            self.resident_chunks)
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes)
        # process-global mirror (telemetry.snapshot() aggregates every
        # Prefetcher; per-instance numbers stay on this object)
        telemetry.counter("stream.staged_bytes").inc(nbytes)
        telemetry.counter("stream.chunks_staged").inc()

    def note_released(self, nbytes: int) -> None:
        with self._lock:
            self.resident_chunks -= 1
            self.resident_bytes -= nbytes

    def note_pass(self) -> None:
        with self._lock:
            self.passes += 1

    def note_processed(self, rows: int, epochs: int = 1) -> None:
        """`epochs` chunk-epochs of consumer work on one resident chunk
        covering `rows` real (unpadded) rows."""
        with self._lock:
            self.local_epochs += epochs
            self.examples_processed += rows * epochs
        telemetry.counter("stream.local_epochs").inc(epochs)
        telemetry.counter("stream.examples").inc(rows * epochs)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            snap = {"total_bytes": self.total_bytes,
                    "chunks_staged": self.chunks_staged,
                    "passes": self.passes,
                    "peak_resident_chunks": self.peak_resident_chunks,
                    "peak_resident_bytes": self.peak_resident_bytes,
                    "retries": self.retries,
                    "gave_up": self.gave_up,
                    "local_epochs": self.local_epochs,
                    "examples_processed": self.examples_processed}
        snap["examples_per_staged_byte"] = (
            snap["examples_processed"] / snap["total_bytes"]
            if snap["total_bytes"] else 0.0)
        # metrics mirror: the ratio as a gauge, so operators see
        # work-per-staged-byte without dividing counters themselves
        telemetry.gauge("stream.examples_per_staged_byte").set(
            snap["examples_per_staged_byte"])
        return snap


# -- page-locked host memory ---------------------------------------------------
# base address -> bytes.  Page locking is state of the CUDA runtime for the
# whole process, so the record of it is too: one registration per host
# buffer, whoever streams it.  The lock is reentrant: a registered array's
# finalizer (which must unregister before numpy frees the buffer) can run
# from a garbage collection inside a locked region of the same thread.
_REGISTERED: Dict[int, int] = {}
_REGISTER_LOCK = threading.RLock()


def _unregister(ptr: int) -> None:
    with _REGISTER_LOCK:
        if _REGISTERED.pop(ptr, None) is not None:
            torch.cuda.cudart().cudaHostUnregister(ptr)


def _clear_cuda_error() -> None:
    """Reset the CUDA runtime's last error after a refused registration,
    so no later launch check reports it.  torch.cuda.cudart() has no
    cudaGetLastError; the runtime library torch loaded does."""
    import ctypes
    import glob
    import os
    libs = glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib", "libcudart*.so*"))
    names = libs + ["libcudart.so.12", "libcudart.so"]
    for name in names:
        try:
            ctypes.CDLL(name).cudaGetLastError()
            return
        except OSError:
            continue
    raise RuntimeError("cudaHostRegister failed and the CUDA runtime's error "
                       "could not be cleared")


def pin_host_array(a: np.ndarray) -> bool:
    """Page-lock a C-contiguous host array in place (cudaHostRegister), so
    copies from any slice of it run asynchronously at the bus rate.  True
    when it is (or already was) registered; False when CUDA refuses,
    and the array's chunks then go through the pinned ring.  The
    registration ends when the array is garbage (`weakref.finalize`, which
    runs before numpy frees the buffer)."""
    if not (a.flags.c_contiguous and a.nbytes):
        return False
    ptr = a.__array_interface__["data"][0]
    with _REGISTER_LOCK:
        if ptr in _REGISTERED:
            return True
        err = torch.cuda.cudart().cudaHostRegister(ptr, a.nbytes, 0)
        if int(err) != 0:
            _clear_cuda_error()
            return False
        _REGISTERED[ptr] = a.nbytes
    weakref.finalize(a, _unregister, ptr)
    return True


def is_pinned(a: np.ndarray) -> bool:
    """Does `a` lie inside one registered host buffer?"""
    lo = a.__array_interface__["data"][0]
    hi = lo + a.nbytes
    with _REGISTER_LOCK:
        registered = _REGISTERED.copy()
    return any(p <= lo and hi <= p + n for p, n in registered.items())


class CudaStaging:
    """The card's side of a chunk stream: a copy stream, a pinned host ring
    of `depth` slots (allocated once, for leaves that are not registered in
    place), and per slot the event of its copy and the event behind its
    consumer's last launch.  The ring of `depth` device slots is allocated
    per pass (`stage` fills the pass's `ring` dict) and dropped after it.
    Shared by the prefetchers of one objective (ChunkedGLMObjective.replace
    keeps it), so the pinned ring is allocated once per plan."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self.copy_stream = torch.cuda.Stream(device)
        self.copied = [torch.cuda.Event() for _ in range(depth)]
        self.released = [torch.cuda.Event() for _ in range(depth)]
        self._pinned: Dict[Tuple[int, str], torch.Tensor] = {}
        self.route_bytes = {"registered": 0, "pinned_ring": 0}

    def _pinned_slot(self, slot: int, name: str, a: np.ndarray) -> torch.Tensor:
        buf = self._pinned.get((slot, name))
        if buf is None or buf.numel() < a.size or buf.dtype != torch.from_numpy(a[:0]).dtype:
            buf = torch.empty(max(a.size, 1), dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=True)
            self._pinned[(slot, name)] = buf
        return buf[:a.size].view(a.shape)

    def _device_slot(self, ring: dict, slot: int, name: str, a: np.ndarray,
                     rows: int, consumer: torch.cuda.Stream) -> torch.Tensor:
        """Slot `slot`'s device buffer for leaf `name`, [rows, ...] (the
        plan's full chunk), made at first use in the pass.  It is allocated
        on the copy stream, which writes it first: memory the consumer's
        stream freed (and may still be reading through queued kernels) is
        never handed to it; marked used by the consumer's stream, so the
        caching allocator reuses it only after both are done with it."""
        t = ring.get((slot, name))
        if t is None:
            with torch.cuda.stream(self.copy_stream):
                t = torch.empty((rows,) + a.shape[1:],
                                dtype=torch.from_numpy(a[:0]).dtype,
                                device=self.device)
            t.record_stream(consumer)
            ring[(slot, name)] = t
        return t

    def stage(self, host: dict, spec: ChunkSpec, slot: int, ring: dict,
              rows: int, consumer: torch.cuda.Stream, pad_fill: dict) -> dict:
        """Copy one chunk's host leaves (its real rows) into device slot
        `slot` and fill the padding rows on the device (producer thread):
        wait (on the copy stream) for the slot's last consumer, copy, pad,
        record the slot's copy event."""
        self.copied[slot].synchronize()   # the pinned slot's last copy is done
        out = {}
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.released[slot])
            for name, a in host.items():
                if a is None:
                    out[name] = None
                    continue
                dev = self._device_slot(ring, slot, name, a, rows,
                                        consumer)[:spec.padded_rows]
                if is_pinned(a):
                    src = torch.from_numpy(a)
                    self.route_bytes["registered"] += a.nbytes
                else:
                    src = self._pinned_slot(slot, name, a)
                    np.copyto(src.numpy(), a)
                    self.route_bytes["pinned_ring"] += a.nbytes
                dev[:spec.rows].copy_(src, non_blocking=True)
                if spec.rows < spec.padded_rows:
                    dev[spec.rows:].fill_(pad_fill.get(name, 0.0))
                out[name] = dev
            self.copied[slot].record(self.copy_stream)
        return out


_DONE = object()


def _tree_nbytes(chunk: dict) -> int:
    return sum(int(t.nbytes) for t in chunk.values() if t is not None)


class Prefetcher:
    """Double-buffered host->device chunk pipeline over one ChunkPlan.

    `fetch(spec)` returns the chunk's HOST leaves ({name: numpy array or
    None}: its `spec.rows` real rows, in the compute dtype); the
    Prefetcher pads them to `spec.padded_rows` with `pad_fill[name]` (0
    when absent): on the host on the CPU, on the device on CUDA, so a
    chunk never makes a padded host copy.  A background thread
    runs fetch + device transfer for chunk i+1 while the consumer computes
    on chunk i.  Lookahead is bounded by a semaphore, and on CUDA by the
    ring of `depth` device slots, so at most `depth` chunks are in device
    memory.  Each `stream()` call is one full pass; the thread dies with
    the pass.  On the CPU a full chunk's tensors share the host arrays'
    memory.

    Failure containment: transient staging errors (faults.is_transient)
    retry up to STAGE_MAX_ATTEMPTS with jittered exponential backoff (StreamStats
    counts the retries); a chunk that exhausts its budget raises
    ChunkStagingError naming the chunk in the consumer.  Fatal errors skip
    the retry loop, and KeyboardInterrupt/SystemExit re-raise as
    themselves in the consumer."""

    def __init__(self, plan: ChunkPlan, fetch: Callable[[ChunkSpec], dict],
                 depth: int = 2, stats: Optional[StreamStats] = None,
                 device=None,
                 staging: Optional[CudaStaging] = None,
                 pad_fill: Optional[Dict[str, float]] = None):
        if depth < 2:
            # the producer stages chunk k only after the consumer has taken
            # chunk k-depth+1, so depth 1 would deadlock before chunk 0
            raise ValueError(f"depth must be >= 2, got {depth}")
        self.plan = plan
        self.fetch = fetch
        self.depth = depth
        self.stats = stats if stats is not None else StreamStats()
        self.device = resolve_device(device)
        self.pad_fill = dict(pad_fill or {})
        self.staging = staging
        if self.device.type == "cuda" and self.staging is None:
            self.staging = CudaStaging(self.device, depth)

    def _transfer(self, host: dict, spec: ChunkSpec, slot: int, ring: dict,
                  consumer) -> dict:
        if self.staging is None:
            return {k: None if a is None else torch.from_numpy(
                pad_rows_host(a, spec.padded_rows, self.pad_fill.get(k, 0.0)))
                for k, a in host.items()}
        return self.staging.stage(host, spec, slot, ring, self.plan.chunk_rows,
                                  consumer, self.pad_fill)

    def _stage_with_retry(self, spec: ChunkSpec, jitter: random.Random,
                          slot: int, ring: dict, consumer) -> dict:
        """fetch + device transfer for one chunk, absorbing transient
        failures up to the attempt budget."""
        attempt = 0
        while True:
            attempt += 1
            try:
                faults.fire("stage.fetch", chunk=spec.index)
                host = self.fetch(spec)
                faults.fire("stage.transfer", chunk=spec.index)
                return self._transfer(host, spec, slot, ring, consumer)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                if not faults.is_transient(e):
                    self.stats.note_gave_up()
                    raise ChunkStagingError(
                        f"chunk staging failed for chunk {spec.index} of "
                        f"{self.plan.num_chunks} (fatal "
                        f"{type(e).__name__}, not retryable)",
                        spec.index) from e
                if attempt >= STAGE_MAX_ATTEMPTS:
                    self.stats.note_gave_up()
                    raise ChunkStagingError(
                        f"chunk staging failed for chunk {spec.index} of "
                        f"{self.plan.num_chunks} after {attempt} "
                        f"attempt(s)", spec.index) from e
                self.stats.note_retry()
                telemetry.event("stage_retry", chunk=spec.index,
                                attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                # exponential backoff with jitter, so concurrent streams do
                # not re-hammer a struggling source in lockstep
                delay = (STAGE_BACKOFF_S * (2 ** (attempt - 1))
                         * (1.0 + STAGE_BACKOFF_JITTER * jitter.random()))
                time.sleep(delay)

    def stream(self, pin_epochs: int = 1) -> Iterator[Tuple[ChunkSpec, dict]]:
        """One full pass over the plan's chunks.

        `pin_epochs` declares how many local epochs the consumer will run
        on each yielded chunk before asking for the next one (the
        stochastic lane, optim/stochastic.py): the chunk is staged once and
        stays in its slot for all of them while the producer prefetches the
        next one.  StreamStats accounts the extra work (`local_epochs` +=
        pin_epochs, `examples_processed` += rows * pin_epochs per chunk)."""
        if pin_epochs < 1:
            raise ValueError(f"pin_epochs must be >= 1, got {pin_epochs}")
        self.stats.note_pass()
        lookahead = threading.Semaphore(self.depth - 1)
        q: "queue.Queue" = queue.Queue()
        cancel = threading.Event()
        # deterministic per-pass jitter keeps retry timing reproducible
        jitter = random.Random(self.stats.passes)
        # the pass's device slots {(slot, leaf): tensor}, filled by the
        # producer and dropped with the pass
        ring: dict = {}
        staging = self.staging
        consumer = (None if staging is None
                    else torch.cuda.current_stream(self.device))

        def producer():
            spec = None
            try:
                for spec in self.plan.chunks:
                    # token acquired BEFORE staging: the device never holds
                    # more than `depth` chunks, counting the one the
                    # consumer is computing on
                    while not lookahead.acquire(timeout=0.1):
                        if cancel.is_set():
                            return
                    if cancel.is_set():
                        return
                    slot = spec.index % self.depth
                    # span on the PREFETCH thread: staging gets its own
                    # track in the trace, overlapping the consumer's solve
                    with telemetry.span("stage", chunk=spec.index,
                                        rows=spec.rows):
                        dev = self._stage_with_retry(spec, jitter, slot, ring,
                                                     consumer)
                    self.stats.note_staged(_tree_nbytes(dev))
                    q.put((spec, slot, dev))
                q.put(_DONE)
            except (KeyboardInterrupt, SystemExit) as e:
                # not a staging failure: re-raised as itself in the consumer
                q.put(("interrupt", e))
            except ChunkStagingError as e:  # already named and chained
                q.put(e)
            except BaseException as e:  # unexpected: name the chunk anyway
                idx = spec.index if spec is not None else -1
                err = ChunkStagingError(
                    f"chunk staging failed for chunk {idx} of "
                    f"{self.plan.num_chunks}", max(idx, 0))
                err.__cause__ = e
                q.put(err)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="photon-chunk-prefetch")
        thread.start()
        prev = None   # (slot, bytes) of the chunk the consumer moved past

        def release(prev_chunk):
            slot, nbytes = prev_chunk
            if staging is not None:
                # behind the consumer's last launch on the chunk: the slot
                # is rewritten only after those kernels have run
                staging.released[slot].record(consumer)
            self.stats.note_released(nbytes)

        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "interrupt":
                    raise item[1]
                if isinstance(item, BaseException):
                    raise item
                spec, slot, dev = item
                if prev is not None:
                    # the consumer asked for chunk i+1: it has launched all
                    # its work on chunk i
                    release(prev)
                prev = (slot, _tree_nbytes(dev))
                if staging is not None:
                    consumer.wait_event(staging.copied[slot])
                lookahead.release()
                self.stats.note_processed(spec.rows, pin_epochs)
                yield spec, dev
                dev = None
        finally:
            cancel.set()
            if prev is not None:
                release(prev)
            thread.join(timeout=60)
