"""ChunkedGLMObjective: the GLMObjective oracle over streamed chunks (port
of photon_ml_tpu/ops/chunked.py).

The same value / value_and_gradient / hessian_vector / hessian_diagonal
surface as GLMObjective (ops/objective.py), but the feature block lives on
the HOST and every oracle call is one double-buffered pass over a ChunkPlan
(data/streaming.py): chunk i+1 is copied while chunk i runs the same
aggregators of ops/aggregators.py, and the running (value, gradient, ...)
accumulators stay on the device the whole pass.  On the card each chunk's
value+gradient is one launch of the fused kernel, which takes the chunk's
row mask (the tail chunk's padding) and the normalization shift.

Numerics: each chunk's partial aggregate is computed by exactly the code
the resident path runs on that row range, and the accumulation order is
the chunk order, so the streamed oracle matches a chunk-wise resident
evaluation and differs from the single-sum resident evaluation only by
float summation order.

On a mesh (`mesh=` with a data axis D > 1) each rank streams only its row
block of every chunk (`ChunkPlan.rank_blocks`), runs the same launch per
block, and ends each pass with ONE data-axis all_reduce through
`Mesh.collective` (value and gradient packed in one vector, as
`GLMObjective(reduce=)`); the L2 term is added once, after the sum.  The
JAX package gets the same sums from the psums GSPMD inserts into its
accumulators.  Streamed scores are written into a zero-filled [n] and
summed the same way, so every rank holds the whole vector, and the
stochastic lane reduces its chunk sums and each coordinate step's
gradient (optim/stochastic.py).  Every rank then takes the same host
steps on the same reduced values.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device, telemetry
from photon_ml_tpu_torch.data.streaming import (
    STAGE_BACKOFF_JITTER, STAGE_BACKOFF_S, STAGE_MAX_ATTEMPTS, ChunkPlan,
    ChunkSpec, CudaStaging, Prefetcher, StreamStats, bf16_bits, pin_host_array,
)
from photon_ml_tpu_torch.ops import aggregators as agg
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.utils import faults, prng

_SAFE_LABEL = 0.5  # valid for every loss family
# the padding rows of a tail chunk, per leaf
_PAD_FILL = {"x": 0.0, "labels": _SAFE_LABEL, "weights": 0.0, "offsets": 0.0,
             "mask": 0.0}


class LocalSolveError(RuntimeError):
    """A chunk's stochastic local solve failed after exhausting its retry
    budget (or hit a fatal, non-retryable error).  The message names the
    chunk; the original failure rides as __cause__."""

    def __init__(self, message: str, chunk_index: int):
        super().__init__(message)
        self.chunk_index = chunk_index


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


@dataclasses.dataclass
class ChunkedGLMObjective:
    """Weighted GLM loss over a host-resident batch, streamed in chunks.

    `x` / `labels` / `weights` / `offsets` / `mask` are HOST numpy arrays,
    cast once to the compute `dtype` (float32 or float64) on the host, but
    a bf16 X: a CPU torch.bfloat16 tensor (`convert.bf16_from_numpy`
    makes one of raw uint16 bits; a plain uint16 array is integers and is
    cast) or an extension bfloat16 array (data/streaming.py `bf16_bits`)
    is kept as its 2-byte bits, staged through the same ring and
    reinterpreted as bf16 on the device, so each chunk runs the fused
    kernel on bf16 X (the JAX package streams a bf16 host X as it is) and
    the products promote (offsets are the residual
    scores of coordinate descent: the caller reads the device residual
    vector back once per coordinate update, one [n] copy against n*d of
    streamed feature traffic per pass).  `norm` (on `device`, in `dtype`)
    is applied per chunk; its algebra is row-linear plus global shift
    terms, so chunked accumulation is exact.  Sparse host shards are not
    supported: chunking a scipy matrix would re-pack ELL per chunk per pass.

    On CUDA the constant host arrays are page-locked in place
    (data/streaming.py `pin_host_array`); `staging` (the copy stream and
    the pinned ring) and `stats` are shared by every `replace` of the
    objective."""

    loss: PointwiseLoss
    x: np.ndarray
    labels: np.ndarray
    plan: ChunkPlan
    weights: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    norm: Optional[NormalizationContext] = None
    l2_weight: float = 0.0
    stats: StreamStats = dataclasses.field(default_factory=StreamStats)
    prefetch_depth: int = 2
    mesh: Optional[object] = None
    device: Optional[object] = None
    dtype: torch.dtype = torch.float32
    staging: Optional[CudaStaging] = dataclasses.field(default=None, repr=False)
    # the all-ones mask of a full chunk, sliced by every fetch; kept (with
    # its registration) by every replace()
    _ones: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    # x holds a bf16 block's uint16 bits; kept by every replace() that
    # keeps x
    _x_bf16: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the compute dtype is float32 or float64, got {self.dtype} "
                            "(a bf16 X is given as x: its products promote)")
        bits = bf16_bits(self.x)
        if bits is not None:
            self.x, self._x_bf16 = bits, True
        if not isinstance(self.x, np.ndarray):
            raise TypeError("ChunkedGLMObjective requires a dense host "
                            "feature block (sparse shards would re-pack per "
                            "chunk per pass); use the resident sparse path")
        if self.plan.num_rows != self.x.shape[0]:
            raise ValueError(f"plan covers {self.plan.num_rows} rows but the "
                             f"feature block has {self.x.shape[0]}")
        # the rank's data-axis block of every chunk (feature-axis peers
        # stage the same one); None without a data axis to split over
        self._reduce = None
        stage_plan = self.plan
        num_data = 1 if self.mesh is None else self.mesh.num_data
        if num_data > 1:
            from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS
            for spec in self.plan.chunks:
                if spec.padded_rows % num_data:
                    raise ValueError(
                        f"chunk {spec.index} pads to {spec.padded_rows} rows, "
                        f"not a multiple of the mesh data axis {num_data}; "
                        "build the ChunkPlan with row_multiple=data_axis")
            stage_plan = self.plan.rank_blocks(num_data, self.mesh.data_index)
            mesh = self.mesh
            self._reduce = lambda t: mesh.all_reduce(t, DATA_AXIS)
            if self.device is None:
                self.device = mesh.device
        self.device = resolve_device(self.device)
        np_dtype = _np_dtype(self.dtype)
        cast = lambda a: None if a is None else np.ascontiguousarray(a, dtype=np_dtype)
        if not self._x_bf16:
            self.x = cast(self.x)
        self.labels = cast(self.labels)
        self.weights, self.offsets, self.mask = (
            cast(self.weights), cast(self.offsets), cast(self.mask))
        if self._ones is None or self._ones.dtype != np_dtype:
            self._ones = np.ones(stage_plan.chunk_rows, np_dtype)
        if self.device.type == "cuda":
            for a in (self.x, self.labels, self.weights, self.mask, self._ones):
                if a is not None:
                    pin_host_array(a)
        self._prefetcher = Prefetcher(stage_plan, self._fetch,
                                      depth=self.prefetch_depth,
                                      stats=self.stats, device=self.device,
                                      staging=self.staging, pad_fill=_PAD_FILL)
        self.staging = self._prefetcher.staging

    # -- chunk staging (host side) -------------------------------------------
    def _fetch(self, spec: ChunkSpec) -> dict:
        """The chunk's real rows (on a mesh, those of the rank's block;
        none for a block that lies wholly in the tail's padding), views of
        the host arrays (the Prefetcher pads: features 0, labels 0.5,
        weights, offsets and mask 0, so padding rows drop out through the
        mask)."""
        sl = slice(spec.start, spec.stop)
        take = lambda a: None if a is None else a[sl]
        # a bf16 X's bits go as int16, a type every device op takes
        x = self.x[sl].view(np.int16) if self._x_bf16 else self.x[sl]
        return {"x": x, "labels": self.labels[sl],
                "weights": take(self.weights), "offsets": take(self.offsets),
                "mask": (self._ones[:spec.rows] if self.mask is None
                         else self.mask[sl])}

    def _stream(self, pin_epochs: int = 1):
        """One pass of the prefetcher, a bf16 X's staged bits seen as bf16."""
        for spec, ch in self._prefetcher.stream(pin_epochs=pin_epochs):
            if self._x_bf16:
                ch = dict(ch, x=ch["x"].view(torch.bfloat16))
            yield spec, ch

    def _chunk_args(self, ch: dict) -> dict:
        return dict(weights=ch["weights"], offsets=ch["offsets"],
                    norm=self.norm, mask=ch["mask"])

    def _zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _summed(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's pass total summed over the data axis (one
        all_reduce); the total itself without a mesh."""
        return t if self._reduce is None else self._reduce(t)

    # -- DiffFunction surface -------------------------------------------------
    @property
    def dim(self) -> int:
        return self.x.shape[1]

    def value(self, c: torch.Tensor) -> torch.Tensor:
        # the accumulators update in place: they take the place of the JAX
        # package's donated buffers
        acc = self._zeros()
        for _, ch in self._stream():
            acc += agg.value_only(self.loss, ch["x"], ch["labels"], c,
                                  **self._chunk_args(ch))
        acc = self._summed(acc.reshape(1))[0]
        return acc + 0.5 * self.l2_weight * torch.dot(c, c)

    def value_and_gradient(self, c: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        acc_v = self._zeros()
        acc_g = torch.zeros_like(c)
        for _, ch in self._stream():
            v, g = agg.value_and_gradient(self.loss, ch["x"], ch["labels"], c,
                                          **self._chunk_args(ch))
            acc_v += v
            acc_g += g
        if self._reduce is not None:
            vg = self._reduce(torch.cat([acc_v.reshape(1), acc_g]))
            acc_v, acc_g = vg[0], vg[1:]
        return (acc_v + 0.5 * self.l2_weight * torch.dot(c, c),
                acc_g + self.l2_weight * c)

    # -- TwiceDiffFunction surface --------------------------------------------
    def hessian_vector(self, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(c)
        for _, ch in self._stream():
            acc += agg.hessian_vector(self.loss, ch["x"], ch["labels"], c, v,
                                      **self._chunk_args(ch))
        return self._summed(acc) + self.l2_weight * v

    def hessian_diagonal(self, c: torch.Tensor) -> torch.Tensor:
        if self.norm is not None and not self.norm.is_identity:
            raise ValueError(
                "hessian_diagonal is original-space only; use "
                "objective.replace(norm=None) with original-space coefficients")
        acc = torch.zeros_like(c)
        for _, ch in self._stream():
            acc += agg.hessian_diagonal(self.loss, ch["x"], ch["labels"], c,
                                        weights=ch["weights"],
                                        offsets=ch["offsets"], mask=ch["mask"])
        return self._summed(acc) + self.l2_weight

    # -- streamed scoring -----------------------------------------------------
    def scores(self, c: torch.Tensor) -> torch.Tensor:
        """Margins X @ c as one streamed pass, into ONE device [n] tensor
        (the flat residual-score vectors stay device-resident in coordinate
        descent; only the feature block is out of core).  On a mesh each
        rank writes its rows into a zero-filled [n] and one data-axis
        all_reduce makes the whole vector on every rank (x + 0 is exact)."""
        n = self.plan.num_rows
        out = (torch.empty(n, dtype=c.dtype, device=c.device)
               if self._reduce is None
               else torch.zeros(n, dtype=c.dtype, device=c.device))
        for spec, ch in self._stream():
            out[spec.start:spec.stop] = fops.matvec(ch["x"], c)[:spec.rows]
        return self._summed(out)

    # -- stochastic local-solver lane (optim/stochastic.py) -------------------
    def stochastic_pass(self, c: torch.Tensor, *, local_epochs: int,
                        seed: int = 0, pass_index: int = 0,
                        merge: str = "sequential",
                        step_clip: Optional[float] = None):
        """ONE stochastic pass over the chunk stream: each chunk is staged
        once (the Prefetcher pins it) and runs `local_epochs` epochs of
        seeded coordinate descent, so the pass does local_epochs
        gradient-passes of work for a single pass of staging bandwidth.

        Across the stream `merge` picks sequential warm-starting (default)
        or the row-weighted delta average.  The chunk's share of the L2
        term is rows/num_rows.  The coordinate orders are JAX's
        permutations (utils/prng.py) under the key chain
        fold_in(fold_in(fold_in(PRNGKey(seed), pass), chunk), epoch),
        computed on the host and uploaded once per chunk as one
        [epochs, d] index tensor.

        Returns (updated coefficients, entry objective): the summed
        chunk-entry data loss plus the L2 term at the pass-entry model, a
        device scalar.

        On a mesh every rank folds the same keys (the same permutations),
        runs the epochs on its block of the chunk and reduces the chunk's
        entry loss and column sums, then each coordinate step's gradient,
        over the data axis (`_local_epochs(reduce=)`), so every rank ends
        the pass with the same coefficients, bit for bit.  The L2 share
        and the average's weights are the whole chunk's rows.

        Containment: the `solve.local` fault site fires once per (chunk,
        pass); transient failures retry the chunk's local epochs (the
        epochs are deterministic, so a retry is bit-exact), fatal ones
        raise LocalSolveError naming the chunk."""
        from photon_ml_tpu_torch.optim.stochastic import (
            _local_epochs, resolve_step_clip,
        )

        dtype = c.dtype
        l2 = torch.tensor(self.l2_weight, dtype=dtype, device=c.device)
        clip = resolve_step_clip(self.loss, step_clip)
        key0 = prng.fold_in(prng.PRNGKey(seed), pass_index)
        n = self.plan.num_rows
        d = self.dim
        c_start = c
        entry_acc = torch.zeros((), dtype=dtype, device=c.device)
        acc_dw = torch.zeros_like(c) if merge == "average" else None
        jitter = random.Random(pass_index)
        for spec, ch in self._stream(pin_epochs=local_epochs):
            key = prng.fold_in(key0, spec.index)
            perms = torch.as_tensor(
                np.stack([prng.permutation(prng.fold_in(key, e), d)
                          for e in range(local_epochs)]).reshape(local_epochs, d),
                device=c.device)
            rows = self.plan.chunks[spec.index].rows
            l2_local = l2 * (rows / n)
            c_in = c_start if merge == "average" else c
            attempt = 0
            while True:
                attempt += 1
                try:
                    faults.fire("solve.local", chunk=spec.index,
                                epoch=pass_index)
                    c_out, entry = _local_epochs(
                        c_in, ch["x"], ch["labels"], ch["weights"],
                        ch["offsets"], ch["mask"], self.norm, perms,
                        l2_local, clip, loss=self.loss, reduce=self._reduce)
                    break
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:
                    if not faults.is_transient(e):
                        raise LocalSolveError(
                            f"stochastic local solve failed for chunk "
                            f"{spec.index} of {self.plan.num_chunks} "
                            f"(fatal {type(e).__name__}, not retryable)",
                            spec.index) from e
                    if attempt >= STAGE_MAX_ATTEMPTS:
                        raise LocalSolveError(
                            f"stochastic local solve failed for chunk "
                            f"{spec.index} of {self.plan.num_chunks} "
                            f"after {attempt} attempt(s)",
                            spec.index) from e
                    telemetry.counter("stream.local_solve_retries").inc()
                    telemetry.event("local_solve_retry", chunk=spec.index,
                                    attempt=attempt,
                                    error=f"{type(e).__name__}: {e}")
                    delay = (STAGE_BACKOFF_S * (2 ** (attempt - 1))
                             * (1.0 + STAGE_BACKOFF_JITTER
                                * jitter.random()))
                    time.sleep(delay)
            entry_acc = entry_acc + entry
            if merge == "average":
                acc_dw = acc_dw + (rows / n) * (c_out - c_start)
            else:
                c = c_out
        if merge == "average":
            c = c_start + acc_dw
        return c, entry_acc + 0.5 * l2 * torch.dot(c_start, c_start)

    # -- helpers --------------------------------------------------------------
    def replace(self, **kw) -> "ChunkedGLMObjective":
        if "x" in kw:
            kw.setdefault("_x_bf16", False)
        return dataclasses.replace(self, **kw)

    def with_l2(self, l2_weight) -> "ChunkedGLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)
