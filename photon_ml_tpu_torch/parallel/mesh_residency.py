"""Mesh-resident coordinate data: each rank's padded block of the static
arrays is staged ONCE (port of photon_ml_tpu/parallel/mesh_residency.py).

  * `MeshResidency` memoizes each coordinate's static arrays (feature
    blocks, labels, masks, weights, the ADMM grid and its Gram
    eigendecomposition), each rank's own row block padded to the mesh
    multiple, keyed per coordinate with prefix invalidation (the residency
    manager's eviction hook).  A warm outer iteration stages only the
    per-visit operands: residual offsets and x0.
  * `TransferStats` counts every staged byte of this rank, COLD (static
    data, staged once per residency) vs WARM (per-visit operands), so the
    no-retransfer property is observable.
  * Staging runs under the store's transient/fatal retry discipline: the
    `mesh.stage` fault site fires before each transfer (`admm.stage` before
    each derived aggregate).

A rank stages only its own block: on a multi-process run the bytes are
per process, as the JAX package's multi-host accounting.
"""
from __future__ import annotations

import random
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.parallel.mesh import (
    Mesh, data_sharding, feature_sharding,
)
from photon_ml_tpu_torch.store.base import with_retries
from photon_ml_tpu_torch.store.handles import ResidencyRegistry, _as_tuple
from photon_ml_tpu_torch.utils import locktrace


class MeshStagingError(RuntimeError):
    """A mesh transfer failed after exhausting its retries (or hit a fatal
    error).  The message names the residency key; the failure rides as
    __cause__."""


class TransferStats:
    """Byte accounting for mesh staging, this rank's share: COLD bytes are
    static coordinate data staged once per residency; WARM bytes are the
    per-visit operands (residual offsets, x0).  Thread-safe."""

    def __init__(self):
        self._lock = locktrace.tracked(threading.Lock(),
                                       "TransferStats._lock")
        self.cold_bytes = 0
        self.warm_bytes = 0
        self.cold_stages = 0
        self.warm_stages = 0
        self.invalidations = 0
        self.evictions = 0          # FIFO capacity evictions
        self.retries = 0

    def note_stage(self, nbytes: int, warm: bool) -> None:
        with self._lock:
            if warm:
                self.warm_bytes += nbytes
                self.warm_stages += 1
            else:
                self.cold_bytes += nbytes
                self.cold_stages += 1
        kind = "warm" if warm else "cold"
        telemetry.counter(f"mesh.{kind}_bytes").inc(nbytes)
        telemetry.counter(f"mesh.{kind}_stages").inc()

    def note_invalidation(self, count: int = 1) -> None:
        with self._lock:
            self.invalidations += count
        telemetry.counter("mesh.invalidations").inc(count)

    def note_eviction(self) -> None:
        with self._lock:
            self.evictions += 1
        telemetry.counter("mesh.evictions").inc()

    def note_retry(self) -> None:
        with self._lock:
            self.retries += 1
        telemetry.counter("mesh.retries").inc()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"cold_bytes": self.cold_bytes,
                    "warm_bytes": self.warm_bytes,
                    "cold_stages": self.cold_stages,
                    "warm_stages": self.warm_stages,
                    "invalidations": self.invalidations,
                    "evictions": self.evictions,
                    "retries": self.retries}

    @staticmethod
    def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
        return {k: after[k] - before.get(k, 0) for k in after}


def staged_nbytes(staged) -> int:
    """Bytes of one staged block: a tensor, a feature matrix's tensors, or
    a tuple of them."""
    if staged is None:
        return 0
    if isinstance(staged, torch.Tensor):
        return int(staged.numel() * staged.element_size())
    if isinstance(staged, (tuple, list)):
        return sum(staged_nbytes(s) for s in staged)
    return sum(staged_nbytes(getattr(staged, f)) for f in (
        "x", "factors", "indices", "values", "csc_row", "csc_val", "csc_end")
        if hasattr(staged, f))


def _to_device(a, mesh: Mesh, dtype):
    """A host or device block onto the rank's device: floating values in
    `dtype` (bf16 values stay bf16: the design matrix's bf16 storage, as
    ops/features.py keeps it); a sparse block as a PaddedSparse with its own
    column view."""
    from photon_ml_tpu_torch.ops import features as fops
    if isinstance(a, (fops.PaddedSparse, fops.KroneckerDesign)) \
            or fops._is_scipy_sparse(a):
        return fops.as_feature_matrix(a, mesh.device, dtype, with_csc=True)
    t = torch.as_tensor(a)
    if t.is_floating_point() and dtype is not None:
        return t.to(device=mesh.device, dtype=fops._storage(t.dtype, dtype))
    return t.to(device=mesh.device)


def _stage_block(mesh: Mesh, src, fill, spec: str, dtype):
    """This rank's block of `src` under `spec` ("data": row block padded
    with `fill`; "feature": entry j of an [F, ...] array; "replicated":
    the whole array), on the rank's device."""
    from photon_ml_tpu_torch.ops import features as fops
    if spec == "replicated":
        return _to_device(src, mesh, dtype)
    if spec == "feature":
        return _to_device(feature_sharding(mesh, src), mesh, dtype)
    if fops._is_scipy_sparse(src):
        # the shard's own rows, then its own column view, then zero rows
        lo, hi, _ = mesh.block(src.shape[0])
        rows = src[min(lo, src.shape[0]): min(hi, src.shape[0])]
        return fops.pad_rows(_to_device(rows, mesh, dtype),
                             (hi - lo) - rows.shape[0])
    return _to_device(data_sharding(mesh, src, fill), mesh, dtype)


class MeshResidency:
    """Keyed registry of each rank's staged static blocks, a tenant of the
    store's ResidencyRegistry.  An entry is keyed (coordinate key, field,
    mesh fingerprint, dtype) and pins the SOURCE it was staged from: a
    call with another source object re-stages in place.  Bounded FIFO."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self.stats = TransferStats()
        self._registry = ResidencyRegistry(
            max_entries=max_entries,
            on_eviction=self.stats.note_eviction,
            on_invalidation=self.stats.note_invalidation,
            prefix_key=lambda k: k[0])
        self._jitter = random.Random(0)

    def _transfer_with_retry(self, mesh, host_or_build, fill, spec, dtype,
                             key, field, warm: bool):
        def stage():
            with telemetry.span("mesh_stage", key=str(key), field=field,
                                warm=warm):
                src = (host_or_build() if callable(host_or_build)
                       else host_or_build)
                staged = _stage_block(mesh, src, fill, spec, dtype)
            self.stats.note_stage(staged_nbytes(staged), warm=warm)
            return staged

        return with_retries(
            stage, site="mesh.stage", what=f"{key!r}/{field}",
            on_retry=self.stats.note_retry, jitter=self._jitter,
            error_cls=MeshStagingError, key=str(key), field=field)

    def stage_static(self, key, field: str, mesh: Mesh, source, fill=0.0, *,
                     build: Optional[Callable[[], object]] = None,
                     spec: str = "data", dtype=None):
        """Memoized block of one static array (or feature matrix).
        `source` anchors identity: the same source object returns the
        cached block with no transfer; another re-stages (counting an
        invalidation).  `build` derives the staged array from the source,
        deferred so a hit never builds it."""
        if source is None:
            return None
        full_key = (_as_tuple(key), field, mesh.fingerprint(), dtype)
        staged, replacing = self._registry.lookup(full_key, source)
        if staged is not None:
            return staged
        staged = self._transfer_with_retry(
            mesh, build if build is not None else source, fill, spec, dtype,
            key, field, warm=False)
        if replacing:
            self.stats.note_invalidation()
        self._registry.commit(full_key, source, staged)
        return staged

    def stage_derived(self, key, field: str, mesh: Mesh, source,
                      build: Callable[[], object], *,
                      site: str = "admm.stage"):
        """Memoized device-derived block (the ADMM lane's Gram
        eigendecomposition): `build()` runs once per (key, field, mesh),
        anchored on the staged `source`'s identity, under the retry
        discipline at `site`; its bytes count COLD."""
        full_key = (_as_tuple(key), field, mesh.fingerprint(), None)
        staged, replacing = self._registry.lookup(full_key, source)
        if staged is not None:
            return staged

        def derive():
            with telemetry.span("mesh_stage", key=str(key), field=field,
                                warm=False):
                out = build()
            self.stats.note_stage(staged_nbytes(out), warm=False)
            return out

        staged = with_retries(
            derive, site=site, what=f"{key!r}/{field}",
            on_retry=self.stats.note_retry, jitter=self._jitter,
            error_cls=MeshStagingError, key=str(key), field=field)
        if replacing:
            self.stats.note_invalidation()
        self._registry.commit(full_key, source, staged)
        return staged

    def stage_update(self, mesh: Mesh, array, fill=0.0, *, spec: str = "data",
                     dtype=None, key="update", field: str = "operand"):
        """Per-visit operand staging (residual offsets, x0): never
        memoized, counted WARM."""
        if array is None:
            return None
        return self._transfer_with_retry(mesh, array, fill, spec, dtype,
                                         key, field, warm=True)

    def invalidate(self, key) -> int:
        """Drop every entry whose coordinate key starts with `key`."""
        return self._registry.invalidate(_as_tuple(key))

    def clear(self) -> int:
        return self._registry.clear()

    def num_entries(self) -> int:
        return self._registry.num_entries()

    def keys(self) -> Tuple[tuple, ...]:
        return self._registry.keys()


_DEFAULT: Optional[MeshResidency] = None
_DEFAULT_LOCK = threading.Lock()


def default_residency() -> MeshResidency:
    """The process-global registry: every estimator of the process stages
    through it, so the descent loop and the CLI summary read one
    TransferStats."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MeshResidency()
    return _DEFAULT


def transfer_snapshot() -> Dict[str, int]:
    """Current (monotonic) transfer counters; diff with TransferStats.delta."""
    return default_residency().stats.snapshot()


def invalidate(key) -> int:
    return default_residency().invalidate(key)


def clear() -> int:
    return default_residency().clear()

