"""The (data, feature) mesh over torch.distributed ranks, its placement
helpers and the one collective wrapper (port of
photon_ml_tpu/parallel/mesh.py).

JAX drives a mesh of devices from one process and GSPMD inserts the
reductions.  torch.distributed has one device per process, so the port's
mesh is the world group (or a subset of its ranks) laid out as
``data x feature`` with "data" outermost (rank = i * F + j, as
`make_mesh` orders devices in the JAX package).  Rank (i, j) holds one
block on its own device; the reductions GSPMD would insert are explicit
calls of `Mesh.all_reduce` over subgroups made once per mesh:

  - axis "data":    the D ranks that share a feature index j (row blocks of
                    one column block): gradient sums of data parallelism,
                    entity-table assembly, the ADMM residual product;
  - axis "feature": the F ranks that share a data index i: the ADMM margin
                    consensus;
  - axis "world":   every rank of the mesh (packed scalar sums).

Every collective goes through `Mesh.collective`, which takes only
`all_reduce` (sum) and `broadcast`, the two that both NCCL and gloo run on
CUDA tensors, and counts calls and elements per axis (`CollectiveStats`):
the port's stand-in for the JAX package's HLO collective accounting.

A mesh without a process group (one rank, nothing initialized) runs the
same code with each collective an identity, still counted.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
FEATURE_AXIS = "feature"
WORLD_AXIS = "world"
_AXES = (DATA_AXIS, FEATURE_AXIS, WORLD_AXIS)
COLLECTIVES = ("all_reduce", "broadcast")


class CollectiveStats:
    """Calls and elements per (collective, axis) made through a mesh's
    wrapper.  `snapshot()` is a flat dict; consumers diff two snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def note(self, op: str, axis: str, elements: int) -> None:
        with self._lock:
            for key, inc in ((f"{op}.{axis}.calls", 1),
                             (f"{op}.{axis}.elements", int(elements))):
                self._counts[key] = self._counts.get(key, 0) + inc

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @staticmethod
    def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
        return {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a (data, feature) mesh.  `groups` maps an axis
    to this rank's process group on it (None: no process group, every
    collective an identity)."""

    num_data: int
    num_feature: int
    rank: int                         # this rank's position in the mesh
    device: torch.device
    backend: Optional[str] = None
    groups: Optional[Dict[str, object]] = None
    ranks: Tuple[int, ...] = (0,)     # world ranks of the mesh, in mesh order
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.num_data, FEATURE_AXIS: self.num_feature}

    @property
    def size(self) -> int:
        return self.num_data * self.num_feature

    @property
    def data_index(self) -> int:
        return self.rank // self.num_feature

    @property
    def feature_index(self) -> int:
        return self.rank % self.num_feature

    def axis_size(self, axis: str) -> int:
        return {DATA_AXIS: self.num_data, FEATURE_AXIS: self.num_feature,
                WORLD_AXIS: self.size}[axis]

    def fingerprint(self) -> tuple:
        return (self.num_data, self.num_feature, self.ranks, str(self.device))

    # -- the collective wrapper -------------------------------------------
    def collective(self, op: str, tensor: torch.Tensor, axis: str,
                   src: int = 0) -> torch.Tensor:
        """Run `op` in place over `axis` and count it.  `op` is
        "all_reduce" (sum) or "broadcast" (from the axis-local rank
        `src`); anything else raises on every backend."""
        if op not in COLLECTIVES:
            raise ValueError(
                f"collective {op!r} refused: the mesh runs only "
                f"{' and '.join(COLLECTIVES)} (the two collectives NCCL and "
                "gloo both run on CUDA tensors)")
        if axis not in _AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        self.stats.note(op, axis, tensor.numel())
        if self.groups is None:
            return tensor
        import torch.distributed as dist
        group = self.groups[axis]
        if op == "all_reduce":
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        else:
            dist.broadcast(tensor, src=self._axis_ranks(axis)[src],
                           group=group)
        return tensor

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        return self.collective("all_reduce", tensor, axis)

    def broadcast(self, tensor: torch.Tensor, axis: str = WORLD_AXIS,
                  src: int = 0) -> torch.Tensor:
        return self.collective("broadcast", tensor, axis, src=src)

    def _axis_ranks(self, axis: str) -> List[int]:
        i, j, F = self.data_index, self.feature_index, self.num_feature
        if axis == DATA_AXIS:
            pos = [a * F + j for a in range(self.num_data)]
        elif axis == FEATURE_AXIS:
            pos = [i * F + b for b in range(F)]
        else:
            pos = list(range(self.size))
        return [self.ranks[p] for p in pos]

    # -- row and lane blocks ----------------------------------------------
    def block(self, n: int, axis: str = DATA_AXIS) -> Tuple[int, int, int]:
        """(lo, hi, n_pad): this rank's block [lo, hi) of a length-n axis
        padded to a multiple of the axis size (hi may pass n: those rows
        are padding)."""
        parts = self.axis_size(axis)
        idx = self.data_index if axis == DATA_AXIS else self.feature_index
        n_pad = -(-n // parts) * parts
        b = n_pad // parts
        return idx * b, (idx + 1) * b, n_pad

    def assemble(self, local: torch.Tensor, n: int,
                 axis: str = DATA_AXIS) -> torch.Tensor:
        """The full length-n leading axis on every rank of `axis`, from
        each rank's block: a zero-filled table in which this rank wrote
        its block, summed by one all_reduce (x + 0 is exact, so the
        assembled rows are the ranks' own bits)."""
        lo, hi, n_pad = self.block(n, axis)
        full = local.new_zeros((n_pad,) + tuple(local.shape[1:]))
        full[lo:hi] = local
        return self.all_reduce(full, axis)[:n]


def _make_groups(num_data: int, num_feature: int,
                 ranks: Sequence[int]) -> List[Dict[str, object]]:
    """Every rank of the world makes every subgroup, in one order (a
    torch.distributed requirement); returns the groups of each mesh
    position."""
    import torch.distributed as dist
    F = num_feature
    world = dist.new_group(list(ranks)) if len(ranks) != dist.get_world_size() \
        else dist.group.WORLD
    cols = [dist.new_group([ranks[a * F + j] for a in range(num_data)])
            for j in range(F)]
    rows = [dist.new_group([ranks[i * F + b] for b in range(F)])
            for i in range(num_data)]
    return [{DATA_AXIS: cols[p % F], FEATURE_AXIS: rows[p // F],
             WORLD_AXIS: world} for p in range(len(ranks))]


def make_mesh(num_data: Optional[int] = None, num_feature: int = 1, *,
              device=None, ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """A (data, feature) mesh over the world's ranks (or the world ranks
    `ranks`, in mesh order), with this rank's block on `device` (None
    means cuda).  Call it on every rank of the world: it makes the
    subgroups, which is collective.  A rank outside `ranks` gets None.

    Defaults to every rank on the data axis.  Raises ValueError when the
    shape does not tile the rank list.  Without a process group the world
    is this one rank."""
    import torch.distributed as dist

    from photon_ml_tpu_torch import resolve_device
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    me = dist.get_rank() if grouped else 0
    ranks = tuple(range(world) if ranks is None else ranks)
    if num_data is None:
        num_data = len(ranks) // num_feature
    if num_data < 1 or num_data * num_feature != len(ranks):
        raise ValueError(
            f"requested mesh shape data={num_data} x feature={num_feature} "
            f"(= {num_data * num_feature} ranks) does not tile the "
            f"{len(ranks)}-rank list; pass num_data/num_feature whose "
            f"product is {len(ranks)}, or num_data=None to infer it as "
            f"len(ranks) // num_feature ('data' is the outermost axis)")
    groups = _make_groups(num_data, num_feature, ranks) if grouped else None
    if me not in ranks:
        return None
    pos = ranks.index(me)
    return Mesh(num_data, num_feature, pos, resolve_device(device),
                backend=dist.get_backend() if grouped else None,
                groups=None if groups is None else groups[pos], ranks=ranks)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         num_feature: int = 1, timeout_s: float = 120.0, *,
                         backend: Optional[str] = None, device=None) -> Mesh:
    """Join a multi-process run (parallel/multihost.py: idempotent, a
    mismatched re-init raises, a timeout names the coordinator and the
    process id) and return the mesh over every rank, "data" outermost."""
    from photon_ml_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address, num_processes, process_id,
                         timeout_s=timeout_s, backend=backend, device=device)
    return make_mesh(num_feature=num_feature, device=device)


# -- placement: a rank's block of a host or device array ---------------------

def _pad_rows(a, rem: int, fill):
    if rem == 0:
        return a
    if isinstance(a, np.ndarray):
        out = np.empty((a.shape[0] + rem,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        out[a.shape[0]:] = fill
        return out
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_full((rem,) + tuple(a.shape[1:]), fill)])
    from photon_ml_tpu_torch.ops import features as fops
    return fops.pad_rows(a, rem)


def _rows(a, lo: int, hi: int):
    """Rows [lo, hi) of an array, a scipy matrix or a feature matrix (hi
    clipped to its length)."""
    from photon_ml_tpu_torch.ops.features import KroneckerDesign, PaddedSparse
    n = a.shape[0]
    lo, hi = min(lo, n), min(hi, n)
    if isinstance(a, PaddedSparse):
        if a.has_csc:
            a = a.without_csc()
        return PaddedSparse(a.indices[lo:hi], a.values[lo:hi], a.num_cols)
    if isinstance(a, KroneckerDesign):
        return KroneckerDesign(a.x[lo:hi], a.factors[lo:hi])
    return a[lo:hi]


def data_sharding(mesh: Mesh, a, fill=0.0):
    """This rank's row block of `a`, padded with `fill` rows so every rank
    holds n_pad / D rows (feature matrices pad with zero rows)."""
    lo, hi, _ = mesh.block(a.shape[0])
    block = _rows(a, lo, hi)
    return _pad_rows(block, (hi - lo) - block.shape[0], fill)


def feature_sharding(mesh: Mesh, a):
    """This rank's block of an [F, ...] array: entry j."""
    return a[mesh.feature_index]


def concat_rows_safe(mesh: Optional[Mesh], arrays, axis: int = 0):
    """Concatenation of row blocks (the random effect's buckets).  The JAX
    package routes feature-wide meshes around a GSPMD miscompile here; the
    port's blocks are plain tensors, so this is an exact `torch.cat`.  A
    single block is copied too: a part may alias a live model's table,
    and torch tensors are mutable."""
    return torch.cat(list(arrays), dim=axis)


def pad_and_shard_rows(mesh: Mesh, *arrays, residency_key=None, dtype=None,
                       residency=None):
    """Stage this rank's padded row block of each array through the mesh
    residency layer (`residency`, default the process's).  Returns
    (original_n, [blocks...]); callers assemble or slice results back to
    original_n.  With `residency_key` the first array (the design matrix:
    a fixed effect's update and score share its one staged copy) is
    memoized per key as field "rows"; the rest stage warm every call."""
    from photon_ml_tpu_torch.ops.features import is_sparse
    from photon_ml_tpu_torch.parallel.mesh_residency import default_residency
    if any(is_sparse(a) for a in arrays):
        raise ValueError(
            "a sparse COO/CSR tensor does not shard over the mesh's data axis, "
            "as the JAX package's BCOO does not (its leaves are [nnz] and "
            "[nnz, 2]: device_put under the data sharding raises at "
            "photon_ml_tpu/parallel/fixed_effect.py:184); convert it first with "
            "ops.features.as_feature_matrix, whose PaddedSparse shards by rows")
    res = residency if residency is not None else default_residency()
    n = arrays[0].shape[0]
    out = []
    for i, a in enumerate(arrays):
        if residency_key is not None and i == 0:
            out.append(res.stage_static(residency_key, "rows", mesh, a, 0.0,
                                        dtype=dtype))
        else:
            out.append(res.stage_update(mesh, a, 0.0, dtype=dtype,
                                        key=residency_key or "pad_and_shard",
                                        field=f"rows{i}"))
    return n, out
