"""Hand-written Hopper kernels for the sparse feature products, and their
plain PyTorch versions.

A `PaddedSparse` (ops/features.py) holds ELL rows and a column-sorted view
of the same nonzeros.  Two kernels (csrc/ell_sparse.cu, built at first use
by ops/_build.py) compute its products on the card:

- A, `ell_margin_loss`: z = X c (+ o) row by row; in loss mode also
  u = w * l'(z, y) and the value sum_i w_i l(z_i, y_i).  `ell_margins`
  is its margins-only mode (matvec).  Where c fits in shared memory,
  tiles of whole rows stream through a ring of bulk copies into shared
  memory beside it, one row per thread; elsewhere P lanes per row read
  device memory and gather c from L2.
- B, `csc_column_sum`: X^T u (power 1) or (X*X)^T u (power 2), summed per
  column over the column-sorted stream: tiles of TILE nonzeros, a run of
  RUN per thread, a segmented reduction by column inside the tile, and
  the columns that span tiles finished by the last block.  Its columns
  come from a tile map (`tile_map`) made once per column view: a
  `PaddedSparse` carries it, and a direct call without one gets it from a
  cache keyed on the `end` tensor.

A value+gradient pass is A then B: two launches.  They replace what the
JAX package computes in XLA, outside Pallas: photon_ml_tpu/ops/
features.py:237-350 (`matvec`, `rmatvec`, `sq_rmatvec` on a PaddedSparse).

The values come in float32 or bfloat16 storage (the JAX package's bf16
feature storage); every other float operand, every product and every sum
is float32 on the card.  The plain versions promote as the JAX package's
products do (jnp.promote_types at photon_ml_tpu/ops/features.py:273, :322,
:343): a bf16 value times a float32 (float64 on the CPU) vector is the
wider type, and B's power 2 squares the values in their storage type
first, as the JAX package's vals * vals does.

On a CUDA tensor each wrapper checks its operands (dtype, device, shape,
contiguity; a bad operand raises, nothing is copied or widened) and
launches its kernel, or raises; on a CPU tensor it runs the plain
version.  Importing
this module builds nothing.  `plan_margins`, `plan_columns` and
`tile_map` are pure arithmetic, so the CPU tests replay them.

`LAUNCHES` counts the wrappers' launches by kind: "margin_loss" and
"margins" (kernel A), "column_sum" and "sq_column_sum" (kernel B);
`BF16_LAUNCHES` the launches among them on bf16 values, by the same kinds.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss

LAUNCHES: Dict[str, int] = {"margin_loss": 0, "margins": 0,
                            "column_sum": 0, "sq_column_sum": 0}
BF16_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
# the values' storage types the kernels take, and their element bytes
VALUE_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# Must match the CUDA source (kThreads, kUnroll, kMaxSmem, kRun, kChunk,
# kFinishRun; A's entry checks the shared-memory size through
# the plan, B's entry TILE through `tiles` and its shared-memory size).
THREADS = 256
WARPS = THREADS // 32
UNROLL = 8            # kernel A, staged rows: gathers of c in flight per thread
MAX_SMEM = 232_448 - 1024  # dynamic shared memory a block may ask for
BLOCKS_PER_SM = 8     # kernel A, lanes per row: at most this many blocks per SM
RUN = 8               # kernel B: consecutive stream elements per thread
TILE = THREADS * RUN  # kernel B: column-sorted stream elements per block
CHUNK = 1024          # kernel B: column ends staged in shared memory at a time
FINISH_RUN = 8        # kernel B's last block: tiles per thread per round
# kernel A, staged rows: ~48 KB tiles, up to 4 rows per thread, a ring of
# ~96 KB (2 to 8 stages), and at least MIN_ROWS rows per tile
_A_TILE_BYTES = 48 * 1024
_A_RING_BYTES = 96 * 1024
_A_MAX_STAGES = 8
_A_ROWS_PER_THREAD = 4
MIN_ROWS = 128
_INT32_MAX = 2 ** 31 - 1


def _round4(v: int) -> int:
    return (v + 3) & ~3


def margin_smem_bytes(k: int, rows: int, stages: int, cols: int,
                      vbytes: int = 4) -> int:
    """Kernel A's dynamic shared memory (staged rows), as margin_layout()
    in the CUDA source: c [cols], then `stages` stages of [indices (rows *
    k words) | values (rows * k elements of `vbytes` bytes)], every span
    with 16 - its element size bytes of room for its alignment phase,
    then 2 * stages + 1 mbarriers."""
    vspan = _round4((vbytes * rows * k + 19 - vbytes) // 4)
    return (4 * (_round4(cols + 3) + stages * (_round4(rows * k + 3) + vspan))
            + 8 * (2 * stages + 1))


@dataclass(frozen=True)
class MarginPlan:
    """One launch of kernel A.  stages > 0, staged rows (lanes 1): `grid`
    blocks (one per SM), block b taking tiles b, b + grid, ... of `rows`
    rows, one row per consumer thread at a time, through `stages` ring
    stages, with c in shared memory and `smem_bytes` of dynamic shared
    memory in all.  stages 0, lanes per row: P = `lanes` lanes per row,
    `rows` = THREADS / P rows per block per round, c gathered from L2, no
    dynamic shared memory."""
    lanes: int
    rows: int
    stages: int
    grid: int
    smem_bytes: int

    @property
    def c_in_smem(self) -> bool:
        return self.stages > 0


def max_smem_cols(k: int, rows: int, vbytes: int = 4) -> int:
    """The widest c that kernel A stages in shared memory beside 2 stages
    of `rows` rows (0 when none fits)."""
    words = (MAX_SMEM - margin_smem_bytes(k, rows, 2, 1, vbytes)) // 4 + 4  # + c's own room
    return max(0, words // 4 * 4 - 3)


def _stages_that_fit(k: int, rows: int, cols: int, vbytes: int) -> int:
    fixed = margin_smem_bytes(k, rows, 0, cols, vbytes)
    return (MAX_SMEM - fixed) // (margin_smem_bytes(k, rows, 1, cols, vbytes) - fixed)


def _most_rows(k: int, vbytes: int) -> int:
    """The most rows whose 2 stages fit beside the smallest c (4 words)."""
    rows = (MAX_SMEM - 56) // (2 * (4 + vbytes) * k) + 1
    while rows > 0 and margin_smem_bytes(k, rows, 2, 1, vbytes) > MAX_SMEM:
        rows -= 1
    return rows


@functools.lru_cache(maxsize=64)
def plan_margins(n: int, k: int, d: int, sm_count: int, vbytes: int = 4) -> MarginPlan:
    """Staged rows where c fits in shared memory: tiles of THREADS rows,
    or up to _A_ROWS_PER_THREAD times that while a tile stays within
    ~48 KB, fewer when 2 stages of THREADS rows do not fit (k > 56), never
    fewer than MIN_ROWS (k <= 112); c must fit beside 2 stages of them,
    and each block must gather at least d times (n * k >= grid * d), since
    copying c costs a block 4 d bytes.  Everywhere else lanes per row:
    P = min(32, the next power of two >= k) lanes per row, at most
    BLOCKS_PER_SM blocks of THREADS per SM.  A slot is 4 + `vbytes` bytes
    (an int32 index and a float32 or bf16 value)."""
    if n < 0 or k < 1 or d < 1 or sm_count < 1 or vbytes not in (2, 4):
        raise ValueError(f"bad plan request n={n}, k={k}, d={d}, sm_count={sm_count}, "
                         f"vbytes={vbytes}")
    slot = 4 + vbytes
    per_thread = max(1, min(_A_ROWS_PER_THREAD, _A_TILE_BYTES // (slot * k * THREADS)))
    rows = min(THREADS * per_thread, _most_rows(k, vbytes))
    grid = max(1, min(sm_count, -(-n // rows)))
    if rows >= MIN_ROWS and d <= max_smem_cols(k, rows, vbytes) and n * k >= grid * d:
        stages = min(_A_MAX_STAGES, max(2, _A_RING_BYTES // (slot * rows * k)),
                     _stages_that_fit(k, rows, d, vbytes))
        return MarginPlan(1, rows, stages, grid,
                          margin_smem_bytes(k, rows, stages, d, vbytes))
    lanes = 1
    while lanes < min(k, 32):
        lanes *= 2
    rows = THREADS // lanes
    return MarginPlan(lanes, rows, 0, max(1, min(sm_count * BLOCKS_PER_SM, -(-n // rows))), 0)


@dataclass(frozen=True)
class ColumnPlan:
    """One launch of kernel B: `tiles` blocks, block t summing stream
    elements [t * tile, (t + 1) * tile), thread i of it the `run`
    elements from t * tile + i * run, with `smem_bytes` of static shared
    memory (the CUDA source's sizeof(ColumnSmem): CHUNK staged column
    ends, each warp's scan total and column, the last-block flag)."""
    tile: int
    tiles: int
    run: int
    smem_bytes: int


def plan_columns(nnz: int) -> ColumnPlan:
    if nnz < 0:
        raise ValueError(f"bad plan request nnz={nnz}")
    return ColumnPlan(TILE, max(1, -(-nnz // TILE)), RUN, 4 * (CHUNK + 2 * WARPS + 1))


def tile_map(end: np.ndarray) -> np.ndarray:
    """Kernel B's tile map of a column view: int32 [tiles + 1], entry t the
    first column whose segment reaches into tile t (the lower bound of
    t * TILE in end[:d]), the last entry d.  Made on the host, once per
    view, so the kernel searches nothing."""
    end = np.asarray(end)
    d = end.shape[0] - 1
    if d < 1 or end[0] != 0 or np.any(np.diff(end) < 0):
        raise ValueError("a column view's end must start at 0, not decrease, "
                         "and have d + 1 >= 2 entries")
    tiles = plan_columns(int(end[-1])).tiles
    out = np.empty(tiles + 1, np.int32)
    out[:tiles] = np.searchsorted(end[:d], np.arange(tiles, dtype=np.int64) * TILE)
    out[tiles] = d
    return out


def tile_map_of(end: torch.Tensor, nnz: int) -> torch.Tensor:
    """`tile_map` of a column view's int64 `end` made by torch ops on its
    own device (no read-back: the caller knows nnz = end[-1])."""
    d = end.shape[0] - 1
    if d < 1:
        raise ValueError("a column view's end must have d + 1 >= 2 entries")
    tiles = plan_columns(nnz).tiles
    starts = torch.arange(tiles, dtype=end.dtype, device=end.device) * TILE
    return torch.cat([torch.searchsorted(end[:d], starts),
                      torch.full((1,), d, dtype=torch.int64, device=end.device)]
                     ).to(torch.int32)


# id(end) -> (weak reference to end, its _version, its tile map on its device)
_TILE_MAPS: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}
_TILE_MAPS_KEPT = 32


def cached_tile_map(end: torch.Tensor) -> torch.Tensor:  # photonlint: flush-point -- one read-back of `end` per tensor, then cached
    """The tile map of `end`, made at the first call for this tensor (and
    again after it is written in place), then cached: for a direct call
    of csc_column_sum without a map."""
    hit = _TILE_MAPS.get(id(end))
    if (hit is not None and hit[0]() is end and hit[1] == end._version
            and hit[2].device == end.device):
        return hit[2]
    tiles = torch.from_numpy(tile_map(end.cpu().numpy())).to(end.device)
    if len(_TILE_MAPS) >= _TILE_MAPS_KEPT:
        _TILE_MAPS.pop(next(iter(_TILE_MAPS)))
    _TILE_MAPS[id(end)] = (weakref.ref(end), end._version, tiles)
    return tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream) -> (float scratch, int scratch, ticket).  Each
# kernel leaves the ticket at 0, and calls on one stream run in order, so
# both kernels share one workspace per stream.
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int, ints: int):
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < ints:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(floats, old[0]), dtype=torch.float32, device=device),
              torch.empty(max(ints, old[1]), dtype=torch.int32, device=device),
              torch.zeros(1, dtype=torch.int32, device=device))
        _WORKSPACES[key] = ws
    return ws


# ------------------------------------------------------------ plain versions

def ell_margins_plain(indices: torch.Tensor, values: torch.Tensor,
                      coefficients: torch.Tensor,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z_i = sum_k values[i, k] c[indices[i, k]] (+ o_i): a gather and a
    row sum, as the JAX package's matvec, in the promoted dtype of the
    values and c (a bf16 value times a float32 c is float32)."""
    z = torch.sum(values * coefficients[indices.long()], dim=-1)
    return z if offsets is None else z + offsets


def ell_margin_loss_plain(
    loss: PointwiseLoss,
    indices: torch.Tensor,
    values: torch.Tensor,
    coefficients: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_i w_i l(z_i, y_i), u = w * l'(z, y)) in the promoted dtype of
    the values and c."""
    z = ell_margins_plain(indices, values, coefficients, offsets)
    l, dl = loss.loss_and_dz(z, labels)
    if weights is not None:
        l = l * weights
        dl = dl * weights
    return torch.sum(l), dl


def csc_column_sum_plain(rows: torch.Tensor, vals: torch.Tensor,
                         end: torch.Tensor, u: torch.Tensor,
                         power: int = 1) -> torch.Tensor:
    """g_j = sum over column j's stream segment of val^power * u[row], by
    index_add_ over the stream (in stream order), in the promoted dtype of
    the values and u; power 2 squares the values in their own dtype first,
    as the JAX package's sq_rmatvec does."""
    v = vals if power == 1 else vals * vals
    acc = torch.promote_types(vals.dtype, u.dtype)
    contrib = (v * u[rows.long()]).to(acc)
    d = end.shape[0] - 1
    cols = torch.repeat_interleave(torch.arange(d, device=end.device),
                                   torch.diff(end).long())
    return torch.zeros(d, dtype=acc, device=end.device).index_add_(0, cols, contrib)


# ----------------------------------------------------------------- wrappers

def _check(name: str, t: torch.Tensor, dtype, shape, device: torch.device) -> None:
    """`dtype`: the dtype the kernels take for this operand, or a tuple of
    them."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(dt) for dt in dtypes)
        raise TypeError(f"the sparse kernels take {names} {name}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.device


def _lib():
    from photon_ml_tpu_torch.ops import _build
    return _build.load_library("ell_sparse")


def _raise_if(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.pmt_ell_error_string(err).decode()} ({err})")


def _launch_a(loss_id: int, indices, values, coefficients, labels, weights,
              offsets) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    dev = _cuda_device(indices)
    if indices.ndim != 2:
        raise ValueError(f"indices must be [n, k], got shape {tuple(indices.shape)}")
    n, k = indices.shape
    if n * k > _INT32_MAX:
        raise ValueError(f"n * k = {n * k} slots exceed the kernels' int32 range")
    if coefficients.ndim != 1 or coefficients.shape[0] < 1:
        raise ValueError("coefficients must be 1-D with at least one element")
    _check("indices", indices, torch.int32, (n, k), dev)
    _check("values", values, tuple(VALUE_BYTES), (n, k), dev)
    vbytes = VALUE_BYTES[values.dtype]
    _check("coefficients", coefficients, torch.float32, coefficients.shape, dev)
    if labels is not None:
        _check("labels", labels, torch.float32, (n,), dev)
    if weights is not None:
        _check("weights", weights, torch.float32, (n,), dev)
    if offsets is not None:
        _check("offsets", offsets, torch.float32, (n,), dev)
    d = coefficients.shape[0]
    plan = plan_margins(n, k, d, _sm_count(dev.index), vbytes)
    lib = _lib()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    value = torch.empty((1,), dtype=torch.float32, device=dev) if loss_id >= 0 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch, _, ticket = _workspace(dev, stream, plan.grid, 0)
        err = lib.pmt_ell_margin_loss(
            loss_id, vbytes, indices.data_ptr(), values.data_ptr(), coefficients.data_ptr(),
            ptr(labels), ptr(weights), ptr(offsets), out.data_ptr(),
            scratch.data_ptr(), ticket.data_ptr(), ptr(value), n, k, d, plan.lanes,
            plan.rows, plan.stages, plan.grid, plan.smem_bytes, stream)
    _raise_if(err, lib, "ell_margin_loss")
    kind = "margin_loss" if loss_id >= 0 else "margins"
    LAUNCHES[kind] += 1
    BF16_LAUNCHES[kind] += vbytes == 2
    return value, out


def ell_margins(indices: torch.Tensor, values: torch.Tensor,
                coefficients: torch.Tensor,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = X c (+ o) -> [n].  CPU tensors run the plain version; CUDA
    tensors launch kernel A in margins mode (float32 or bf16 values, every
    other float operand float32, contiguous, on one device) or raise."""
    if indices.device.type == "cpu":
        return ell_margins_plain(indices, values, coefficients, offsets)
    return _launch_a(-1, indices, values, coefficients, None, None, offsets)[1]


def ell_margin_loss(
    loss: PointwiseLoss,
    indices: torch.Tensor,
    values: torch.Tensor,
    coefficients: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_i w_i l(z_i, y_i), u = w * l'(z, y)) with z = X c (+ o): the
    first half of a value+gradient pass.  CPU tensors run the plain
    version; CUDA tensors launch kernel A in loss mode or raise."""
    if indices.device.type == "cpu":
        return ell_margin_loss_plain(loss, indices, values, coefficients,
                                     labels, weights, offsets)
    value, u = _launch_a(loss.kernel_id, indices, values, coefficients,
                         labels, weights, offsets)
    return value[0], u


def csc_column_sum(rows: torch.Tensor, vals: torch.Tensor, end: torch.Tensor,
                   u: torch.Tensor, power: int = 1,
                   tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g_j = sum_{p in [end_j, end_{j+1})} vals_p^power u[rows_p] -> [d]:
    X^T u (power 1) or (X*X)^T u (power 2) over the column-sorted stream.
    CPU tensors run the plain version; CUDA tensors launch kernel B
    (float32 or bf16 vals, float32 u, int32 rows and end, contiguous, on
    one device,
    rows and vals starting on a 16-byte boundary) or raise.  `tiles` is
    the view's tile map (`tile_map`); without one it comes from
    `cached_tile_map(end)`."""
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, got {power}")
    if rows.device.type == "cpu":
        return csc_column_sum_plain(rows, vals, end, u, power)
    dev = _cuda_device(rows)
    if rows.ndim != 1 or end.ndim != 1 or u.ndim != 1 or end.shape[0] < 2:
        raise ValueError("rows, end and u must be 1-D, end of length d + 1 >= 2")
    nnz, d = rows.shape[0], end.shape[0] - 1
    if nnz > _INT32_MAX:
        raise ValueError(f"nnz = {nnz} exceeds the kernels' int32 range")
    _check("csc_row", rows, torch.int32, (nnz,), dev)
    _check("csc_val", vals, tuple(VALUE_BYTES), (nnz,), dev)
    vbytes = VALUE_BYTES[vals.dtype]
    _check("csc_end", end, torch.int32, (d + 1,), dev)
    _check("u", u, torch.float32, u.shape, dev)
    if nnz and (rows.data_ptr() % 16 or vals.data_ptr() % 16):
        raise ValueError("csc_row and csc_val must start on a 16-byte boundary (kernel B "
                         "loads them 16 bytes at a time); got a view at byte offsets "
                         f"{rows.data_ptr() % 16} and {vals.data_ptr() % 16}")
    plan = plan_columns(nnz)
    if tiles is None:
        tiles = cached_tile_map(end)
    _check("tile map", tiles, torch.int32, (plan.tiles + 1,), dev)
    lib = _lib()
    g = torch.empty((d,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch, ints, ticket = _workspace(dev, stream, 2 * plan.tiles, plan.tiles)
        err = lib.pmt_csc_column_sum(
            power, vbytes, rows.data_ptr(), vals.data_ptr(), end.data_ptr(), tiles.data_ptr(),
            u.data_ptr(), g.data_ptr(), scratch.data_ptr(),
            scratch[plan.tiles:].data_ptr(), ints.data_ptr(), ticket.data_ptr(), nnz, d,
            plan.tiles, plan.smem_bytes, stream)
    _raise_if(err, lib, "csc_column_sum")
    kind = "column_sum" if power == 1 else "sq_column_sum"
    LAUNCHES[kind] += 1
    BF16_LAUNCHES[kind] += vbytes == 2
    return g


# ------------------------------------------------------------ tolerances

def margins_tolerance(indices: torch.Tensor, values: torch.Tensor,
                      coefficients: torch.Tensor,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per row, 2 sqrt(k + 1) eps (sum_k |values c[indices]| + |o|): how far
    two summations of a row's margin in different orders may differ, in
    the dtype the margins are summed in, the promoted dtype of the values
    and c (computed in float64)."""
    eps = torch.finfo(torch.promote_types(values.dtype, coefficients.dtype)).eps
    terms = ell_margins_plain(indices, values.double().abs(),
                              coefficients.double().abs(),
                              None if offsets is None else offsets.double().abs())
    return 2.0 * (indices.shape[1] + 1) ** 0.5 * eps * terms


def column_sum_tolerance(rows: torch.Tensor, vals: torch.Tensor,
                         end: torch.Tensor, u: torch.Tensor,
                         power: int = 1) -> torch.Tensor:
    """Per column, 2 sqrt(count_j) eps sum_p |val_p^power u[row_p]|: how
    far two summations of column j in different orders may differ, in the
    dtype the column is summed in, the promoted dtype of the values and u
    (computed in float64).  At bench config 6 the intercept column is a
    sum of 200,000 terms."""
    eps = torch.finfo(torch.promote_types(vals.dtype, u.dtype)).eps
    terms = csc_column_sum_plain(rows, vals.double().abs(), end, u.double().abs(), power)
    count = torch.diff(end).double()
    return 2.0 * torch.sqrt(count) * eps * terms
