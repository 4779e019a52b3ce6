"""Hand-written Hopper kernels and their plain PyTorch versions.

`fused_value_and_gradient` replaces the JAX package's one TPU kernel,
photon_ml_tpu/ops/pallas_kernels.py::fused_value_and_gradient: one pass over
a dense X [n, d] gives (sum_i w_i l(z_i, y_i), X^T (w * l'(z, y))) with
z = X c (+ o).  It also takes a row mask (a select, as the JAX package's
aggregators: a masked row adds nothing, even a non-finite loss) and the
normalization shift s (z gains -(c . s), the gradient becomes
X^T (w l') - s * sum(w l')), so streamed chunks and standardized fits run
the kernel too.  On a CUDA tensor the wrapper launches the CUDA kernel
(csrc/fused_value_and_gradient.cu, built at first use by ops/_build.py) or
raises; on a CPU tensor it runs the plain version.  Importing this module
builds nothing.  X is stored in float32 or bfloat16, as the TPU kernel
takes it (it upcasts each tile, x_ref[:].astype(jnp.float32)); every other
operand and every sum is float32.  The plain version computes in the
promoted dtype of X and the coefficients, so a bf16 X is widened exactly,
never the coefficients rounded.

`plan_fused` chooses the kernel's tiles, ring stages and grid; it is pure
arithmetic, so the CPU tests replay it, and the kernel refuses a plan whose
shared-memory layout it does not reproduce.

`fused_value_and_gradient_lanes` is the port's own kernel for the candidate
lanes of a hyperparameter sweep (csrc/fused_value_and_gradient_lanes.cu):
one pass over X gives K candidates' values, gradients and sum(w l') at
once, the pass that jax.vmap of the solve makes of XLA's value_and_gradient
in photon_ml_tpu/hyperparameter/vectorized.py::_fe_sweep_update.
`plan_lanes` chooses its tile and grid, as `plan_fused` does; X is
float32 or bfloat16 there too (a bf16 X enters the tensor-core products
as it is: it is exact in TF32, so the f32 X's hi/lo split is dropped),
every other operand float32.  With a lane
mask (an int32 word per row, bit k set where lane k keeps the row) the
lanes are K weightings of one pass, weights w * bit_k: the bootstrap's
replicas (photon_ml_tpu/diagnostics/bootstrap.py, jax.vmap of the solve
over weight rows).

`LAUNCHES` and `LANES_LAUNCHES` count the wrappers' kernel launches, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss

LAUNCHES = 0
# the fused kernel's launches on a bf16 X (counted in LAUNCHES too)
BF16_LAUNCHES = 0
LANES_LAUNCHES = 0
# the lanes kernel's launches on a bf16 X (counted in LANES_LAUNCHES too)
LANES_BF16_LAUNCHES = 0

# X's storage types the fused and lanes kernels take, and their element bytes
X_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# Must match the CUDA source: 256 consumer threads plus one producer warp,
# one block per SM, at most 227 KB less 1 KB of dynamic shared memory.
CONSUMERS = 256
BLOCKS_PER_SM = 1
MAX_SMEM = 232_448 - 1024
# gradient registers per consumer thread the source instantiates
ACC_SIZES = (1, 2, 8, 32)
D_MAX = CONSUMERS * ACC_SIZES[-1]
_TILE_BYTES = 48 * 1024   # X bytes per stage
_RING_BYTES = 96 * 1024   # X bytes the ring holds
_MAX_STAGES = 8
_MAX_TILE_ROWS = 1024


def _round4(v: int) -> int:
    return (v + 3) & ~3


@dataclass(frozen=True)
class SmemLayout:
    """Offsets in floats into the kernel's dynamic shared memory (as
    smem_layout() in the CUDA source): `stages` stages of `stage` floats,
    each [X tile (stage_x: rows * d elements of `xbytes` bytes, and
    16 - xbytes bytes of room for the alignment phase) | y | w | o | m
    (stage_v each)], then c, two buffers of s, the reduction area and the
    mbarriers at `bars`; `bytes` in all."""
    stage_x: int
    stage_v: int
    stage: int
    c: int
    s: int
    red: int
    bars: int
    bytes: int


def smem_layout(d: int, rows: int, stages: int, xbytes: int = 4) -> SmemLayout:
    stage_x = _round4((xbytes * rows * d + 19 - xbytes) // 4)
    stage_v = _round4(rows + 3)
    stage = stage_x + 4 * stage_v
    c = stages * stage
    s = c + _round4(d)
    red = s + 2 * _round4(rows)
    bars = red + 3 * CONSUMERS
    return SmemLayout(stage_x, stage_v, stage, c, s, red, bars,
                      bars * 4 + 2 * stages * 8)


@dataclass(frozen=True)
class FusedPlan:
    """One launch of the fused kernel: `grid` blocks, block b taking tiles
    b, b + grid, ... of rows_per_tile rows each, streamed through `stages`
    ring stages."""
    rows_per_tile: int
    stages: int
    grid: int
    acc_per_thread: int
    layout: SmemLayout


@functools.lru_cache(maxsize=64)
def plan_fused(n: int, d: int, sm_count: int, xbytes: int = 4) -> FusedPlan:
    """Tiles of ~48 KB of X (X's elements `xbytes` bytes each; a multiple
    of 16 / xbytes rows where a tile holds that many or more, so tiles of
    an aligned X stay 16-byte aligned), enough stages to hold ~96 KB (2 to
    8, as many as fit), one block per SM, and the smallest gradient
    register count that covers d columns with 256 threads.  (Measured on
    an H100 with scripts/fvg_sweep.py: smaller tiles leave the consumer
    threads behind the copies; deeper rings gain nothing.)"""
    if not 1 <= d <= D_MAX:
        raise ValueError(f"the fused kernel takes 1 <= d <= {D_MAX} "
                         f"(gradient registers per thread); got d={d}")
    if n < 0 or sm_count < 1 or xbytes not in (2, 4):
        raise ValueError(f"bad plan request n={n}, sm_count={sm_count}, xbytes={xbytes}")
    unit = 16 // xbytes
    rows = max(1, _TILE_BYTES // (xbytes * d))
    if rows >= unit:
        rows = (rows + unit // 2) // unit * unit
    rows = min(rows, _MAX_TILE_ROWS)
    acc = next(a for a in ACC_SIZES if a * CONSUMERS >= d)
    fixed = smem_layout(d, rows, 0, xbytes).bytes
    per_stage = smem_layout(d, rows, 1, xbytes).bytes - fixed
    stages = min(_MAX_STAGES, max(2, _RING_BYTES // (xbytes * rows * d)),
                 (MAX_SMEM - fixed) // per_stage)
    grid = max(1, min(sm_count * BLOCKS_PER_SM, -(-n // rows)))
    return FusedPlan(rows, stages, grid, acc, smem_layout(d, rows, stages, xbytes))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream) -> (partial rows [>= grid * (d + 2)], ticket).  The
# kernel leaves its ticket at 0, so one zeroed ticket serves every call on
# its stream; calls on one stream run in order, so they share the scratch.
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int):
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < floats:
        ws = (torch.empty(floats, dtype=torch.float32, device=device),
              torch.zeros(1, dtype=torch.int32, device=device))
        _WORKSPACES[key] = ws
    return ws


def fused_value_and_gradient_plain(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    shifts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in the promoted dtype of X
    and the coefficients (a bf16 X is widened exactly, as the TPU kernel's
    astype(float32) widens it): two matrix-vector products around the
    pointwise loss.  `mask` selects rows (where, not multiply); `shifts` s
    adds -(c . s) to every margin and takes s * sum(w l') off the
    gradient."""
    x = x.to(torch.promote_types(x.dtype, coefficients.dtype))
    z = torch.mv(x, coefficients)
    if shifts is not None:
        z = z - torch.dot(coefficients, shifts)
    if offsets is not None:
        z = z + offsets
    l, dl = loss.loss_and_dz(z, labels)
    if weights is not None:
        l = l * weights
        dl = dl * weights
    if mask is not None:
        keep = mask != 0
        l = torch.where(keep, l, torch.zeros_like(l))
        dl = torch.where(keep, dl, torch.zeros_like(dl))
    grad = torch.mv(x.T, dl)
    if shifts is not None:
        grad = grad - shifts * dl.sum()
    return l.sum(), grad


def _check_operand(name: str, t: torch.Tensor, shape, device,
                   dtype=torch.float32) -> None:
    """`dtype`: the dtype the kernel takes for this operand, or a tuple of
    them."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(dt).split(".")[-1] for dt in dtypes)
        raise TypeError(f"the CUDA kernel takes {name} in {names} only; "
                        f"{name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_value_and_gradient(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    shifts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_i w_i l(z_i, y_i), gradient) in one pass over X, over the rows
    whose `mask` is nonzero, with the margin shift -(c . s) of `shifts`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel:
    X float32 or bfloat16, every other operand float32, all contiguous and
    on X's device, d <= D_MAX; anything else raises (nothing is copied or
    widened).  The shift's scalar is computed on the device and read by
    the kernel (no read-back)."""
    if x.device.type == "cpu":
        return fused_value_and_gradient_plain(loss, x, labels, coefficients,
                                              weights, offsets, mask, shifts)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    n, d = x.shape
    _check_operand("X", x, (n, d), x.device, tuple(X_BYTES))
    xbytes = X_BYTES[x.dtype]
    plan = plan_fused(n, d, _sm_count(x.device.index), xbytes)
    _check_operand("labels", labels, (n,), x.device)
    _check_operand("coefficients", coefficients, (d,), x.device)
    if weights is not None:
        _check_operand("weights", weights, (n,), x.device)
    if offsets is not None:
        _check_operand("offsets", offsets, (n,), x.device)
    if mask is not None:
        _check_operand("mask", mask, (n,), x.device)
    if shifts is not None:
        _check_operand("shifts", shifts, (d,), x.device)

    from photon_ml_tpu_torch.ops import _build
    lib = _build.load_library("fused_value_and_gradient")
    out = torch.empty((d + 2,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        # -(c . s), one device scalar every margin adds
        shift = None if shifts is None else -torch.dot(coefficients, shifts).reshape(1)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial, ticket = _workspace(x.device, stream, plan.grid * (d + 2))
        err = lib.pmt_fused_value_and_gradient(
            loss.kernel_id, xbytes, x.data_ptr(), labels.data_ptr(), ptr(weights),
            ptr(offsets), ptr(mask), ptr(shift), coefficients.data_ptr(),
            partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, d,
            plan.rows_per_tile, plan.stages, plan.grid, plan.acc_per_thread,
            plan.layout.bytes, stream)
    if err != 0:
        raise RuntimeError("fused_value_and_gradient launch failed: "
                           f"{lib.pmt_error_string(err).decode()} ({err})")
    global LAUNCHES, BF16_LAUNCHES
    LAUNCHES += 1
    BF16_LAUNCHES += xbytes == 2
    grad = out[1:d + 1]
    if shifts is not None:
        grad = grad - shifts * out[d + 1]
    return out[0], grad


# --- the candidate-lanes kernel ----------------------------------------------

# Must match csrc/fused_value_and_gradient_lanes.cu: 512 consumer threads (16
# warps) plus one producer warp, at most 16 lanes in n-tiles of 8, the
# gradient slots per warp the source instantiates for 1 and 2 n-tiles
LANES_CONSUMERS = 512
LANES_WARPS = LANES_CONSUMERS // 32
LANES_MAX = 16
LANES_SLOT_SIZES = {1: (1, 2, 4, 8), 2: (1, 2, 4)}
_LANES_TILE_BYTES = 80 * 1024   # X, y, w, m and O bytes per stage
_LANES_RING_BYTES = 160 * 1024
_LANES_MAX_STAGES = 4
# tile rows: up to 16 m-tiles of 16 rows a power of two, beyond that a
# multiple of 16 m-tiles (every warp then takes whole m-tiles)
LANES_ROWS = (8, 16, 32, 64, 128) + tuple(range(256, 1025, 256))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lane_tiles(lanes: int) -> int:
    """n-tiles of 8 lanes the kernel runs for `lanes` lanes: 1 or 2."""
    return 2 if lanes > 8 else 1


def margin_tiles(rows: int) -> int:
    """The margins' m-tiles of 16 rows in a tile of `rows` rows."""
    return _cdiv(rows, 16)


def margin_split(rows: int) -> int:
    """Warps that share one margin m-tile, each a slice of the columns."""
    mt = margin_tiles(rows)
    return LANES_WARPS // mt if mt < LANES_WARPS else 1


def grad_slots(d: int, rows: int) -> int:
    """The most m-tiles of 16 columns one warp's run of gradient units
    (m-tile, chunk of 8 rows) touches: warp w takes units [w U / 16,
    (w + 1) U / 16) of U = ceil(d / 16) ceil(rows / 8), m-tile by m-tile."""
    q = _cdiv(rows, 8)
    units = _cdiv(d, 16) * q
    most = 0
    for w in range(LANES_WARPS):
        lo, hi = w * units // LANES_WARPS, (w + 1) * units // LANES_WARPS
        if hi > lo:
            most = max(most, (hi - 1) // q - lo // q + 1)
    return most


@dataclass(frozen=True)
class LanesLayout:
    """Offsets in floats into the lanes kernel's dynamic shared memory (as
    smem_layout() in its CUDA source): `stages` stages of `stage` floats,
    each [X tile (stage_x: rows * d elements of `xbytes` bytes and 16 -
    xbytes bytes of room for the alignment phase) | y | w | m | O's K runs
    | the lane mask's words when the launch has them (stage_v each)]; the
    warps' gradient sums reuse the ring after the last tile, and C's
    fragments start at `cf`, past whichever is larger; the partial margins
    at `zp`, s at `sf`, the value/sum(w l') reduction at `vs`, the
    stages' full and empty mbarriers at `bars`; `bytes` in all."""
    stage_x: int
    stage_v: int
    stage: int
    cf: int
    zp: int
    sf: int
    vs: int
    bars: int
    bytes: int


def lanes_smem_layout(d: int, lanes: int, rows: int, stages: int,
                      masked: bool = False, xbytes: int = 4) -> LanesLayout:
    nt = lane_tiles(lanes)
    kp = 8 * nt
    stage_x = _round4((xbytes * rows * d + 19 - xbytes) // 4)
    stage_v = _round4(rows + 3)
    stage = stage_x + (3 + lanes + int(masked)) * stage_v
    gred = LANES_WARPS * grad_slots(d, rows) * nt * 128
    cf = max(stages * stage, gred)
    zp = cf + _cdiv(d, 8) * 8 * kp
    sf = zp + margin_split(rows) * margin_tiles(rows) * 16 * (8 * nt + 8 * (nt - 1))
    vs = sf + _cdiv(rows, 8) * 8 * kp * 2
    bars = vs + 2 * LANES_CONSUMERS
    return LanesLayout(stage_x, stage_v, stage, cf, zp, sf, vs, bars,
                       bars * 4 + 2 * stages * 8)


@dataclass(frozen=True)
class LanesPlan:
    """One launch of the lanes kernel: `grid` blocks (`blocks_per_sm` per
    SM), block b taking tiles b, b + grid, ... of rows_per_tile rows through
    `stages` ring stages; `slots` gradient m-tiles per warp (the
    instantiated size)."""
    rows_per_tile: int
    stages: int
    grid: int
    blocks_per_sm: int
    slots: int
    layout: LanesLayout


def _lanes_fit(d: int, lanes: int, rows: int, stages: Optional[int] = None,
               masked: bool = False, xbytes: int = 4) -> int:
    """Ring stages for tiles of `rows` rows (the requested count, else as
    many as ~160 KB of tiles takes, 2 to 4) that fit in shared memory with
    the gradient's slots instantiated; 0 when none does."""
    if grad_slots(d, rows) > LANES_SLOT_SIZES[lane_tiles(lanes)][-1]:
        return 0
    layout = lambda s: lanes_smem_layout(d, lanes, rows, s, masked, xbytes)
    if stages is None:
        stage_bytes = 4 * layout(1).stage
        stages = min(_LANES_MAX_STAGES, max(2, _LANES_RING_BYTES // stage_bytes))
        while stages > 2 and layout(stages).bytes > MAX_SMEM:
            stages -= 1
    return stages if layout(stages).bytes <= MAX_SMEM else 0


@functools.lru_cache(maxsize=None)
def _lanes_tile(d: int, lanes: int, masked: bool = False,
                xbytes: int = 4) -> Optional[Tuple[int, int]]:
    """(rows, stages): the most rows whose stage holds ~80 KB or less (at
    least 8) that fit with two or more stages; None when no tile fits."""
    per_row = xbytes * d + 4 * (3 + lanes + int(masked))
    for rows in reversed(LANES_ROWS):
        if rows * per_row > _LANES_TILE_BYTES and rows > LANES_ROWS[0]:
            continue
        stages = _lanes_fit(d, lanes, rows, masked=masked, xbytes=xbytes)
        if stages >= 2:
            return rows, stages
    return None


def max_lanes(d: int, masked: bool = False, xbytes: int = 4) -> int:
    """The most lanes one launch takes at width d, with a lane mask when
    `masked`, X's elements `xbytes` bytes (0: none, and a dense fixed
    effect that wide runs the single kernel once per lane)."""
    return next((lanes for lanes in (LANES_MAX, 8, 4)
                 if _lanes_tile(d, lanes, masked, xbytes)), 0)


@functools.lru_cache(maxsize=64)
def plan_lanes(n: int, d: int, lanes: int, sm_count: int, rows: Optional[int] = None,
               stages: Optional[int] = None, blocks_per_sm: int = 1,
               masked: bool = False, xbytes: int = 4) -> LanesPlan:
    """Tiles of ~80 KB of X, y, w, m and O (and the lane mask's words when
    `masked`; the most rows of LANES_ROWS, at least 8), a ring of two to
    four stages (~160 KB), one block per SM, the fewest gradient slots that
    cover a warp's run of units.  `rows`, `stages` and `blocks_per_sm`
    override the choice (scripts/lanes_sweep.py times such variants).
    X's elements are `xbytes` bytes: 4 (float32) or 2 (bfloat16)."""
    if xbytes not in (2, 4):
        raise ValueError(f"X's elements are 2 or 4 bytes; got xbytes={xbytes}")
    if not 1 <= lanes <= LANES_MAX:
        raise ValueError(f"the lanes kernel takes 1 <= K <= {LANES_MAX} "
                         f"lanes; got K={lanes}")
    if lanes > max_lanes(d, masked, xbytes):
        raise ValueError(
            f"the lanes kernel takes at most {max_lanes(d, masked, xbytes)} lanes at d={d} "
            "(C's fragments and two stages in shared memory, at most "
            f"{LANES_SLOT_SIZES[1][-1]} gradient slots per warp); got "
            f"K={lanes}: split the lanes into groups")
    if n < 0 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"bad plan request n={n}, sm_count={sm_count}, "
                         f"blocks_per_sm={blocks_per_sm}")
    if rows is None:
        rows, auto = _lanes_tile(d, lanes, masked, xbytes)
        stages = auto if stages is None else stages
    if rows not in LANES_ROWS:
        raise ValueError(f"tile rows must be one of {LANES_ROWS}; got {rows}")
    stages = _lanes_fit(d, lanes, rows, stages, masked, xbytes)
    if stages < 2:
        raise ValueError(f"no ring of {rows}-row tiles fits at d={d}, K={lanes}")
    slots = next(s for s in LANES_SLOT_SIZES[lane_tiles(lanes)] if s >= grad_slots(d, rows))
    grid = max(1, min(sm_count * blocks_per_sm, -(-n // rows)))
    return LanesPlan(rows, stages, grid, blocks_per_sm, slots,
                     lanes_smem_layout(d, lanes, rows, stages, masked, xbytes))


def fused_value_and_gradient_lanes_plain(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    lane_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lanes kernel's function in plain PyTorch, in the promoted dtype
    of X and C (a bf16 X is widened exactly, as JAX's X @ C promotes):
    for coefficients C [K, d], offsets O [K, n] and per-lane shifts b [K],
    Z = X C^T + O^T + b, then ([K] values, [K, d] gradients X^T (w l'),
    [K] sums of w l'), the mask a select; bit k of `lane_mask` (int32 [n])
    a 0/1 factor on lane k's weights."""
    x = x.to(torch.promote_types(x.dtype, coefficients.dtype))
    z = x @ coefficients.T
    if shift is not None:
        z = z + shift
    if offsets is not None:
        z = z + offsets.T
    l, dl = loss.loss_and_dz(z, labels[:, None])
    w = None if weights is None else weights[:, None]
    if lane_mask is not None:
        if coefficients.shape[0] > 32:
            raise ValueError(f"a lane mask word holds 32 lanes; got K={coefficients.shape[0]}")
        lanes = torch.arange(coefficients.shape[0], device=x.device, dtype=lane_mask.dtype)
        keep = ((lane_mask[:, None] >> lanes) & 1).to(z.dtype)
        w = keep if w is None else w * keep
    if w is not None:
        l = l * w
        dl = dl * w
    if mask is not None:
        keep = (mask != 0)[:, None]
        l = torch.where(keep, l, torch.zeros_like(l))
        dl = torch.where(keep, dl, torch.zeros_like(dl))
    return l.sum(0), (x.T @ dl).T, dl.sum(0)


def fused_value_and_gradient_lanes(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    lane_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """([K] values, [K, d] gradients, [K] sums of w l') of K coefficient
    vectors C [K, d] in one pass over X, with offsets O [K, n] and a margin
    shift b [K] per lane, over the rows whose `mask` is nonzero; with
    `lane_mask` (int32 [n]) lane k weighs row i by w_i * bit k of
    lane_mask[i].

    CPU tensors run the plain version.  CUDA tensors launch the kernel:
    X float32 or bfloat16, every other operand float32 (the lane mask
    int32), contiguous and on X's device, K within `max_lanes(d, masked,
    xbytes)`; anything else raises."""
    if x.device.type == "cpu":
        return fused_value_and_gradient_lanes_plain(
            loss, x, labels, coefficients, weights, offsets, mask, shift, lane_mask)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2 or coefficients.ndim != 2:
        raise ValueError(f"X and C must be 2-D, got shapes {tuple(x.shape)} and "
                         f"{tuple(coefficients.shape)}")
    n, d = x.shape
    lanes = coefficients.shape[0]
    if lane_mask is not None:
        _check_operand("lane_mask", lane_mask, (n,), x.device, torch.int32)
        if n == 0:
            lane_mask = None  # no row to weigh, and no data pointer to pass
    _check_operand("X", x, (n, d), x.device, tuple(X_BYTES))
    xbytes = X_BYTES[x.dtype]
    plan = plan_lanes(n, d, lanes, _sm_count(x.device.index),
                      masked=lane_mask is not None, xbytes=xbytes)
    _check_operand("labels", labels, (n,), x.device)
    _check_operand("coefficients", coefficients, (lanes, d), x.device)
    if weights is not None:
        _check_operand("weights", weights, (n,), x.device)
    if offsets is not None:
        _check_operand("offsets", offsets, (lanes, n), x.device)
    if mask is not None:
        _check_operand("mask", mask, (n,), x.device)
    if shift is not None:
        _check_operand("shift", shift, (lanes,), x.device)

    from photon_ml_tpu_torch.ops import _build
    lib = (_build.load_library("fused_value_and_gradient_lanes") if xbytes == 4
           else _build.load_library("fused_value_and_gradient_lanes_bf16"))
    out = torch.empty((lanes, d + 2), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial, ticket = _workspace(x.device, stream, plan.grid * lanes * (d + 2))
        err = lib.pmt_fused_value_and_gradient_lanes(
            loss.kernel_id, xbytes, x.data_ptr(), labels.data_ptr(), ptr(weights),
            ptr(offsets), ptr(mask), ptr(shift), ptr(lane_mask), coefficients.data_ptr(),
            partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, d, lanes,
            plan.rows_per_tile, plan.stages, plan.grid, plan.slots, plan.layout.bytes,
            stream)
    if err != 0:
        raise RuntimeError("fused_value_and_gradient_lanes launch failed: "
                           f"{lib.pmt_lanes_error_string(err).decode()} ({err})")
    global LANES_LAUNCHES, LANES_BF16_LAUNCHES
    LANES_LAUNCHES += 1
    LANES_BF16_LAUNCHES += xbytes == 2
    return out[:, 0], out[:, 1:d + 1], out[:, d + 1]
