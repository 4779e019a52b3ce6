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
builds nothing.

`plan_fused` chooses the kernel's tiles, ring stages and grid; it is pure
arithmetic, so the CPU tests replay it, and the kernel refuses a plan whose
shared-memory layout it does not reproduce.

`fused_value_and_gradient_lanes` is the port's own kernel for the candidate
lanes of a hyperparameter sweep (csrc/fused_value_and_gradient_lanes.cu):
one pass over X gives K candidates' values, gradients and sum(w l') at
once, the pass that jax.vmap of the solve makes of XLA's value_and_gradient
in photon_ml_tpu/hyperparameter/vectorized.py::_fe_sweep_update.
`plan_lanes` chooses its tile and grid, as `plan_fused` does.

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
LANES_LAUNCHES = 0

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
    each [X tile (stage_x) | y | w | o | m (stage_v each)], then c, two
    buffers of s, the reduction area and the mbarriers at `bars`; `bytes`
    in all."""
    stage_x: int
    stage_v: int
    stage: int
    c: int
    s: int
    red: int
    bars: int
    bytes: int


def smem_layout(d: int, rows: int, stages: int) -> SmemLayout:
    stage_x = _round4(rows * d + 3)
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
def plan_fused(n: int, d: int, sm_count: int) -> FusedPlan:
    """Tiles of ~48 KB of X (a multiple of 4 rows where a tile holds 4 or
    more, so tiles of an aligned X stay 16-byte aligned), enough stages to
    hold ~96 KB (2 to 8, as many as fit), one block per SM, and the
    smallest gradient register count that covers d columns with 256
    threads.  (Measured on an H100 with scripts/fvg_sweep.py: smaller tiles
    leave the consumer threads behind the copies; deeper rings gain
    nothing.)"""
    if not 1 <= d <= D_MAX:
        raise ValueError(f"the fused kernel takes 1 <= d <= {D_MAX} "
                         f"(gradient registers per thread); got d={d}")
    if n < 0 or sm_count < 1:
        raise ValueError(f"bad plan request n={n}, sm_count={sm_count}")
    rows = max(1, _TILE_BYTES // (4 * d))
    if rows >= 4:
        rows = (rows + 2) // 4 * 4
    rows = min(rows, _MAX_TILE_ROWS)
    acc = next(a for a in ACC_SIZES if a * CONSUMERS >= d)
    fixed = smem_layout(d, rows, 0).bytes
    per_stage = smem_layout(d, rows, 1).bytes - fixed
    stages = min(_MAX_STAGES, max(2, _RING_BYTES // (4 * rows * d)),
                 (MAX_SMEM - fixed) // per_stage)
    grid = max(1, min(sm_count * BLOCKS_PER_SM, -(-n // rows)))
    return FusedPlan(rows, stages, grid, acc, smem_layout(d, rows, stages))


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
    """The kernel's function in plain PyTorch, in the inputs' dtype: two
    matrix-vector products around the pointwise loss.  `mask` selects rows
    (where, not multiply); `shifts` s adds -(c . s) to every margin and
    takes s * sum(w l') off the gradient."""
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


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 only; {name} is {t.dtype}")
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
    every operand float32, contiguous and on X's device, d <= D_MAX;
    anything else raises.  The shift's scalar is computed on the device
    and read by the kernel (no read-back)."""
    if x.device.type == "cpu":
        return fused_value_and_gradient_plain(loss, x, labels, coefficients,
                                              weights, offsets, mask, shifts)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    n, d = x.shape
    plan = plan_fused(n, d, _sm_count(x.device.index))
    _check_operand("X", x, (n, d), x.device)
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
            loss.kernel_id, x.data_ptr(), labels.data_ptr(), ptr(weights),
            ptr(offsets), ptr(mask), ptr(shift), coefficients.data_ptr(),
            partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, d,
            plan.rows_per_tile, plan.stages, plan.grid, plan.acc_per_thread,
            plan.layout.bytes, stream)
    if err != 0:
        raise RuntimeError("fused_value_and_gradient launch failed: "
                           f"{lib.pmt_error_string(err).decode()} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    grad = out[1:d + 1]
    if shifts is not None:
        grad = grad - shifts * out[d + 1]
    return out[0], grad


# --- the candidate-lanes kernel ----------------------------------------------

# Must match csrc/fused_value_and_gradient_lanes.cu: 256 threads, a ring of
# three stages, at most 16 lanes in lane groups of 4, 4-lane gradient
# accumulators per thread (lane groups x d <= 256 x the largest size)
LANES_THREADS = 256
LANES_STAGES = 3
LANES_MAX = 16
LANES_ACC_SIZES = (1, 2, 4, 8)
_LANES_TILE_BYTES = 16 * 1024   # X bytes per stage
_SM_SMEM = 233_472              # shared memory of one SM
_LANES_ROW_STEP = 32
_LANES_MAX_ROWS = 512


def lane_groups(lanes: int) -> int:
    """Lane groups of 4 the kernel runs for `lanes` lanes: 1, 2 or 4."""
    return 1 if lanes <= 4 else (2 if lanes <= 8 else 4)


@dataclass(frozen=True)
class LanesLayout:
    """Offsets in floats into the lanes kernel's dynamic shared memory (as
    smem_layout() in its CUDA source): three stages of `stage` floats,
    each [X tile (rows x ld, ld = d | 1) | y | w | m (stage_v each) | O
    (stage_o)], then C^T at `c`, the tile's s at `s`, the reduction area at
    `red`; `bytes` in all."""
    ld: int
    groups: int
    stage_x: int
    stage_v: int
    stage_o: int
    stage: int
    c: int
    s: int
    red: int
    bytes: int


def lanes_smem_layout(d: int, lanes: int, rows: int) -> LanesLayout:
    ld = d | 1
    groups = lane_groups(lanes)
    kp = 4 * groups
    stage_x = _round4(rows * ld)
    stage_v = _round4(rows)
    stage_o = _round4(lanes * rows)
    stage = stage_x + 3 * stage_v + stage_o
    c = LANES_STAGES * stage
    s = c + d * kp
    red = s + rows * kp
    return LanesLayout(ld, groups, stage_x, stage_v, stage_o, stage, c, s, red,
                       (red + 2 * 4 * LANES_THREADS) * 4)


@dataclass(frozen=True)
class LanesPlan:
    """One launch of the lanes kernel: `grid` blocks (`blocks_per_sm` per
    SM), block b taking tiles b, b + grid, ... of rows_per_tile rows."""
    rows_per_tile: int
    grid: int
    blocks_per_sm: int
    acc_per_thread: int
    layout: LanesLayout


def max_lanes(d: int) -> int:
    """The most lanes one launch takes at width d (0: none)."""
    for lanes in (LANES_MAX, 8, 4):
        if lane_groups(lanes) * d <= LANES_THREADS * LANES_ACC_SIZES[-1] and \
                lanes_smem_layout(d, lanes, 1).bytes <= MAX_SMEM:
            return lanes
    return 0


@functools.lru_cache(maxsize=64)
def plan_lanes(n: int, d: int, lanes: int, sm_count: int) -> LanesPlan:
    """Tiles of ~16 KB of X (a multiple of 32 rows where a tile holds 32
    or more, at most 512, fewer where three stages would not fit in shared
    memory), two blocks per SM where
    their shared memory and a register budget of 128 (at most 2 gradient
    accumulators) allow, else one; the smallest accumulator count that
    covers the lane groups x d entries with 256 threads."""
    if not 1 <= lanes <= LANES_MAX:
        raise ValueError(f"the lanes kernel takes 1 <= K <= {LANES_MAX} "
                         f"lanes; got K={lanes}")
    if lanes > max_lanes(d):
        raise ValueError(
            f"the lanes kernel takes at most {max_lanes(d)} lanes at d={d} "
            f"(lane groups x d <= {LANES_THREADS * LANES_ACC_SIZES[-1]} "
            "gradient entries, three stages in shared memory); got "
            f"K={lanes}: split the lanes into groups")
    if n < 0 or sm_count < 1:
        raise ValueError(f"bad plan request n={n}, sm_count={sm_count}")
    ld = d | 1
    rows = min(max(_LANES_TILE_BYTES // (4 * ld), 1), _LANES_MAX_ROWS)
    if rows >= _LANES_ROW_STEP:
        rows = rows // _LANES_ROW_STEP * _LANES_ROW_STEP
    while rows > 1 and lanes_smem_layout(d, lanes, rows).bytes > MAX_SMEM:
        rows -= _LANES_ROW_STEP if rows > _LANES_ROW_STEP else 1
    layout = lanes_smem_layout(d, lanes, rows)
    acc = next(a for a in LANES_ACC_SIZES
               if a * LANES_THREADS >= lane_groups(lanes) * d)
    per_sm = 2 if acc <= 2 and 2 * (layout.bytes + 2048) <= _SM_SMEM else 1
    grid = max(1, min(sm_count * per_sm, -(-n // rows)))
    return LanesPlan(rows, grid, per_sm, acc, layout)


def fused_value_and_gradient_lanes_plain(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lanes kernel's function in plain PyTorch, in the inputs' dtype:
    for coefficients C [K, d], offsets O [K, n] and per-lane shifts b [K],
    Z = X C^T + O^T + b, then ([K] values, [K, d] gradients X^T (w l'),
    [K] sums of w l'), the mask a select."""
    z = x @ coefficients.T
    if shift is not None:
        z = z + shift
    if offsets is not None:
        z = z + offsets.T
    l, dl = loss.loss_and_dz(z, labels[:, None])
    if weights is not None:
        l = l * weights[:, None]
        dl = dl * weights[:, None]
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """([K] values, [K, d] gradients, [K] sums of w l') of K coefficient
    vectors C [K, d] in one pass over X, with offsets O [K, n] and a margin
    shift b [K] per lane, over the rows whose `mask` is nonzero.

    CPU tensors run the plain version.  CUDA tensors launch the kernel:
    every operand float32, contiguous and on X's device, K within
    `max_lanes(d)`; anything else raises."""
    if x.device.type == "cpu":
        return fused_value_and_gradient_lanes_plain(
            loss, x, labels, coefficients, weights, offsets, mask, shift)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2 or coefficients.ndim != 2:
        raise ValueError(f"X and C must be 2-D, got shapes {tuple(x.shape)} and "
                         f"{tuple(coefficients.shape)}")
    n, d = x.shape
    lanes = coefficients.shape[0]
    plan = plan_lanes(n, d, lanes, _sm_count(x.device.index))
    _check_operand("X", x, (n, d), x.device)
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
    lib = _build.load_library("fused_value_and_gradient_lanes")
    out = torch.empty((lanes, d + 2), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial, ticket = _workspace(x.device, stream, plan.grid * lanes * (d + 2))
        err = lib.pmt_fused_value_and_gradient_lanes(
            loss.kernel_id, x.data_ptr(), labels.data_ptr(), ptr(weights),
            ptr(offsets), ptr(mask), ptr(shift), coefficients.data_ptr(),
            partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), n, d, lanes,
            plan.rows_per_tile, plan.grid, plan.acc_per_thread, plan.layout.bytes,
            stream)
    if err != 0:
        raise RuntimeError("fused_value_and_gradient_lanes launch failed: "
                           f"{lib.pmt_lanes_error_string(err).decode()} ({err})")
    global LANES_LAUNCHES
    LANES_LAUNCHES += 1
    return out[:, 0], out[:, 1:d + 1], out[:, d + 1]
