"""Hand-written Hopper kernels and their plain PyTorch versions.

`fused_value_and_gradient` replaces the JAX package's one TPU kernel,
photon_ml_tpu/ops/pallas_kernels.py::fused_value_and_gradient: one pass over
a dense X [n, d] gives (sum_i w_i l(z_i, y_i), X^T (w * l'(z, y))) with
z = X c (+ o).  On a CUDA tensor the wrapper launches the CUDA kernel
(csrc/fused_value_and_gradient.cu, built at first use by ops/_build.py) or
raises; on a CPU tensor it runs the plain version.  Importing this module
builds nothing.

`LAUNCHES` counts the wrapper's kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss

LAUNCHES = 0

# Must match kWarps in the CUDA source: shared memory holds c and one
# gradient row per warp, (kWarps + 1) * d * 4 bytes, of the 227 KB a block
# may use on Hopper (less 1 KB kept for the kernel's static shared memory).
_WARPS = 8
_BLOCKS_PER_SM = 8
D_MAX = (232_448 - 1024) // ((_WARPS + 1) * 4)


def fused_value_and_gradient_plain(
    loss: PointwiseLoss,
    x: torch.Tensor,
    labels: torch.Tensor,
    coefficients: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in the inputs' dtype: two
    matrix-vector products around the pointwise loss."""
    z = torch.mv(x, coefficients)
    if offsets is not None:
        z = z + offsets
    l, dl = loss.loss_and_dz(z, labels)
    if weights is not None:
        l = l * weights
        dl = dl * weights
    return l.sum(), torch.mv(x.T, dl)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_i w_i l(z_i, y_i), gradient) in one pass over X.

    CPU tensors run the plain version.  CUDA tensors launch the kernel:
    every operand float32, contiguous and on X's device, d <= D_MAX;
    anything else raises."""
    if x.device.type == "cpu":
        return fused_value_and_gradient_plain(loss, x, labels, coefficients,
                                              weights, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    n, d = x.shape
    if not 1 <= d <= D_MAX:
        raise ValueError(f"the fused kernel takes 1 <= d <= {D_MAX} "
                         f"(shared memory per block); got d={d}")
    _check_operand("X", x, (n, d), x.device)
    _check_operand("labels", labels, (n,), x.device)
    _check_operand("coefficients", coefficients, (d,), x.device)
    if weights is not None:
        _check_operand("weights", weights, (n,), x.device)
    if offsets is not None:
        _check_operand("offsets", offsets, (n,), x.device)

    from photon_ml_tpu_torch.ops import _build
    lib = _build.load_library("fused_value_and_gradient")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(-(-n // _WARPS), sms * _BLOCKS_PER_SM))
    partial = torch.empty((grid, d + 1), dtype=torch.float32, device=x.device)
    out = torch.empty((d + 1,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pmt_fused_value_and_gradient(
            loss.kernel_id, x.data_ptr(), labels.data_ptr(), ptr(weights),
            ptr(offsets), coefficients.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, d, grid, stream)
    if err != 0:
        raise RuntimeError("fused_value_and_gradient launch failed: "
                           f"{lib.pmt_error_string(err).decode()} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    return out[0], out[1:]
