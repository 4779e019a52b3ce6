"""photon_ml_tpu_torch — the PyTorch/CUDA port of photon_ml_tpu.

The JAX package stays the reference; this package mirrors its layout
(ops/, optim/, models/, data/, utils/) so every module's counterpart is easy
to find, and imports nothing of it (nor of JAX).  Plain tensor code is
PyTorch; the one TPU kernel of the JAX package
(photon_ml_tpu/ops/pallas_kernels.py::fused_value_and_gradient) is a CUDA
kernel written by hand for Hopper (csrc/fused_value_and_gradient.cu), and
so are the sparse feature products (csrc/ell_sparse.cu) and the fixed
effect's pass over the candidate lanes of a hyperparameter sweep
(csrc/fused_value_and_gradient_lanes.cu).

Device policy: entry points take `device=None`, which means "cuda".  When
CUDA is absent they raise; nothing carries on silently on the CPU.  Pass
`device="cpu"` to run on the CPU (the parity tests do).  Computation uses
the dtype of the labels: float32 on the card, float64 for CPU parity.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None) -> "torch.device":
    """`None` -> cuda.  Raises when a CUDA device is asked for and absent."""
    import torch     # not at import: the linter (analysis/) runs without torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
