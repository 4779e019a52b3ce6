"""PH001 torch fixture: host syncs in a hot-path module (the `ops/` path
component makes this file hot).  Ten violations, one per sync spelling."""
import numpy as np
import torch

from photon_ml_tpu_torch.ops import hopper_kernels as hk


def objective_to_host(x: torch.Tensor):
    v = torch.dot(x, x)
    return float(v)


def item_sync(x: torch.Tensor):
    return x.sum().item()


def hidden_transfer(x: torch.Tensor):
    y = torch.exp(x)
    return np.asarray(y)


def fetch(x: torch.Tensor):
    return x.cpu()


def to_host(x: torch.Tensor):
    return x.to("cpu")


def count(n: torch.Tensor):
    return list(range(n))


def fence():
    torch.cuda.synchronize()


def wait(event):
    event.synchronize()


def moved(rows):
    y = rows.to(device="cuda")
    return y.tolist()


def kernel_value(x, y, c, w, o):
    value, grad = hk.fused_value_and_gradient(0, x, y, c, w, o)
    return bool(value > 0)
