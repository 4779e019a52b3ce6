"""PH001 torch near-misses: everything here looks like a violation but is
fine — host values, a constructor without `device=`, host->device
transfers, static metadata, numpy's own `.item()`, and the one designated
flush point."""
import numpy as np
import torch


def host_side(cfg):
    return float(cfg["tolerance"])  # plain host value


def host_tensor(w, dtype):
    # a constructor without device= is a host value (game/coordinates.py)
    return float(torch.tensor(w, dtype=dtype))


def to_device(rows: np.ndarray):
    return torch.as_tensor(rows, device="cuda")  # host -> device: no sync


def metadata(x: torch.Tensor):
    return x.shape, x.dtype, x.device, x.numel(), int(x.shape[0])


def cast_on_host(a: np.ndarray):
    return torch.from_numpy(a).to(torch.float64).numpy()


def numpy_item(a: np.ndarray):
    return a.sum().item()


def flush(pending: torch.Tensor):  # photonlint: flush-point
    # THE designated batched read-back: one copy for the whole iteration
    return pending.cpu().tolist()
