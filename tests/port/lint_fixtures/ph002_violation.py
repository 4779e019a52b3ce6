"""PH002 torch fixture: builds and graph captures at call time (five
findings) — a compiled decorator, a trace, a CUDA graph and its capture,
and a kernel library named by a variable."""
import torch

from photon_ml_tpu_torch.ops import _build


@torch.compile
def step(x):
    return x * 2


def traced(f, x):
    return torch.jit.trace(f, x)


def capture(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2
    return graph, y


def load(name):
    return _build.load_library(name)
