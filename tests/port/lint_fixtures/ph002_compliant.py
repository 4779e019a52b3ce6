"""PH002 torch near-misses: a library named by a literal is built once per
process, a query of the scripting state compiles nothing, and eager ops
launch without a capture."""
import torch

from photon_ml_tpu_torch.ops import _build


def library():
    return _build.load_library("fused_value_and_gradient")


def scripting():
    return torch.jit.is_scripting()


def launch(x):
    return torch.mm(x, x.T)
