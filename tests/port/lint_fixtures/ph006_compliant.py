"""PH006 torch near-misses: timing around eager work, and a capture whose
draw is passed in."""
import random
import time

import torch


def stamped(x):
    t0 = time.perf_counter()
    y = x * random.random()
    return y, time.perf_counter() - t0


def captured(graph, x, scale):
    with torch.cuda.graph(graph):
        y = x * scale
    return y
