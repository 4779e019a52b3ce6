"""PH006 torch fixture: host wall-clock and host RNG inside graph captures
(three findings) — both freeze at capture time."""
import random
import time

import torch


@torch.compile
def noisy(x):
    return x * random.random() + time.time()


def captured(graph, x):
    with torch.cuda.graph(graph):
        y = x * time.perf_counter()
    return y
