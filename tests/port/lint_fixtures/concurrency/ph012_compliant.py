"""PH012 torch near-miss: the read-back happens OUTSIDE the critical
section and only the host copy's swap runs under the lock; metadata and
host values under the lock block nothing."""
import threading

import numpy as np
import torch


class Publisher:
    def __init__(self):
        self._lock = threading.Lock()
        self._rows = None
        self._shape = None
        self._n = 0.0

    def publish(self, x: torch.Tensor, counts: np.ndarray):
        rows = x.cpu()                  # the read-back before the lock
        with self._lock:
            self._rows = rows
            self._shape = x.shape
            self._n = float(counts.sum().item())
