"""PH012 torch fixture: torch's host syncs inside a lock region (five
findings) — every thread contending for the lock stalls behind the
blocked holder."""
import threading

import torch


class Publisher:
    def __init__(self):
        self._lock = threading.Lock()
        self._rows = None
        self._n = 0.0

    def publish(self, x: torch.Tensor, event):
        with self._lock:
            self._rows = x.cpu()
            self._n = x.sum().item()
            torch.cuda.synchronize()
            event.synchronize()
            self._n = float(x.max())
