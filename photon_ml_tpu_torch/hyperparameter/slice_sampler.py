"""Univariate-sweep slice sampler (MCMC) for the GP hyper-posterior (a copy
of photon_ml_tpu/hyperparameter/slice_sampler.py: the same
`np.random.default_rng` draws in the same order, so the same chains).

Rebuild of photon-lib/.../hyperparameter/SliceSampler.scala:53-220: draw a
vertical level under log p(x), step out along one coordinate direction until
the slice brackets the level set, then sample-and-shrink until a point above
the level is found; one draw sweeps all coordinates in random order.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np


class SliceSampler:
    """reference: SliceSampler.scala (step-out at lines 165-190, shrink at
    192-220, per-coordinate sweep in draw())."""

    def __init__(
        self,
        logp: Callable[[np.ndarray], float],
        value_range: Tuple[float, float] = (math.log(1e-5), math.log(1e5)),
        step_size: float = 1.0,
        seed: int = 0,
    ):
        self.logp = logp
        self.range = value_range
        self.step_size = step_size
        self.rng = np.random.default_rng(seed)

    def draw(self, x: np.ndarray) -> np.ndarray:
        """One full sweep: a univariate slice draw along every coordinate,
        visited in random order."""
        x = np.asarray(x, dtype=np.float64).copy()
        for i in self.rng.permutation(len(x)):
            x = self._draw_along(x, int(i))
        return x

    def _draw_along(self, x: np.ndarray, i: int, max_rejections: int = 1000
                    ) -> np.ndarray:
        y = math.log(self.rng.random()) + float(self.logp(x))
        lower, upper = self._step_out(x, y, i)
        lo_bound, hi_bound = self.range
        # bounded: if logp is -inf over the whole range (e.g. every Cholesky
        # fails because two observation vectors are duplicated), no candidate
        # ever satisfies logp > y = -inf — return x unchanged instead of
        # spinning forever
        for _ in range(max_rejections):
            xi = lower + self.rng.random() * (upper - lower)
            new_x = x.copy()
            new_x[i] = xi
            if float(self.logp(new_x)) > y:
                return new_x
            # reject: shrink the slice toward x; if it collapses, reset to
            # the full range (reference: the catch block in draw())
            if xi < x[i]:
                lower = xi
            elif xi > x[i]:
                upper = xi
            else:
                lower, upper = lo_bound, hi_bound
        return x

    def _step_out(self, x: np.ndarray, y: float, i: int) -> Tuple[float, float]:
        lo_bound, hi_bound = self.range
        lower = x[i] - self.rng.random() * self.step_size
        upper = lower + self.step_size

        def logp_at(v: float) -> float:
            xx = x.copy()
            xx[i] = v
            return float(self.logp(xx))

        while logp_at(lower) > y and lower > lo_bound:
            lower -= self.step_size
        while logp_at(upper) > y and upper < hi_bound:
            upper += self.step_size
        return lower, upper
