"""The fixed effect's objective over K candidate lanes: one shard, K
coefficient vectors (the candidate lane of a hyperparameter sweep,
hyperparameter/vectorized.py).

The JAX package gets this pass by `jax.vmap` of its solve over the
candidates with X, labels, weights and the normalization unmapped and the
offsets and regularization weights mapped
(photon_ml_tpu/hyperparameter/vectorized.py::_fe_sweep_update): XLA then
reads X once for all K margins.  Here, on a CUDA tensor, a dense X goes
through the lanes kernel (ops/hopper_kernels.py::
fused_value_and_gradient_lanes): one launch per pass for up to
`max_lanes(d)` candidates, so K candidates take one launch per group of
them per pass.  A dense X wider than the lanes kernel takes (d > 2,048)
runs the single fused kernel once per candidate per pass, up to its own
width limit D_MAX, as an isolated fit of the same width would; a
PaddedSparse X runs kernels A and B once per candidate per pass
(ops/aggregators.py).  `lanes_route` names the route.  On the CPU the same
functions run their plain versions.  Normalization is folded in as the
single kernel folds it: E = C * f in, the lane shift b_k = -(e_k . s),
then (grad - s swl) * f.

The lanes may also differ in their rows' weights: with `lane_keep` [K, n]
(0/1), lane k weighs row i by w_i * keep[k, i], as jax.vmap of the solve
over weight rows member_k * w does (the bootstrap's replicas,
photon_ml_tpu/diagnostics/bootstrap.py).  On the "lanes" route each
group's int32 word (bit k = lane lo + k) is built once, and the kernel
reads it as one more per-row stream; the "single" and "sparse" routes take
each lane's weights w * keep_k, built once; the Hessian-vector products
multiply l'' by them.

A bf16 X (the JAX package's bf16 feature storage) goes to the lanes
kernel as it is.  The JAX package then keeps the lanes' state in X's
dtype (photon_ml_tpu/hyperparameter/vectorized.py:440-441,
photon_ml_tpu/diagnostics/bootstrap.py:112-126), so C, the labels,
weights and offsets come in bf16 too: the pass widens them exactly to
float32 (the kernel's operands), computes in float32, and rounds its
values and gradients to the state's dtype.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.ops import aggregators as agg
from photon_ml_tpu_torch.ops import features as fops
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext


def lanes_route(d: int, device: torch.device, xbytes: int = 4) -> str:
    """How a dense fixed effect's K-lane pass runs at width d (X's elements
    `xbytes` bytes): "plain" on the CPU (the plain version takes any lane
    count), "lanes" on the card where the lanes kernel takes width d, else
    "single" (the single fused kernel once per lane) up to hk.D_MAX; wider
    raises, as an isolated fit's pass does."""
    if device.type == "cpu":
        return "plain"
    if hk.max_lanes(d, xbytes=xbytes) > 0:
        return "lanes"
    if d <= hk.D_MAX:
        return "single"
    raise ValueError(f"no kernel takes a dense fixed effect of width d={d} "
                     f"(the single kernel takes d <= {hk.D_MAX})")


def launch_groups(num_lanes: int, d: int, device: torch.device,
                  masked: bool = False, xbytes: int = 4) -> List[Tuple[int, int]]:
    """[start, stop) of each group of lanes one kernel launch takes: one
    group on the CPU (groups of 32 with a lane mask, the bits of its
    word), groups of up to max_lanes(d, masked) on the "lanes" route, one
    lane a group on the "single" route."""
    route = lanes_route(d, device, xbytes)
    if route == "plain":
        size = LANE_WORD_BITS if masked else max(num_lanes, 1)
    else:
        size = hk.max_lanes(d, masked, xbytes) if route == "lanes" else 1
    return [(k, min(k + size, num_lanes)) for k in range(0, num_lanes, size)]


LANE_WORD_BITS = 32


def lane_words(keep: torch.Tensor) -> torch.Tensor:
    """The int32 [n] lane mask of at most 32 lanes' 0/1 rows keep [K, n]:
    bit k of word i = keep[k, i]."""
    if keep.shape[0] > LANE_WORD_BITS:
        raise ValueError(f"a lane mask word holds {LANE_WORD_BITS} lanes; got {keep.shape[0]}")
    word = torch.zeros(keep.shape[1], dtype=torch.int32, device=keep.device)
    for k in range(keep.shape[0]):
        word |= keep[k].to(torch.int32) << k
    return word


def lanes_matvec(x: fops.FeatureMatrix, coefficients: torch.Tensor) -> torch.Tensor:
    """[K, n] margins X c_k of K coefficient vectors [K, d]."""
    if isinstance(x, torch.Tensor):
        return coefficients @ x.T
    return torch.stack([fops.matvec(x, c) for c in coefficients])


class FixedEffectLanes:
    """K GLM objectives over one shard: lane k has offsets O[k] (none when
    `offsets` is None), L2 weight l2[k] and, with `lane_keep` [K, n], the
    row weights w * lane_keep[k].

    value_and_gradient(C [K, d]) -> ([K] values, [K, d] gradients)
    hessian_vector_at(C)         -> V [K, d] -> [K, d] products

    in the normalized space when `norm` is set, each with its lane's L2
    term, as optim/batched.py's lanes expect."""

    def __init__(self, loss: PointwiseLoss, x: fops.FeatureMatrix,
                 labels: torch.Tensor, offsets: Optional[torch.Tensor],
                 l2_weights: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 norm: Optional[NormalizationContext] = None,
                 lane_keep: Optional[torch.Tensor] = None):
        # a bf16 lane state (the bootstrap's, in X's dtype as the JAX
        # package keeps it) computes in float32: its vectors widen exactly
        wide = lambda t: t.float() if t is not None and t.dtype == torch.bfloat16 else t
        self.loss = loss
        self.x = x
        self.labels = wide(labels)
        self.offsets = None if offsets is None else wide(offsets).contiguous()
        self.l2 = wide(l2_weights)
        self.weights = wide(weights)
        self.norm = None if norm is None or norm.is_identity else norm
        self.dense = isinstance(x, torch.Tensor)
        lanes = l2_weights.shape[0]
        masked = lane_keep is not None
        # the route of a value+gradient pass, and its kernel launches: one
        # per group (of the lanes kernel on "lanes", of the single kernel
        # on "single")
        xbytes = hk.X_BYTES.get(x.dtype, 4)
        self.route = (lanes_route(x.shape[1], x.device, xbytes) if self.dense
                      else "sparse")
        self.groups = (launch_groups(lanes, x.shape[1], x.device, masked, xbytes)
                       if self.dense else [])
        # each group's lane mask word (lanes and plain routes), and each
        # lane's weights w * keep_k (single and sparse routes, and Hv)
        self.words = [None] * len(self.groups)
        self.lane_weights = None
        self._keep = (None if lane_keep is None
                      else lane_keep.to(device=x.device, dtype=torch.bool))
        if masked:
            if self.route in ("lanes", "plain"):
                self.words = [lane_words(self._keep[lo:hi]) for lo, hi in self.groups]
            if self.route in ("single", "sparse"):
                self.lane_weights = self._weights_of_lanes()

    def _weights_of_lanes(self) -> torch.Tensor:
        """[K, n] row weights w * keep_k in the labels' dtype."""
        keep = self._keep.to(self.labels.dtype)
        return keep if self.weights is None else self.weights * keep

    def _lane_offsets(self, k: int):
        return None if self.offsets is None else self.offsets[k]

    def _lane_weights(self, k: int):
        return self.weights if self.lane_weights is None else self.lane_weights[k]

    def _l2_terms(self, c: torch.Tensor, value: torch.Tensor, grad: torch.Tensor):
        return (value + 0.5 * self.l2 * (c * c).sum(-1),
                grad + self.l2[:, None] * c)

    def value_and_gradient(self, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if c.dtype == torch.bfloat16:
            # bf16 lane state: the pass in float32, its results rounded
            value, grad = self.value_and_gradient(c.float())
            return value.to(c.dtype), grad.to(c.dtype)
        if not self.dense:
            parts = [agg.value_and_gradient(self.loss, self.x, self.labels, ck,
                                            weights=self._lane_weights(k),
                                            offsets=self._lane_offsets(k), norm=self.norm)
                     for k, ck in enumerate(c)]
            return self._l2_terms(c, torch.stack([v for v, _ in parts]),
                                  torch.stack([g for _, g in parts]))
        factors = None if self.norm is None else self.norm.factors
        shifts = None if self.norm is None else self.norm.shifts
        e = c if factors is None else c * factors
        b = None if shifts is None else -(e @ shifts)
        if self.route == "single":
            parts = [hk.fused_value_and_gradient(self.loss, self.x, self.labels,
                                                 e[k].contiguous(), self._lane_weights(k),
                                                 self._lane_offsets(k), None, shifts)
                     for k in range(e.shape[0])]
            value, grad = torch.stack([v for v, _ in parts]), torch.stack([g for _, g in parts])
            if factors is not None:
                grad = grad * factors
            return self._l2_terms(c, value, grad)
        values, grads, swls = [], [], []
        for (lo, hi), word in zip(self.groups, self.words):
            v, g, swl = hk.fused_value_and_gradient_lanes(
                self.loss, self.x, self.labels, e[lo:hi].contiguous(),
                self.weights, None if self.offsets is None else self.offsets[lo:hi], None,
                None if b is None else b[lo:hi].contiguous(), word)
            values.append(v)
            grads.append(g)
            swls.append(swl)
        value, grad = torch.cat(values), torch.cat(grads)
        if shifts is not None:
            grad = grad - shifts * torch.cat(swls)[:, None]
        if factors is not None:
            grad = grad * factors
        return self._l2_terms(c, value, grad)

    def hessian_vector_at(self, c: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        """V -> every lane's Hv at C (with its L2 term): for a dense X the
        margins and l'' of all lanes are computed once, and each product
        is two matrix products over X; a sparse X takes each lane's
        ops/aggregators.py closure.  A bf16 state's products run in
        float32 and are rounded, as its value and gradient."""
        if c.dtype == torch.bfloat16:
            hv32 = self.hessian_vector_at(c.float())
            return lambda v: hv32(v.float()).to(v.dtype)
        if not self.dense:
            hvs = [agg.hessian_vector_at(self.loss, self.x, self.labels, ck,
                                         weights=self._lane_weights(k),
                                         offsets=self._lane_offsets(k), norm=self.norm)
                   for k, ck in enumerate(c)]
            return lambda v: torch.stack([h(vk) for h, vk in zip(hvs, v)]) + \
                self.l2[:, None] * v
        factors = None if self.norm is None else self.norm.factors
        shifts = None if self.norm is None else self.norm.shifts
        effective = (lambda v: v) if factors is None else (lambda v: v * factors)
        x = self.x

        def margins(v):
            e = effective(v)
            z = fops._mv(x, e.T)             # [n, K]; a bf16 X promotes
            return z if shifts is None else z - e @ shifts

        z = margins(c)
        d2 = self.loss.d2z(z if self.offsets is None else z + self.offsets.T,
                           self.labels[:, None])
        if self.lane_weights is None and self._keep is not None:
            self.lane_weights = self._weights_of_lanes()
        if self.lane_weights is not None:
            d2 = d2 * self.lane_weights.T
        elif self.weights is not None:
            d2 = d2 * self.weights[:, None]

        def hv(v: torch.Tensor) -> torch.Tensor:
            t = d2 * margins(v)              # [n, K]
            out = fops._rmv(x, t).T          # [K, d]
            if shifts is not None:
                out = out - shifts * t.sum(0)[:, None]
            if factors is not None:
                out = out * factors
            return out + self.l2[:, None] * v

        return hv
