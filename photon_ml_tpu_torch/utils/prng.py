"""A numpy copy of JAX's threefry2x32 PRNG, as jax 0.9.0 runs it with
`jax_threefry_partitionable=True` on the CPU.

The factored random effects, the `random_projection:<k>` projector and the
down-samplers of the JAX package draw from `jax.random`; torch has no
threefry, so the port reproduces those draws bit for bit here.  A key is a
plain numpy uint32 array of shape [2], as JAX's raw keys are.

- `PRNGKey(seed)`: (seed >> 32, seed & 0xFFFFFFFF) of a 64-bit seed.
- `split(key, num)`: threefry of the key over the counters 0..num-1,
  high and low words, stacked into [num, 2].
- `fold_in(key, data)`: threefry of the key over the pair (0, data).
- `random_bits(key, shape, width)`: threefry over the counters of every
  element (64-bit row-major index, high and low words); 32-bit words are
  the two outputs xor-ed, 64-bit words the first output's bits above the
  second's.
- `uniform(key, shape, dtype)`: the mantissa bits of `random_bits` under
  the exponent of 1.0, minus 1, scaled to [minval, maxval).
- `normal(key, shape, dtype)`: sqrt(2) * erfinv(u) for u uniform on
  (-1, 1), with erfinv as XLA's CPU backend evaluates it (its log1p and,
  in float32, its log included), so the draws match bit for bit.
- `permutation(key, n)`: JAX's `_shuffle` of arange(n): ceil(3 ln n /
  ln(2^32 - 1)) rounds, each splitting the key and stably sorting the
  indices by 32 random bits of the new subkey (the stochastic lane's
  coordinate order, optim/stochastic.py).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

Key = np.ndarray
Shape = Union[int, Sequence[int]]

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under `key`, elementwise over broadcast uint32 arrays."""
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = _u32(x0) + ks[0]
        x1 = _u32(x1) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey(seed) as a raw [2] uint32 key (seed taken as a
    64-bit two's-complement integer)."""
    s = int(seed) & ((1 << 64) - 1)
    return np.array([s >> 32, s & _MASK32], dtype=np.uint32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit row-major index of each element, as (high, low) words."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(_MASK32)).astype(np.uint32)


def split(key: Key, num: Shape = 2) -> np.ndarray:
    """jax.random.split: `num` new keys, [num, 2] (or [*num, 2])."""
    hi, lo = _counters(_shape(num))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in with a 32-bit datum."""
    b0, b1 = threefry2x32(key, _u32([0]), _u32([int(data) & _MASK32]))
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def random_bits(key: Key, shape: Shape, width: int = 32) -> np.ndarray:
    """jax.random.bits: uint32 (width 32) or uint64 (width 64) words."""
    b0, b1 = threefry2x32(key, *_counters(_shape(shape)))
    if width == 32:
        return b0 ^ b1
    if width == 64:
        return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    raise ValueError(f"width must be 32 or 64, got {width}")


def float_dtype(dtype) -> np.dtype:
    """A numpy float32/float64 dtype from a numpy or torch dtype."""
    if not isinstance(dtype, (np.dtype, type)):
        dtype = str(dtype).replace("torch.", "")
    dt = np.dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise TypeError(f"draws are float32 or float64, got {dtype}")
    return dt


def uniform(key: Key, shape: Shape, dtype=np.float32, minval=0.0,
            maxval=1.0) -> np.ndarray:
    """jax.random.uniform: floats in [minval, maxval)."""
    dt = float_dtype(dtype)
    shape = _shape(shape)
    fi = np.finfo(dt)
    nbits, nmant = fi.bits, fi.nmant
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = random_bits(key, shape, nbits).astype(uint)
    one = np.array(1.0, dt).view(uint)
    floats = ((bits >> uint(nbits - nmant)) | one).view(dt) - dt.type(1.0)
    lo, hi = dt.type(minval), dt.type(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's ErfInv (XLA's math library; chlo.erf_inv's expansion):
# float32, w = -log1p(-x^2), w < 5 then w > 5
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
# float64, w < 6.25, w < 16, w >= 16
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))
# XLA's log1p: a Cephes rational form where |x| < sqrt(2) - 1, log(1 + x)
# elsewhere
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880
# XLA CPU's float32 log (Cephes logf: frexp, a degree-8 polynomial on
# [sqrt(1/2) - 1, sqrt(2) - 1], the exponent times ln 2 in two parts)
_LOGF_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _two_sum(a: np.ndarray, b: np.ndarray):
    """s + e == a + b exactly, s = RN(a + b)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: np.ndarray, b: np.ndarray):
    """p + e == a * b exactly (float64, Veltkamp splitting)."""
    def halves(v):
        c = 134217729.0 * v
        hi = c - (c - v)
        return hi, v - hi
    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sum_round_odd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a + b rounded to odd (float64): the exact sum where it is a double,
    else whichever of the two doubles around it has an odd last bit."""
    s, e = _two_sum(a, b)
    step = np.nextafter(s, np.where(e > 0, np.inf, -np.inf))
    odd = (s.view(np.uint64) & np.uint64(1)) == 1
    return np.where((e == 0) | odd, s, step)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c with one rounding, as the fused multiply-adds XLA's CPU
    code contains (float32 through float64 rounded to odd; float64 by
    Boldo and Melquiond's emulation: an exact product, an exact sum with
    c, the low parts added rounded to odd)."""
    a = np.asarray(a)
    dt = a.dtype
    a, b, c = (np.broadcast_to(np.asarray(v, np.float64), np.broadcast(a, b, c).shape)
               for v in (a, b, c))
    if dt == np.float32:
        return _sum_round_odd(a * b, c).astype(np.float32)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _sum_round_odd(tl, ul)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    """XLA's EvaluatePolynomial: 0 * x + c0, then p * x + c fused."""
    dt = x.dtype.type
    p = x * dt(0) + dt(coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, dt(c))
    return p


def _logf(v: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log, operation for operation (its multiply-adds
    fused where the compiled code fuses them)."""
    f = np.float32
    m_in = np.where(v > f(2.0 ** -126), v, f(2.0 ** -126))
    bits = m_in.view(np.uint32)
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(np.float32) + f(1.0)
    small = m < f(0.707106769084930419921875)
    e = e - np.where(small, f(1.0), f(0.0))
    x = (m - f(1.0)) + np.where(small, m, f(0.0))
    x2 = x * x
    x3 = x2 * x
    c = [f(a) for a in _LOGF_POLY]
    p0 = _fma(_fma(x, c[0], c[1]), x, c[2])
    p1 = _fma(_fma(x, c[3], c[4]), x, c[5])
    p2 = _fma(_fma(x, c[6], c[7]), x, c[8])
    y = _fma(_fma(_fma(p0, x3, p1), x3, p2), x3, e * f(_LOGF_Q1))
    out = _fma(e, f(_LOGF_Q2), (x - x2 * f(0.5)) + y)
    out = np.where(v == f(np.inf), f(np.inf), out)
    out = np.where(v == f(0.0), f(-np.inf), out)
    return np.where(v < f(0.0), f(np.nan), out)


def _log(v: np.ndarray) -> np.ndarray:
    """log as XLA's CPU backend runs it: its own float32 polynomial, and
    the C library's log for float64 (Python's math.log)."""
    if v.dtype == np.float32:
        return _logf(v)
    return np.fromiter((math.log(t) if t > 0 else (-math.inf if t == 0 else math.nan)
                        for t in v.ravel().tolist()), np.float64,
                       count=v.size).reshape(v.shape)


def _log1p(x: np.ndarray) -> np.ndarray:
    dt = x.dtype.type
    x2 = x * x
    ratio = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(x2, dt(-0.5), (x * x2) * ratio)
    return np.where(np.abs(x) < dt(_LOG1P_SMALL), small, _log(x + dt(1.0)))


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's erf_inv, float32 or float64, as its CPU backend evaluates it
    (which flushes a subnormal result to zero)."""
    x = np.asarray(x)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        out = _erfinv(x)
    return np.where(np.abs(out) < np.finfo(x.dtype).tiny, np.copysign(x.dtype.type(0), out), out)


def _erfinv(x: np.ndarray) -> np.ndarray:
    dt = x.dtype.type
    w = -_log1p(-x * x)
    if x.dtype == np.float32:
        lt = w < dt(5.0)
        ww = np.where(lt, w - dt(2.5), np.sqrt(w) - dt(3.0))
        a, b = _ERFINV32
        p = np.where(lt, dt(a[0]), dt(b[0]))
        for i in range(1, 9):
            p = _fma(p, ww, np.where(lt, dt(a[i]), dt(b[i])))
    else:
        lt6, lt16 = w < dt(6.25), w < dt(16.0)
        ww = np.where(lt6, w - dt(3.125),
                      np.sqrt(w) - np.where(lt16, dt(3.25), dt(5.0)))
        a, b, c = _ERFINV64

        def coef(i):
            v = np.full(x.shape, dt(a[i]))
            if i < 19:
                v = np.where(lt6, v, dt(b[i]))
            if i < 17:
                v = np.where(lt16, v, dt(c[i]))
            return v
        p = coef(0)
        for i in range(1, 17):
            p = _fma(p, ww, coef(i))
        for i in range(17, 19):
            p = np.where(lt16, _fma(p, ww, coef(i)), p)
        for i in range(19, 23):
            p = np.where(lt6, _fma(p, ww, coef(i)), p)
    return x * np.where(np.abs(x) == dt(1.0), dt(np.inf), p)


def normal(key: Key, shape: Shape, dtype=np.float32) -> np.ndarray:
    """jax.random.normal: standard normal draws."""
    dt = float_dtype(dtype)
    lo = np.nextafter(np.array(-1.0, dt), np.array(0.0, dt), dtype=dt)
    u = uniform(key, shape, dt, lo, dt.type(1.0))
    return dt.type(np.sqrt(2)) * erfinv(u)


def permutation(key: Key, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)` for an int n, bit for bit: int64
    indices (JAX's are int32 of the same values)."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,), 32), kind="stable")]
    return x
