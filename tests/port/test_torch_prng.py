"""utils/prng.py == jax.random (jax 0.9.0, threefry, partitionable), on the
CPU.

The JAX draws are made once for the module in a subprocess
(game_jax_side.py prng), so no jax.random program compiles in the test
process.  Keys, split (and a chain of splits), fold_in, random bits (32
and 64 bit), uniform (float32 and float64, on [0, 1) and on another range)
and normal (float32 and float64) are held BIT-EQUAL to jax.random for six
seeds and five odd shapes, and 20,000 normal draws for each of five more
keys: the copy evaluates XLA's erfinv and log1p (and, in float32, its
log) with the fused multiply-adds XLA's CPU code makes, so normal needs no
ulp tolerance either.  `permutation(key, n)` equals jax.random.permutation
for six seeds and n in PRNG_PERMUTATION_NS."""
import numpy as np
import pytest
import torch

import game_jax_side as side
from photon_ml_tpu_torch.parallel.factored import gaussian_projection_matrix
from photon_ml_tpu_torch.utils import prng

DTYPES = (np.float32, np.float64)


@pytest.fixture(scope="module")
def jax_draws(tmp_path_factory):
    return side.run_jax_side("prng", tmp_path_factory.mktemp("jax") / "prng.npz")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


def test_the_reference_runs_partitionable_threefry(jax_draws):
    assert bool(jax_draws["partitionable"])


@pytest.mark.parametrize("seed", side.PRNG_SEEDS)
def test_key_split_and_fold_in_are_bit_equal(jax_draws, seed):
    kn = prng.PRNGKey(seed)
    _bits_equal(jax_draws[f"{seed}/key"], kn)
    for num in side.PRNG_SPLITS:
        _bits_equal(jax_draws[f"{seed}/split/{num}"], prng.split(kn, num))
    for data in side.PRNG_FOLDS:
        _bits_equal(jax_draws[f"{seed}/fold_in/{data}"], prng.fold_in(kn, data))
    # a chain of splits, as the coordinates walk their keys
    for i in range(4):
        kn, sub = prng.split(kn)
        _bits_equal(jax_draws[f"{seed}/chain/{i}"], sub)


@pytest.mark.parametrize("seed", side.PRNG_SEEDS)
@pytest.mark.parametrize("shape", side.PRNG_SHAPES)
def test_bits_uniform_and_normal_are_bit_equal(jax_draws, seed, shape):
    kn, tag = prng.PRNGKey(seed), f"{seed}/{shape}"
    _bits_equal(jax_draws[f"{tag}/bits32"], prng.random_bits(kn, shape))
    _bits_equal(jax_draws[f"{tag}/bits64"], prng.random_bits(kn, shape, 64))
    for dt in DTYPES:
        name = np.dtype(dt).name
        _bits_equal(jax_draws[f"{tag}/uniform/{name}"], prng.uniform(kn, shape, dt))
        _bits_equal(jax_draws[f"{tag}/uniform_range/{name}"],
                    prng.uniform(kn, shape, dt, -3.3, 5.7))
        _bits_equal(jax_draws[f"{tag}/normal/{name}"], prng.normal(kn, shape, dt))


@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_is_bit_equal(jax_draws, dtype):
    """Every erfinv branch is taken (w < 5 / >= 5 in float32; < 6.25, < 16,
    >= 16 in float64) and log1p's rational and log forms both."""
    name = np.dtype(dtype).name
    for seed in range(side.PRNG_NORMAL_SEEDS):
        _bits_equal(jax_draws[f"normal/{seed}/{name}"],
                    prng.normal(prng.PRNGKey(seed), (side.PRNG_NORMAL_N,), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_erfinv_is_xla_erf_inv_bit_for_bit(jax_draws, dtype):
    """At the edges too: 0, +-1 (+-inf), the smallest normal number (a
    subnormal result, flushed to zero as XLA's CPU code flushes it) and
    the largest draws below 1."""
    _bits_equal(jax_draws[f"erfinv/{np.dtype(dtype).name}"],
                prng.erfinv(side.erfinv_inputs(dtype)))


def test_torch_dtypes_are_accepted_and_others_refused():
    k = prng.PRNGKey(5)
    _bits_equal(prng.uniform(k, (4,), torch.float64), prng.uniform(k, (4,), np.float64))
    _bits_equal(prng.normal(k, (4,), torch.float32), prng.normal(k, (4,), np.float32))
    with pytest.raises(TypeError):
        prng.uniform(k, (4,), np.float16)
    with pytest.raises(ValueError):
        prng.random_bits(k, (4,), 16)


def test_gaussian_projection_draws_in_float32_as_jax_without_x64(jax_draws):
    """The port draws in the dtype it computes in: in float32 it is JAX's
    float32 draw, N(0, 1)/k clipped in float32 (what the JAX package draws
    without x64), with the intercept selector row below."""
    k, d = 4, 9
    want = np.clip(jax_draws["normal_f32_4x9_seed11"] / np.float32(k), -1.0, 1.0)
    got = gaussian_projection_matrix(k, d, keep_intercept=True, seed=11,
                                     dtype=torch.float32, device="cpu").numpy()
    _bits_equal(got[:k], want)
    np.testing.assert_array_equal(got[k], np.eye(d, dtype=np.float32)[-1])


@pytest.mark.parametrize("n", side.PRNG_PERMUTATION_NS)
@pytest.mark.parametrize("seed", side.PRNG_SEEDS)
def test_permutation_is_bit_equal(jax_draws, seed, n):
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 2), 5)
    got = prng.permutation(key, n)
    want = jax_draws[f"{seed}/permutation/{n}"]
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
