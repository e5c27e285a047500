"""``repro_torch.prng`` against ``jax.random`` (jax 0.9.0 defaults:
threefry2x32, partitionable, x64 off).  Every comparison is bitwise but
``normal``'s, which holds to 3 ulp (``erf_inv``'s ``log1p`` and fused
multiply-adds round differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = [0, 1, 3, 7, 12345, 2 ** 31 - 1, 2 ** 32 - 1]


def _jkey(words):
    return jnp.asarray(np.asarray(words, np.uint32))


def _tkey(words):
    return torch.tensor(np.asarray(words, np.int64))


def _keys(n=24, seed=0):
    """n random raw keys (two uint32 words each), from numpy."""
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                                dtype=np.uint64)


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t).astype(np.int64),
                                  np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -5])
def test_prngkey(seed):
    _eq(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


def test_threefry_words_match_jax_primitive():
    from jax._src import prng as jprng
    r = np.random.default_rng(1)
    k = r.integers(0, 2 ** 32, 2, dtype=np.uint64)
    x = r.integers(0, 2 ** 32, (2, 64), dtype=np.uint64)
    want = jprng.threefry2x32_p.bind(
        *(jnp.asarray(np.uint32(v)) for v in k),
        jnp.asarray(x[0].astype(np.uint32)), jnp.asarray(x[1].astype(np.uint32)))
    got = prng.threefry2x32(*(torch.tensor(int(v)) for v in k),
                            torch.tensor(x[0].astype(np.int64)),
                            torch.tensor(x[1].astype(np.int64)))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("data", [0, 1, 5, 1000, 2 ** 31 - 1, 2 ** 32 - 1, -3])
def test_fold_in_many_keys(data):
    for words in _keys():
        want = jax.random.fold_in(_jkey(words), np.uint32(data & 0xFFFFFFFF)
                                  if data < 0 else data)
        _eq(prng.fold_in(_tkey(words), data), want)


def test_fold_in_batched_equals_vmap():
    keys = _keys(16, seed=3)
    data = np.arange(16, dtype=np.int32) * 37
    want = jax.vmap(jax.random.fold_in)(_jkey(keys), jnp.asarray(data))
    _eq(prng.fold_in(_tkey(keys), torch.tensor(data)), want)


@pytest.mark.parametrize("num", [1, 2, 3, 8, 40])
def test_split(num):
    for words in _keys(8, seed=num):
        _eq(prng.split(_tkey(words), num), jax.random.split(_jkey(words), num))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4)])
def test_bits(shape):
    for words in _keys(6, seed=len(shape)):
        _eq(prng.bits(_tkey(words), shape),
            jax.random.bits(_jkey(words), shape))


@pytest.mark.parametrize("span", [(0, 1), (0, 2), (0, 7), (0, 20), (-5, 13),
                                  (3, 3), (5, 2), (0, 65536), (0, 70001),
                                  (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", [(), (9,), (4, 6)])
def test_randint(span, shape):
    lo, hi = span
    for words in _keys(6, seed=hi & 0xFF):
        want = jax.random.randint(_jkey(words), shape, lo, hi)
        got = prng.randint(_tkey(words), shape, lo, hi)
        assert got.dtype == torch.int32
        _eq(got, want)


def test_randint_batched_keys_and_bounds_equal_vmap():
    """The schedules' pattern: one scalar draw per client key, each with its
    own exclusive upper bound E_i."""
    keys = _keys(40, seed=9)
    E = (np.arange(40) % 20 + 1).astype(np.int32)
    want = jax.vmap(lambda k, e: jax.random.randint(k, (), 0, e))(
        _jkey(keys), jnp.asarray(E))
    _eq(prng.randint(_tkey(keys), (), 0, torch.tensor(E)), want)


@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((33,), 0.0, 1.0),
                                         ((4, 5), -2.0, 3.5)])
def test_uniform_bitwise(shape, lo, hi):
    for words in _keys(6, seed=11):
        want = np.asarray(jax.random.uniform(_jkey(words), shape,
                                             minval=lo, maxval=hi))
        got = prng.uniform(_tkey(words), shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_scheduling_key_is_seed_seed():
    """``PRNGKey(0) + seed`` (core/scheduling.py) is (seed, seed)."""
    for seed in SEEDS[:5]:
        _eq(np.array([seed, seed]), jax.random.PRNGKey(0) + seed)


@pytest.mark.parametrize("shape", [(3072, 64), (64, 10), (7,)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_normal_within_3_ulp(seed, shape):
    """``normal`` (XLA's float32 ``erf_inv``) against ``jax.random.normal``
    on the keys of a split, as the MLP twin draws its weights."""
    want = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed))[1], shape))
    got = prng.normal(prng.split(prng.PRNGKey(seed))[1], shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 3 * ulp).all()
