"""A bit-exact copy of the part of ``jax.random`` that the schedules use.

JAX's default generator is Threefry-2x32 (20 rounds) with
``jax_threefry_partitionable=True`` and 64-bit types off; under those
defaults the functions below return the same bits as their ``jax.random``
namesakes:

* a key is an int64 tensor of shape (..., 2) holding two uint32 words
  (JAX's raw ``uint32[2]`` key); leading dimensions batch independent keys,
  as ``vmap`` over keys would;
* ``fold_in(key, d)`` = threefry(key, (0, d));
* ``split(key, n)[i]`` = threefry(key, (0, i)) (the partitionable split
  counts with a 64-bit iota, so it equals ``fold_in(key, i)``);
* ``bits(key, shape)`` = w1 ^ w2 of threefry(key, (hi(j), lo(j))) for the
  flat index j of each element;
* ``randint`` draws two words per element from ``split(key, 2)`` and folds
  them with the multiplier ``2^32 mod span``, not a plain modulus;
* ``exponential`` is ``-log1p(-uniform)`` as in JAX, but only ulp-close to
  it: XLA's CPU ``log1p`` and PyTorch's differ by up to 2 ulp on about a
  tenth of the inputs.

Torch has no full uint32 arithmetic, so every word is held in int64 and
every sum, shift and rotation is masked with ``& 0xFFFFFFFF``.  Keys are
made with ``PRNGKey(seed)`` = (0, seed); ``core.scheduling`` builds its key
as the reference does, ``PRNGKey(0) + seed`` = (seed, seed).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _word(x, device=None) -> torch.Tensor:
    """A uint32 word (or words) as int64; negative ints wrap as in a cast
    to uint32."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words
    (broadcast against each other).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    return torch.stack([_word(int(seed) >> 32 if seed >= 0 else 0, device),
                        _word(seed, device)])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (an int or an int tensor) broadcasts
    against the key's leading dimensions."""
    d = _word(data, key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, ..., 2) keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    i = i.reshape((num,) + (1,) * (key.dim() - 1))
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): int64 words of shape
    (*key.shape[:-1], *shape)."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2^32 random words from one key")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(batch + (1,) * len(shape))
    k2 = key[..., 1].reshape(batch + (1,) * len(shape))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y1 ^ y2


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` into int32; the
    bounds broadcast against (*key.shape[:-1], *shape)."""
    k = split(key, 2)
    hi, lo = bits(k[0], shape), bits(k[1], shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    minval = minval.clamp(-2 ** 31, 2 ** 31 - 1)
    maxval = maxval.clamp(-2 ** 31, 2 ** 31 - 1)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span     # uint32 product: wraps
    off = ((hi % span) * mult) & MASK32
    off = ((off + lo % span) & MASK32) % span
    out = (minval + off) & MASK32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled to [minval, maxval).

    XLA contracts ``floats * (hi - lo) + lo`` into one fused multiply-add;
    the product of two float32 values is exact in float64, so the scaling
    is done there and rounded to float32 once."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    floats = f.view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential(key, shape)`` in float32: ``-log1p(-u)``
    for ``u = uniform(key, shape)``.  The uniforms are bitwise equal to
    JAX's; the result is not, since ``log1p`` is rounded differently (up to
    2 ulp apart)."""
    return -torch.log1p(-uniform(key, shape))


# XLA's float32 erf_inv (Giles' single-precision approximation), which
# ``jax.random.normal`` calls; torch.erfinv is rounded more tightly and
# lands hundreds of ulp away from it near 0
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = torch.where(lt, torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32)) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: ``sqrt(2) erfinv(u)``
    for ``u`` uniform in (-1, 1), through XLA's float32 ``erf_inv``.  The
    uniforms are bitwise equal to JAX's; the result is only ulp-close, as
    ``log1p`` and fused multiply-adds round differently."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * _erfinv_f32(u)
