"""A numpy twin of the reference's random bits: JAX's default PRNG.

The reference draws its synthetic data from ``jax.random`` with the
default implementation, ``threefry2x32``, and
``jax_threefry_partitionable`` on (the default since jax 0.5, and the
setting of jax 0.9.0).  This module reproduces those bits in numpy so that
the port's data for a ``(seed, step)`` is the reference's:

* :func:`threefry2x32` — the Threefry-2x32 hash (20 rounds, key schedule
  with the 0x1BD11BDA parity word), elementwise over uint32 arrays;
* :func:`PRNGKey` — ``[0, seed mod 2**32]``: with 64-bit types off, JAX
  narrows the seed to 32 bits, whose high word is then 0;
* :func:`fold_in` — the hash of the counter pair ``(0, data)`` under the key;
* :func:`split` — the partitionable split: key ``i`` is the hash of the
  64-bit counter ``i`` as ``(hi, lo)`` words;
* :func:`random_bits` — the partitionable bits: element ``i`` (row-major)
  is the XOR of the two words of the hash of counter ``i``;
* :func:`uniform`, :func:`normal_uniforms`, :func:`randint` — the float32
  and int32 samplers of ``jax.random`` on those bits.

Uniforms and integers are bit-exact.  A normal is
``sqrt(2) * erfinv(u)`` of a uniform ``u`` on ``(-1, 1)``: the uniforms
are exact, and :func:`normal` takes ``erfinv`` from ``torch.erfinv`` in
float32, which rounds differently from XLA's polynomial, so normals are
held to a tolerance (``tests/test_torch_data.py`` states it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays of
    one shape) under ``key`` (two uint32 words)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.array(x0, dtype=_U32, ndmin=1)
    x1 = np.array(x1, dtype=_U32, ndmin=1)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - the reference's name
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    return np.array([0, int(seed) % (1 << 32)], dtype=_U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(key, [0], [int(data) % (1 << 32)])
    return np.array([b0[0], b1[0]], dtype=_U32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit counters 0..n-1 as (hi, lo) uint32 words."""
    c = np.arange(n, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(_U32), (c & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit words)."""
    shape = tuple(shape)
    b0, b1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a number in [1, 2), less 1, scaled to ``[minval, maxval)``."""
    f32 = np.float32
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal_uniforms(key, shape) -> np.ndarray:
    """The uniforms on (-1, 1) behind ``jax.random.normal`` (float32,
    bit-exact): the normal is ``sqrt(2) * erfinv`` of these."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    return uniform(key, shape, lo, 1.0)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32 (within a tolerance: see the
    module docstring)."""
    u = torch.from_numpy(normal_uniforms(key, shape))
    return (np.float32(np.sqrt(2)) * torch.erfinv(u).numpy()).astype(np.float32)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` into int32: two draws of 32 bits, combined
    modulo the span as the reference does (uint32 arithmetic, wrapping)."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(max(int(maxval) - int(minval), 1))
    with np.errstate(over="ignore"):
        mult = _U32((1 << 16) % int(span))
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
