"""The JAX package's random numbers in numpy: ``jax.random.PRNGKey``,
``split``, ``uniform`` and ``normal`` for float32, with the threefry-2x32
generator in its partitionable layout (``jax_threefry_partitionable``, the
default of the JAX version the package pins).

The port draws its own numbers from ``torch.Generator``s, which give other
values for the same seed. Where a run's outcome hangs on a handful of
draws (the initial decoders decide whether the kitti lap's tracker
follows the start from rest), ``models.decoder.init_decoders``
draws them here, so the port starts from the JAX package's decoders at
every seed. Keys and uniform draws equal JAX's bit for bit; normal draws go
through an ``erfinv`` in float64 where XLA evaluates a float32 polynomial,
and agree to a few float32 ulps.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (two uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode (the JAX package's
    setting): the seed as a 32-bit integer, so the key is (0, its low 32
    bits)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(key, *_counters(n))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), less 1, scaled to [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    # XLA fuses the scale and shift into one rounding (a fused
    # multiply-add): exact in float64, then rounded once
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u) with u uniform
    in (-1, 1)."""
    from scipy.special import erfinv

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u.astype(np.float64))).astype(
        np.float32)
