"""The draws of ``jax.random`` that ``nrs_init`` needs, in numpy.

The JAX package initializes the NRS weights from ``jax.random.PRNGKey(seed)``
(threefry2x32), so the port computes the same stream: the threefry2x32 hash
(20 rounds, key schedule with the 0x1BD11BDA parity word), ``split`` and the
random bits of JAX's partitionable mode (the hash of the 64-bit element
index, its two words xor-ed), the uniform mantissa fill on [nextafter(-1, 0),
1), and XLA's float32 ``erf_inv`` (Giles' single-precision polynomial, its
multiply-adds fused as XLA's CPU backend fuses them) for ``normal``. The
keys are bit-equal to ``jax.random``'s; the normals equal
``jax.random.normal``'s but for about 1.5% of them, up to 3 float32 ulps
away: XLA's own float32 ``log1p`` is not reproduced (its correctly rounded
value is used).
"""

from __future__ import annotations

import numpy as np

_PARITY = np.uint32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf_inv's polynomial in w = -log1p(-x^2), for w < 5 and w >= 5.
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)
_F32 = np.float32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x1: np.ndarray, x2: np.ndarray):
    """The threefry2x32 hash of the counter words (x1, x2) under ``key``,
    a (hi, lo) pair of uint32."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def _hash_iota(key, n: int):
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(key, num: int = 2):
    """``jax.random.split``: ``num`` new keys."""
    b1, b2 = _hash_iota(key, num)
    return [(b1[i], b2[i]) for i in range(num)]


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv (Giles), each multiply-add rounded once."""
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(_F32)
    small = w < _F32(5.0)
    w = np.where(small, w - _F32(2.5),
                 np.sqrt(w.astype(np.float64)).astype(_F32) - _F32(3.0))
    coeff = lambda i: np.where(small, _F32(_W_LT_5[i]), _F32(_W_GE_5[i]))
    p = coeff(0)
    for i in range(1, 9):
        p = (coeff(i).astype(np.float64)
             + p.astype(np.float64) * w.astype(np.float64)).astype(_F32)
    return p * x


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    n = int(np.prod(shape))
    b1, b2 = _hash_iota(key, n)
    mantissa = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mantissa.view(_F32) - _F32(1.0)
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    u = (floats.astype(np.float64) * np.float64(_F32(1.0) - lo)
         + np.float64(lo)).astype(_F32)
    u = np.maximum(lo, u)
    return (_F32(np.sqrt(2.0)) * _erf_inv32(u)).reshape(shape)
