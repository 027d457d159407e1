"""JAX's default PRNG, in numpy: the draw of the basis' mixing matrix.

``make_basis`` draws ``mix = I + mix_scale * normal(PRNGKey(mix_seed), (J,
J))``.  This module computes that normal as jax 0.9 does on the CPU, with
``uint32`` and ``float32`` arithmetic and no JAX:

* the key of a seed: its high and low 32 bits;
* the bits: ``threefry2x32`` (20 rounds) of the key over the 64-bit iota of
  the shape, split in two 32-bit words (``jax_threefry_partitionable``, the
  default), the two output words XORed;
* the uniform on (-1, 1): the top 23 bits as the mantissa of a float in
  [1, 2), minus 1, scaled and shifted, clamped below at the first float
  above -1;
* the normal: ``sqrt(2) * erfinv(u)``, erfinv as XLA expands it (Giles'
  single-precision polynomial in ``w = -log1p(-u^2)``), in float32 with the
  products and sums contracted into fused multiply-adds, as XLA compiles
  them on the CPU.

The integer bits and the uniform are exact.  ``log1p`` is the correctly
rounded float32 value (from double precision); XLA's own log1p differs from
it by an ulp now and then, so a normal may differ from JAX's by a few ulps
(tests/test_torch_basis_build.py measures it).
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# erfinv's coefficients, highest power first (XLA's ErfInv32, w < 5 and w
# >= 5).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

_F32 = np.float32


def key(seed: int) -> tuple:
    """``PRNGKey(seed)``: (high 32 bits, low 32 bits) of the seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k, x0, x1):
    """Threefry-2x32 with 20 rounds of the counters (x0, x1) (uint32 arrays)
    under the key k = (k0, k1)."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(k, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(k, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(k, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    bits = random_bits(k, shape)
    one = np.array(1.0, _F32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(_F32) - _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in double)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _log1p(x):
    return np.array([math.log1p(float(v)) for v in np.ravel(x)],
                    np.float64).astype(_F32).reshape(np.shape(x))


def erfinv(x) -> np.ndarray:
    """XLA's float32 erfinv: Horner's rule in w = -log1p(-x^2) (w - 2.5
    below 5, sqrt(w) - 3 above), times x; +-inf at +-1."""
    x = np.asarray(x, _F32)
    w = -_log1p(x * -x)
    lt = w < _F32(5.0)
    arg = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, arg, np.where(lt, _F32(a), _F32(b)))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf),
                        p * x).astype(_F32)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape, float32)``."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    u = uniform(key(seed), shape, lo, 1.0)
    return (_F32(np.sqrt(2)) * erfinv(u)).astype(_F32)
