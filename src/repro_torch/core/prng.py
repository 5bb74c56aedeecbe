"""The reference's integer draws, reproduced in numpy.

The reference draws its calibration tokens (``sensitivity.calibration_tokens``)
and its calibration grid's codes (``calibrate_cost.run_calibration``) with
``jax.random.randint(jax.random.PRNGKey(seed), ...)``.  A numpy or torch
draw would give other tokens, and every plan solved on them another
allocation, so this module computes the same bits: the Threefry-2x32 block
cipher (20 rounds), the key split and the random bits of jax's
``jax_threefry_partitionable`` mode (the default), and ``randint``'s
two-word modular reduction.  All arithmetic is uint32 and wraps.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    seed = int(seed)
    return ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The flat row-major index 0..n-1 as (high, low) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split(key: Tuple[int, int], num: int = 2) -> Sequence[Tuple[int, int]]:
    """``jax.random.split(key, num)``: key i is Threefry of counter i."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(key, hi, lo)
    return [(int(b0[i]), int(b1[i])) for i in range(num)]


def random_bits(key: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element: the two Threefry words of the element's
    flat index, xored."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def randint(seed: int, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(jax.random.PRNGKey(seed), shape, minval,
    maxval)`` as int32: the high and low draws reduced modulo the span,
    combined through 2**32 mod span."""
    shape = tuple(int(d) for d in shape)
    k1, k2 = split(prng_key(seed))
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(max(int(maxval) - int(minval), 1) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = _U32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
        return (np.int32(minval) + off.view(np.int32)).astype(np.int32)
