"""The reference's random draws, reproduced in numpy and in torch.

The reference draws its calibration tokens (``sensitivity.calibration_tokens``)
and its calibration grid's codes (``calibrate_cost.run_calibration``) with
``jax.random.randint(jax.random.PRNGKey(seed), ...)``, and its engine
samples each token at temperature T as ``jax.random.categorical(key,
row / T)`` under ``key = fold_in(fold_in(PRNGKey(seed), uid), index)``
(``_sample_rows_jit``).  Another generator would give other tokens, so this
module computes the same bits: the Threefry-2x32 block cipher (20 rounds),
``fold_in``, the key split and the random bits of jax's
``jax_threefry_partitionable`` mode (the default), ``randint``'s two-word
modular reduction, and ``uniform`` -> ``gumbel`` (mode ``"low"``, jax's
default) -> ``categorical``.  All arithmetic is uint32 and wraps.

The numpy functions are the plain version.  :func:`draw_rows` is the
engine's sampler: one draw covers every row of a ``[B, V]`` logits tensor on
its own device, Threefry in torch ``int32`` (torch has no uint32
arithmetic; int32 adds, xors and left shifts give the uint32 bit patterns,
and a logical right shift is an arithmetic one masked).  Its words and
uniforms are bit-equal to the numpy ones; its Gumbel noise is ``-log(-log
u)`` on the device's ``log``, within a few ulp of numpy's and XLA's.
The reference divides the row by T inside ``jit``, where XLA turns the
division by a constant into a multiplication by its f32 reciprocal; both
versions here multiply by that reciprocal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

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


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``: Threefry of the data's seed words
    (0, data) under ``key``."""
    b0, b1 = threefry2x32(key, np.zeros(1, _U32),
                          np.asarray([int(data) & 0xFFFFFFFF], _U32))
    return int(b0[0]), int(b1[0])


def _uniform_from_bits(bits: np.ndarray, minval: float,
                       maxval: float) -> np.ndarray:
    """jax's ``_uniform`` on 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval), clamped at
    minval; f32 throughout."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1)
    return np.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: Tuple[int, int], shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval)


TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: Tuple[int, int], shape) -> np.ndarray:
    """``jax.random.gumbel(key, shape, float32)`` in mode ``"low"``:
    ``-log(-log(u))``, u uniform on [tiny, 1)."""
    return -np.log(-np.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: Tuple[int, int], logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis:
    ``argmax(gumbel + logits)``."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=-1)


def row_keys(seed: int, uids, indices,
             salt: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Each row's sampling key ``fold_in(fold_in(PRNGKey(seed), uid),
    index)`` as two uint32 arrays [B]; with ``salt``, folded once more
    (``fold_in(key, salt)``: the speculative draws' streams)."""
    uids = np.asarray(uids, np.int64).astype(_U32)
    indices = np.asarray(indices, np.int64).astype(_U32)
    zeros = np.zeros_like(uids)
    k0, k1 = threefry2x32(prng_key(seed), zeros, uids)
    k0, k1 = threefry2x32((k0, k1), zeros, indices)
    if salt is None:
        return k0, k1
    return threefry2x32((k0, k1), zeros,
                        np.full_like(uids, int(salt) & 0xFFFFFFFF))


def reciprocal(temperature: float) -> float:
    """The f32 reciprocal of T that XLA multiplies by for ``row / T``."""
    return float(np.float32(1) / np.float32(temperature))


class Draw(NamedTuple):
    """One sampling draw over [B, V] logits: the 32-bit words (uint32 in
    numpy, their int32 bit patterns in torch), the uniforms on [tiny, 1),
    the Gumbel noise and the chosen token per row."""
    bits: object
    uniform: object
    gumbel: object
    tokens: object


def draw_rows_np(logits, uids, indices, seed: int,
                 temperature: float) -> Draw:
    """The plain version of :func:`draw_rows`, row by row in numpy:
    ``categorical(key_b, row_b / T)`` with ``key_b`` from :func:`row_keys`."""
    logits = np.asarray(logits, np.float32)
    b, v = logits.shape
    k0, k1 = row_keys(seed, uids, indices)
    bits = np.stack([random_bits((int(k0[i]), int(k1[i])), (v,))
                     for i in range(b)])
    u = _uniform_from_bits(bits, TINY, 1.0)
    g = -np.log(-np.log(u))
    scaled = logits * np.float32(reciprocal(temperature))
    return Draw(bits, u, g, np.argmax(g + scaled, axis=-1))


def _rotl_i32(v: torch.Tensor, r: int) -> torch.Tensor:
    return (v << r) | ((v >> (32 - r)) & ((1 << r) - 1))


def threefry2x32_torch(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int32 tensors holding uint32 bit patterns
    (keys and counters broadcast against each other)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)     # < 2**31: one int32
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl_i32(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def draw_rows(logits: torch.Tensor, uids, indices, seed: int,
              temperature: float) -> Draw:
    """One categorical draw per row of ``logits`` [B, V] at temperature T,
    on the logits' device: row b's key is ``fold_in(fold_in(PRNGKey(seed),
    uids[b]), indices[b])`` (computed on the host, 2 x B words), its V
    words are Threefry of the counters 0..V-1 under it, and its token is
    ``argmax(gumbel + row * (1/T))``."""
    k0, k1 = row_keys(seed, uids, indices)
    keys = torch.from_numpy(np.stack([k0, k1], 1).view(np.int32))
    return draw_with_keys(logits, keys.to(logits.device), temperature)


def draw_with_keys(logits: torch.Tensor, keys: torch.Tensor,
                   temperature: float) -> Draw:
    """The device part of :func:`draw_rows`, given the row keys [B, 2]
    (int32 bit patterns) on the logits' device."""
    dev = logits.device
    count = torch.arange(logits.shape[1], dtype=torch.int32,
                         device=dev)[None]
    b0, b1 = threefry2x32_torch(keys[:, :1], keys[:, 1:],
                                torch.zeros_like(count), count)
    bits = b0 ^ b1
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    # (1 - tiny) rounds to 1 in f32, so u = max(tiny, f * 1 + tiny); tiny
    # is an f32 value, exact as a scalar operand
    u = ((mant.view(torch.float32) - 1.0) + TINY).clamp_min(TINY)
    g = -torch.log(-torch.log(u))
    scaled = logits.to(torch.float32) * reciprocal(temperature)
    return Draw(bits, u, g, torch.argmax(g + scaled, dim=-1))
