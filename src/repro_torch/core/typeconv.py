"""In-memory parallel type conversion, SAIL Algorithm 1 (port of
``repro.core.typeconv``).

Converts n-bit signed integers (n <= 25) to IEEE-754 float32 with logic
operations only — cumulative OR for leading-one detection, a 5-bit
ripple popcount for the exponent, a bit-reversed multiply for mantissa
alignment — line by line as the reference does, vectorised across the
tensor.  Bit-equal to ``a.float()`` for |a| < 2**(n-1).  Unsigned 32-bit
words are emulated on int64 tensors (PyTorch on the CPU has no shifts on
``torch.uint32``); every value stays below 2**48, so no step wraps.

Also exported: the paper's op/cycle formulas used by the cost model.
"""
from __future__ import annotations

import torch


def logic_ops(n: int) -> float:
    """O(n^2/2 + 13(n-1)) logical operations (paper Sec. III-E)."""
    return n * n / 2.0 + 13.0 * (n - 1)


def sram_cycles(n: int) -> float:
    """(3n^2/2 + 39(n-1)) in-SRAM cycles (paper Sec. III-E)."""
    return 1.5 * n * n + 39.0 * (n - 1)


def int_to_f32(a: torch.Tensor, n: int = 25) -> torch.Tensor:
    """Algorithm 1: n-bit signed int -> float32, bitwise ops only.

    a: integer tensor with |a| < 2**(n-1), 2 <= n <= 25.  Returns a float32
    tensor bit-equal to ``a.float()``.
    """
    if not 2 <= n <= 25:
        raise ValueError("Algorithm 1 requires 2 <= n <= 25")
    a = a.to(torch.int32).to(torch.int64)
    sign = (a < 0).to(torch.int64)                    # a_{n-1} (sign bit)
    mag = torch.where(sign == 1, -a, a)

    nm1 = n - 1
    # lines 2-4: leading-one detection via cumulative OR
    d = torch.zeros_like(mag)
    c = torch.zeros_like(mag)
    for i in range(nm1 - 1, -1, -1):
        ai = (mag >> i) & 1
        d = d | ai
        c = c | (d << i)

    # lines 5-11: popcount(C) via 5-bit ripple counter
    s = [torch.zeros_like(mag) for _ in range(5)]
    for i in range(nm1):
        carry = (c >> i) & 1
        for j in range(5):
            c1 = s[j] & carry
            s[j] = s[j] ^ carry
            carry = c1
    popc = s[0] | (s[1] << 1) | (s[2] << 2) | (s[3] << 3) | (s[4] << 4)
    biased_exp = popc + 126                           # line 11

    # lines 16-17: n-bit reverse of C+1 = 2^k (k = leading zeros); align
    cp1 = c + 1
    rev = torch.zeros_like(mag)
    for i in range(n):
        rev = rev | (((cp1 >> i) & 1) << (n - 1 - i))
    aligned = (mag * rev) & ((1 << nm1) - 1)

    # lines 12-15 / 18-20: assemble R
    r = (sign << 31) | (biased_exp << 23)
    if nm1 >= 2:
        mant = aligned & ((1 << (nm1 - 1)) - 1)       # drop the hidden 1
        r = r | (mant << (23 - (nm1 - 1)))
    r = torch.where(mag == 0, torch.zeros_like(r), r)
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)
    return r.view(torch.float32)


def f32_to_int(x: torch.Tensor, n: int = 25) -> torch.Tensor:
    """The other direction (paper footnote): round half to even, clip to
    n bits."""
    lim = (1 << (n - 1)) - 1
    return torch.clamp(torch.round(x), -lim - 1, lim).to(torch.int32)
