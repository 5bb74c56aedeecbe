// SAIL Algorithm 1 as a CUDA device function: n-bit signed int -> IEEE-754
// float32 with shift / and / or / xor / integer multiply and one bitcast,
// never a conversion instruction.  Replaces int_to_f32_compute
// (src/repro/kernels/typeconv/kernel.py:23) line by line; shared by the
// standalone typeconv kernel and the integer-activation LUT-GEMV, which
// widens its activation codes with it.
//
// Cost: about n^2/2 + 13(n-1) integer operations per element (the paper's
// logic-op count).  Inlined with a compile-time n (the LUT-GEMV's abits) the
// loops unroll completely.
//
// No integer division or modulo by a runtime value may appear in a kernel
// that includes this header: nvcc lowers those through a float reciprocal
// (I2F), and chip_smoke.py checks the SASS for I2F.
#pragma once

#include <cstdint>

__device__ __forceinline__ float sail_int_to_f32(int32_t a, int n) {
  const uint32_t sign = static_cast<uint32_t>(a >> 31) & 1u;
  const uint32_t mag = sign ? static_cast<uint32_t>(-a) : static_cast<uint32_t>(a);
  const int nm1 = n - 1;

  // lines 2-4: leading-one detection via cumulative OR
  uint32_t d = 0u, c = 0u;
  for (int i = nm1 - 1; i >= 0; --i) {
    d |= (mag >> i) & 1u;
    c |= d << i;
  }

  // lines 5-11: popcount(C) via a 5-bit ripple counter
  uint32_t s[5] = {0u, 0u, 0u, 0u, 0u};
  for (int i = 0; i < nm1; ++i) {
    uint32_t carry = (c >> i) & 1u;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t c1 = s[j] & carry;
      s[j] ^= carry;
      carry = c1;
    }
  }
  const uint32_t popc = s[0] | (s[1] << 1) | (s[2] << 2) | (s[3] << 3) | (s[4] << 4);
  const uint32_t biased = popc + 126u;

  // lines 16-17: n-bit reverse of C+1 = 2^k (k = leading zeros); align
  const uint32_t cp1 = c + 1u;
  uint32_t rev = 0u;
  for (int i = 0; i < n; ++i) rev |= ((cp1 >> i) & 1u) << (n - 1 - i);
  const uint32_t aligned = (mag * rev) & ((1u << nm1) - 1u);

  // lines 12-15 / 18-20: assemble sign | exponent | mantissa
  uint32_t r = (sign << 31) | (biased << 23);
  if (nm1 >= 2) {
    const uint32_t mant = aligned & ((1u << (nm1 - 1)) - 1u);
    r |= mant << (23 - (nm1 - 1));
  }
  if (mag == 0u) r = 0u;
  return __uint_as_float(r);
}
