// SAIL Algorithm 1 as a CUDA device function: n-bit signed int -> IEEE-754
// float32 with shifts, and / or / xor, integer add and multiply and one
// bitcast, never a conversion instruction.  Replaces int_to_f32_compute
// (src/repro/kernels/typeconv/kernel.py:23); shared by the standalone
// typeconv kernel and the integer-activation LUT-GEMV, which builds its
// activation code table with it.
//
// n is a template parameter, so every width below is a compile-time
// constant, and each of Algorithm 1's steps takes its bit-parallel form
// (the plain PyTorch version, core/typeconv.py, keeps the line-by-line
// loops):
//   lines 2-4   leading-one mask C (ones from bit 0 up to |a|'s leading
//               one) by an OR-smear: log2(n) shift-or steps instead of n;
//   lines 5-11  popcount(C), the exponent, by a SWAR sum of bit fields
//               whose masks are cut to n-1 bits;
//   lines 16-17 C+1 = 2^p is one-hot, so its n-bit reverse is
//               2^(n-1-p): one shift, and |a| times it aligns the
//               mantissa.
// About 30 integer instructions per element at n = 8 where the
// line-by-line form takes the paper's n^2/2 + 13(n-1) = 123; chip_smoke.py
// counts them in the SASS and checks it for I2F, FLO, POPC and BREV, which
// would do the conversion without Algorithm 1.
//
// No integer division or modulo by a runtime value may appear in a kernel
// that includes this header: nvcc lowers those through a float reciprocal
// (I2F), and chip_smoke.py checks the SASS for I2F.
#pragma once

#include <cstdint>

// popcount of a word whose set bits lie in its low W bits
template <int W>
__device__ __forceinline__ uint32_t sail_popc(uint32_t c) {
  static_assert(W >= 1 && W <= 24, "Algorithm 1 counts at most 24 bits");
  constexpr uint32_t low = (1u << W) - 1u;
  if constexpr (W == 1) {
    return c;
  } else {
    uint32_t x = c - ((c >> 1) & (0x55555555u & low));              // 2-bit fields
    if constexpr (W > 2) x = (x & (0x33333333u & low)) + ((x >> 2) & (0x33333333u & low));
    if constexpr (W > 4) x = (x + (x >> 4)) & (0x0f0f0f0fu & low);  // 8-bit fields
    if constexpr (W > 8) x += x >> 8;
    if constexpr (W > 16) x += x >> 16;
    return W > 8 ? x & 0xffu : x;
  }
}

template <int N>
__device__ __forceinline__ float sail_int_to_f32(int32_t a) {
  static_assert(N >= 2 && N <= 25, "Algorithm 1 requires 2 <= n <= 25");
  constexpr int NM1 = N - 1;
  const uint32_t s = static_cast<uint32_t>(a >> 31);  // all ones for a < 0
  const uint32_t sign = s & 1u;
  const uint32_t mag = (static_cast<uint32_t>(a) ^ s) - s;

  // lines 2-4: C = mag smeared down from its leading one
  uint32_t c = mag;
#pragma unroll
  for (int k = 1; k < NM1; k <<= 1) c |= c >> k;

  // lines 5-11: the exponent, popcount(C) biased by 126
  const uint32_t popc = sail_popc<NM1>(c);
  const uint32_t biased = popc + 126u;

  // lines 16-17: rev = n-bit reverse of C+1 = 2^popc; align
  const uint32_t rev = 1u << (NM1 - popc);
  const uint32_t aligned = (mag * rev) & ((1u << NM1) - 1u);

  // lines 12-15 / 18-20: assemble sign | exponent | mantissa
  uint32_t r = (sign << 31) | (biased << 23);
  if constexpr (NM1 >= 2) {
    const uint32_t mant = aligned & ((1u << (NM1 - 1)) - 1u);
    r |= mant << (23 - (NM1 - 1));
  }
  if (mag == 0u) r = 0u;
  return __uint_as_float(r);
}
