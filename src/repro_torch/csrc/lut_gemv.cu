// LUT-GEMV for Hopper: y[M, N] = x[M, K] @ (codebook[unpack(packed)] * scale_g),
// f32 accumulation.  Replaces lut_matmul_pallas
// (src/repro/kernels/lut_gemv/kernel.py:138) and, with ABITS > 0,
// lut_matmul_int_pallas (kernel.py:174): x arrives as abits-bit integer codes,
// widened in-kernel by Algorithm 1 (typeconv.cuh) with no conversion
// instruction, and the per-token scale multiplies once at the store
// (kernel.py:118-123).
//
// Bound: at decode M is the batch of slots (8) and every packed word is read
// once, so the kernel is a weight stream: bytes packed + scales + x + y.  At
// b = 4 its 2*M*K*N f32 operations (16 per 4-bit weight) outweigh those bytes
// at the card's rates (67 TFLOP/s vs 3.35 TB/s), so FMA throughput bounds it
// first and bytes close behind.
//
// Design (simple first; wgmma, TMA and split-K across blocks come later):
//   * a block owns COLS = 32 output columns (one per lane) and MT = 8 rows of x;
//     its KSPLIT = 4 warps take every 4th quantization group and are summed in
//     shared memory at the end, so narrow matrices (N = 256) still fill SMs;
//   * packed is [(K/G)*wpg, N], so neighbouring lanes read neighbouring words:
//     every load instruction of a warp is one coalesced 128-byte line;
//   * the 2^b-entry codebook sits in shared memory; each warp stages its
//     group's x slice [MT, G] in shared memory (widened there on the int path);
//   * codes are decoded from a 64-bit bit buffer refilled one word at a time,
//     so 3-, 5- and 6-bit codes that straddle two words need no special case;
//   * the ragged N and M edges are masked in the kernel.
// No integer division or modulo by a runtime value appears in the kernel
// (see typeconv.cuh): all group counts and strides come from the host.
#include <cuda_runtime.h>

#include <cstdint>

#include "typeconv.cuh"

namespace {

constexpr int MT = 8;
constexpr int COLS = 32;
constexpr int KSPLIT = 4;
constexpr int THREADS = COLS * KSPLIT;

template <int BITS, int ABITS>
__global__ void __launch_bounds__(THREADS)
    lut_matmul_kernel(const float* __restrict__ x, const int32_t* __restrict__ xq,
                      const float* __restrict__ xscale, const uint32_t* __restrict__ packed,
                      const float* __restrict__ scales, const float* __restrict__ codebook,
                      float* __restrict__ y, int M, int K, int N, int G, int ngroups, int wpg) {
  extern __shared__ float smem[];
  float* cb = smem;                                // [1 << BITS]
  float* xs_all = cb + (1 << BITS);                // [KSPLIT][MT][G]
  float* red = xs_all + KSPLIT * MT * G;           // [KSPLIT][MT][COLS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * COLS + lane;
  const int m0 = blockIdx.y * MT;
  float* xs = xs_all + warp * MT * G;

  for (int i = threadIdx.x; i < (1 << BITS); i += THREADS) cb[i] = codebook[i];
  __syncthreads();

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  for (int g = warp; g < ngroups; g += KSPLIT) {
    const long long col0 = static_cast<long long>(g) * G;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int m = m0 + r;
      for (int v = lane; v < G; v += 32) {
        float val = 0.f;
        if (m < M) {
          const long long idx = static_cast<long long>(m) * K + col0 + v;
          if constexpr (ABITS > 0) {
            val = sail_int_to_f32(xq[idx], ABITS);
          } else {
            val = x[idx];
          }
        }
        xs[r * G + v] = val;
      }
    }
    __syncwarp();
    if (n < N) {
      const float s = scales[static_cast<long long>(g) * N + n];
      const uint32_t* wp = packed + static_cast<long long>(g) * wpg * N + n;
      unsigned long long buf = 0ull;
      int have = 0;
      int w = 0;
      for (int v = 0; v < G; ++v) {
        if (have < BITS) {
          buf |= static_cast<unsigned long long>(wp[static_cast<long long>(w) * N]) << have;
          have += 32;
          ++w;
        }
        const uint32_t code = static_cast<uint32_t>(buf) & ((1u << BITS) - 1u);
        buf >>= BITS;
        have -= BITS;
        const float wv = cb[code] * s;
#pragma unroll
        for (int r = 0; r < MT; ++r) acc[r] = fmaf(xs[r * G + v], wv, acc[r]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < MT; ++r) red[(warp * MT + r) * COLS + lane] = acc[r];
  __syncthreads();
  // thread (warp, lane) stores rows warp, warp + KSPLIT, ... of column n
  if (n < N) {
    for (int r = warp; r < MT; r += KSPLIT) {
      const int m = m0 + r;
      if (m >= M) break;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < KSPLIT; ++k) sum += red[(k * MT + r) * COLS + lane];
      if constexpr (ABITS > 0) sum *= xscale[m];
      y[static_cast<long long>(m) * N + n] = sum;
    }
  }
}

template <int BITS, int ABITS>
int launch(const void* x, const void* xq, const void* xscale, const void* packed,
           const void* scales, const void* codebook, void* y, int M, int K, int N, int G,
           int wpg, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT);
  const size_t shmem = sizeof(float) * ((1 << BITS) + KSPLIT * MT * G + KSPLIT * MT * COLS);
  lut_matmul_kernel<BITS, ABITS><<<grid, THREADS, shmem, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(xq),
      static_cast<const float*>(xscale), static_cast<const uint32_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(codebook),
      static_cast<float*>(y), M, K, N, G, K / G, wpg);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_abits(const void* x, const void* xq, const void* xscale, const void* packed,
                 const void* scales, const void* codebook, void* y, int M, int K, int N, int G,
                 int wpg, int abits, cudaStream_t stream) {
  switch (abits) {
    case 0: return launch<BITS, 0>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, stream);
    case 4: return launch<BITS, 4>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, stream);
    case 6: return launch<BITS, 6>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, stream);
    case 8: return launch<BITS, 8>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// abits == 0: f32 activations in x (xq, xscale unused).
// abits in {4, 6, 8}: int32 codes in xq, per-row scales xscale [M] (x unused).
// Requires K % G == 0, G <= 256, wpg == ceil(bits * G / 32); the Python wrapper
// checks shapes, types and contiguity before calling.
extern "C" int repro_lut_matmul(const void* x, const void* xq, const void* xscale,
                                const void* packed, const void* scales, const void* codebook,
                                void* y, int M, int K, int N, int G, int wpg, int bits,
                                int abits, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_abits<1>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 2: return launch_abits<2>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 3: return launch_abits<3>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 4: return launch_abits<4>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 5: return launch_abits<5>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 6: return launch_abits<6>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    case 8: return launch_abits<8>(x, xq, xscale, packed, scales, codebook, y, M, K, N, G, wpg, abits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
