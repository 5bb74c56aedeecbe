// Standalone Algorithm-1 conversion kernel: int32 [count] -> float32 [count].
// Replaces int_to_f32_pallas (src/repro/kernels/typeconv/kernel.py:75), which
// converts [R, 128]-padded blocks of 8 rows; here the array is flat and
// needs no padding.  The arithmetic lives in typeconv.cuh, so the integer
// LUT-GEMV inlines exactly the same code.
//
// Bound: 8 bytes per element at 3.35 TB/s, or the conversion's integer
// instructions at Hopper's 64 per SM per clock, whichever is larger
// (chip_smoke.py counts them per element in this file's SASS).  With n a
// template parameter the bit-parallel form takes ~30 at n = 8, so the
// bytes bound it there, and the kernel is built to stream:
//   - one instantiation per n in 2..25 (the wrapper's range), chosen once
//     per call, so every loop and mask of typeconv.cuh folds;
//   - each thread loads 16-byte int4 words and stores float4 words with
//     streaming (evict-first) hints, UNROLL of them per loop iteration,
//     so UNROLL * 16 bytes per thread are in flight;
//   - the grid comes from the wrapper: one vector per thread, at most the
//     blocks the card holds at once (its SM count times this kernel's
//     occupancy, both from the runtime); beyond that each thread loops;
//   - a scalar head (until `a` reaches a 16-byte boundary) and tail (the
//     last count % 4 elements).  The wrapper allocates `out` with a's
//     alignment modulo 16, so one head aligns both.
// Indices are 32-bit vector counts (the entry point refuses more than
// 2^34 - 2^28 elements, which no 80 GB card holds with its output).
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "typeconv.cuh"

namespace {

constexpr int THREADS = 256;  // kernels/typeconv/kernel.py: THREADS
constexpr int UNROLL = 4;     // 16-byte vectors per thread per iteration
constexpr int MIN_N = 2;      // kernels/typeconv/kernel.py: MIN_N, MAX_N
constexpr int MAX_N = 25;

template <int N>
__device__ __forceinline__ float4 convert4(int4 v) {
  return make_float4(sail_int_to_f32<N>(v.x), sail_int_to_f32<N>(v.y), sail_int_to_f32<N>(v.z),
                     sail_int_to_f32<N>(v.w));
}

template <int N>
__global__ void __launch_bounds__(THREADS)
    int_to_f32_kernel(const int32_t* __restrict__ a, float* __restrict__ out, long long count) {
  const uint32_t tid = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t nthreads = gridDim.x * THREADS;
  // elements before `a` (and so `out`) reach a 16-byte boundary
  const uint32_t skip = ((16u - (reinterpret_cast<uintptr_t>(a) & 15u)) & 15u) >> 2;
  const uint32_t head = count < skip ? static_cast<uint32_t>(count) : skip;
  const uint32_t vecs = static_cast<uint32_t>((count - head) >> 2);
  const long long tail = head + 4LL * vecs;
  if (tid < head) out[tid] = sail_int_to_f32<N>(a[tid]);
  if (tid < count - tail) out[tail + tid] = sail_int_to_f32<N>(a[tail + tid]);

  const int4* av = reinterpret_cast<const int4*>(a + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  uint32_t i = tid;
  // full iterations: UNROLL vectors, nthreads apart, all in range
  for (; i + (UNROLL - 1) * nthreads < vecs; i += UNROLL * nthreads) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(av + i + u * nthreads);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) __stcs(ov + i + u * nthreads, convert4<N>(v[u]));
  }
  for (; i < vecs; i += nthreads) __stcs(ov + i, convert4<N>(__ldcs(av + i)));
}

using Kernel = void (*)(const int32_t*, float*, long long);

template <int... I>
Kernel kernel_for(int nbits, std::integer_sequence<int, I...>) {
  static const Kernel table[] = {&int_to_f32_kernel<MIN_N + I>...};
  return nbits >= MIN_N && nbits <= MAX_N ? table[nbits - MIN_N] : nullptr;
}

Kernel kernel_for(int nbits) {
  return kernel_for(nbits, std::make_integer_sequence<int, MAX_N - MIN_N + 1>{});
}

}  // namespace

// Blocks of the n = nbits instance one SM holds at once, or -(CUDA error).
extern "C" int repro_int_to_f32_occupancy(int nbits) {
  const Kernel fn = kernel_for(nbits);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// out[i] = Algorithm 1 (n = nbits) of a[i] for i < count, on `blocks`
// blocks of THREADS.  `a` and `out` must agree modulo 16 bytes.
extern "C" int repro_int_to_f32(const void* a, void* out, long long count, int nbits, int blocks,
                                void* stream) {
  const Kernel fn = kernel_for(nbits);
  if (fn == nullptr || blocks < 1 || count > (1LL << 34) - (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(out)) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (count <= 0) return 0;
  const int32_t* ap = static_cast<const int32_t*>(a);
  float* op = static_cast<float*>(out);
  void* args[] = {&ap, &op, &count};
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks),
                                         dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
