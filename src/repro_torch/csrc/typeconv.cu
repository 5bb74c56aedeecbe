// Standalone Algorithm-1 conversion kernel: int32 [n] -> float32 [n].
// Replaces int_to_f32_pallas (src/repro/kernels/typeconv/kernel.py:75).
// Elementwise over a flat array, grid-stride; the arithmetic lives in
// typeconv.cuh so the integer LUT-GEMV inlines exactly the same code.
// Bound: bytes (8 per element) for small n; for n above about 10 the
// n^2/2 + 13(n-1) logic ops per element outweigh them.
#include <cuda_runtime.h>

#include <cstdint>

#include "typeconv.cuh"

namespace {

__global__ void int_to_f32_kernel(const int32_t* __restrict__ a, float* __restrict__ out,
                                  long long count, int nbits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    out[i] = sail_int_to_f32(a[i], nbits);
  }
}

}  // namespace

extern "C" int repro_int_to_f32(const void* a, void* out, long long count, int nbits,
                                void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  int_to_f32_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<float*>(out), count, nbits);
  return static_cast<int>(cudaGetLastError());
}
