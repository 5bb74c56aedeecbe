// Decode attention for Hopper: one query token per sequence over a KV cache
// [B, S, KV, D], int8 with per-position scales [B, S, KV, 1] or f32.
// Replaces decode_attention_pallas (src/repro/kernels/decode_attn/kernel.py:79)
// and, in ring mode, the jnp _decode_attend the reference decode step calls
// (src/repro/models/blocks.py:236, 438-462).
//
// Bound: device-memory bytes, the K and V cache (1 byte per element when
// int8) plus scales; the work is 4*H*S*D flops per sequence, far below the
// f32 ridge.
//
// Design (simple first): one block per (kv head, sequence) reads the group's
// G = H/KV queries once into shared memory and walks S in chunks of TB = 128
// positions, one position per thread for the scores, with a running
// (m, l, acc) online softmax in f32 — the TPU kernel's sequential S grid
// becomes this loop.  int8 K/V are dequantised in the kernel
// (code * scale, as the reference dequantises before its dot).  The G*D
// output accumulators are spread over the block's threads (<= 8 each), so
// small head widths (D = 8 or 32) need no special case.  NEG_INF = -1e30 and
// the final max(l, 1e-30) guard are kept (kernel.py:27, 73).
//
// Validity modes:
//   lengths (RING = false): slot i is valid iff i < len[b], and with a window
//     also i >= len[b] - window (kernel.py:48-52);
//   ring (RING = true): len[b] is the token's absolute position p; slot i
//     holds p - ((p % S - i) mod S) and is valid iff that is >= 0 and
//     > p - window (blocks.py:450-458).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TB = 128;     // positions per chunk == threads per block
constexpr int MAXP = 8;     // (g, d) accumulators per thread: G * D <= TB * MAXP
constexpr float NEG_INF = -1e30f;

template <bool QUANT>
__device__ __forceinline__ float load_kv(const void* base, const float* scale, long long idx,
                                         long long sidx) {
  if constexpr (QUANT) {
    return static_cast<float>(static_cast<const int8_t*>(base)[idx]) * scale[sidx];
  } else {
    return static_cast<const float*>(base)[idx];
  }
}

template <bool QUANT, bool RING>
__global__ void __launch_bounds__(TB)
    decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ kc,
                       const void* __restrict__ vc, const float* __restrict__ ksc,
                       const float* __restrict__ vsc, const int32_t* __restrict__ lens,
                       float* __restrict__ out, int H, int KV, int S, int D, int window,
                       float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARP = TB / 32;

  extern __shared__ float sm[];
  float* qs = sm;            // [G * D]
  float* sc = qs + GD;       // [G][TB] scores, then probabilities
  float* ms = sc + G * TB;   // [G] running max
  float* ls = ms + G;        // [G] running sum
  float* al = ls + G;        // [G] rescale of this chunk

  const long long qbase = (static_cast<long long>(b) * H + static_cast<long long>(h) * G) * D;
  for (int i = tid; i < GD; i += TB) qs[i] = q[qbase + i];
  for (int i = tid; i < G; i += TB) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  const int L = lens[b];
  float acc[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) acc[p] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += TB) {
    const int s = s0 + tid;
    bool valid = false;
    if (s < S) {
      if constexpr (RING) {
        const int age = ((L % S - s) % S + S) % S;
        const int held = L - age;
        valid = held >= 0 && held > L - window;
      } else {
        valid = s < L && (window <= 0 || s >= L - window);
      }
    }
    const long long rowk = ((static_cast<long long>(b) * S + s) * KV + h);
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
      if (s < S) {
        for (int d = 0; d < D; ++d) dot += qs[g * D + d] * load_kv<QUANT>(kc, ksc, rowk * D + d, rowk);
      }
      sc[g * TB + tid] = valid ? dot * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARP) {
      float mx = NEG_INF;
      for (int t = lane; t < TB; t += 32) mx = fmaxf(mx, sc[g * TB + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        const float mp = ms[g];
        const float mn = fmaxf(mp, mx);
        al[g] = expf(mp - mn);
        ms[g] = mn;
      }
    }
    __syncthreads();

    for (int g = 0; g < G; ++g) {
      sc[g * TB + tid] = valid ? expf(sc[g * TB + tid] - ms[g]) : 0.f;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARP) {
      float sum = 0.f;
      for (int t = lane; t < TB; t += 32) sum += sc[g * TB + t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) ls[g] = ls[g] * al[g] + sum;
    }

    const int tmax = min(TB, S - s0);
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      const int i = tid + p * TB;
      if (i < GD) {
        const int g = i / D;
        const int d = i - g * D;
        float a = acc[p] * al[g];
        for (int t = 0; t < tmax; ++t) {
          const long long rowv = (static_cast<long long>(b) * S + s0 + t) * KV + h;
          a += sc[g * TB + t] * load_kv<QUANT>(vc, vsc, rowv * D + d, rowv);
        }
        acc[p] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int i = tid + p * TB;
    if (i < GD) {
      const int g = i / D;
      out[qbase + i] = acc[p] / fmaxf(ls[g], 1e-30f);
    }
  }
}

template <bool QUANT, bool RING>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* lens, void* out, int B, int H, int KV, int S, int D, int window,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t shmem = sizeof(float) * (G * D + G * TB + 3 * G);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  decode_attn_kernel<QUANT, RING><<<dim3(KV, B), TB, shmem, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(lens),
      static_cast<float*>(out), H, KV, S, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32 [B, H, D]; k, v [B, S, KV, D] int8 (quantized != 0, scales
// [B, S, KV, 1] f32) or f32; lens int32 [B] (lengths, or positions when
// ring != 0); out f32 [B, H, D].  window <= 0 means none in lengths mode; in
// ring mode it is the effective window (the model's, else the ring size).
// Requires H % KV == 0, (H / KV) * D <= 1024 and a dynamic shared memory of
// at most 48 KB (the launch does not opt in to more); the wrapper checks.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lens, void* out, int B, int H, int KV,
                                      int S, int D, int window, int quantized, int ring,
                                      void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return ring ? launch<true, true>(q, k, v, k_scale, v_scale, lens, out, B, H, KV, S, D, window, st)
                : launch<true, false>(q, k, v, k_scale, v_scale, lens, out, B, H, KV, S, D, window, st);
  }
  return ring ? launch<false, true>(q, k, v, k_scale, v_scale, lens, out, B, H, KV, S, D, window, st)
              : launch<false, false>(q, k, v, k_scale, v_scale, lens, out, B, H, KV, S, D, window, st);
}
