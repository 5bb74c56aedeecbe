// LUT-GEMV for Hopper: y[M, N] = x[M, K] @ (codebook[unpack(packed)] * scale_g),
// f32 products summed in f32.  Replaces lut_matmul_pallas
// (src/repro/kernels/lut_gemv/kernel.py:138) and, with ABITS > 0,
// lut_matmul_int_pallas (kernel.py:174): x arrives as abits-bit integer codes,
// widened in-kernel by Algorithm 1 (typeconv.cuh) with no conversion
// instruction, and the per-token scale multiplies once at the store
// (kernel.py:118-123).
//
// Bound: at decode M is the batch of slots (8), so every packed word is read
// once and the kernel is a weight stream (packed codes + group scales).  At
// b = 4 its M*K*N fused multiply-adds (8 per 4-bit weight) outweigh those
// bytes at the card's rates (67 TFLOP/s f32 vs 3.35 TB/s), so FMA throughput
// bounds a decode step first and bytes close behind.  In practice a decode
// call is bound by latency: the first version waited on one 4-byte load per
// lane at a time in 8-32 blocks (41-140 us per call, H100 80GB HBM3, 700 W).
// This design takes 10.9-14.9 us per decode call and 30 us for lm_head
// (CUDA-graph replay, L2 flushed, 5.5 us of it the replay's own floor), and
// a decode step's 85 calls take 0.67 ms (f32) / 0.72 ms (int) as one graph,
// against 1.14 ms for torch.matmul on the dequantized weights (same card).
//
// Design:
//   * work is cut into slabs of 32 K-elements of one quantization group
//     (`bits` packed rows; a group of G holds ceil(G/32) slabs, the last one
//     partial when 32 does not divide G).  A block owns BN = 128 output
//     columns, MT = 8 rows of x and a contiguous range of slabs; the host
//     splits a tile's slabs across up to MAX_SPLITS blocks (blockIdx.y),
//     balanced to within one slab, so that a decode call fills the card;
//   * each of the block's 4 warps streams its own contiguous share of the
//     block's slabs through a private ring of NSTAGE shared-memory stages
//     with 4-byte cp.async (N may be odd, e.g. lm_head's 32005, so rows are
//     not 16-byte aligned): a stage holds the slab's packed words, its
//     group's scale row and its x slice [32][MT], so NSTAGE slabs of loads
//     are in flight per warp; ragged N, M and partial slabs are zero-filled
//     by the copy itself;
//   * a lane owns 4 adjacent columns: one 16-byte shared load per packed row
//     gives it 4 columns' words, and every x value it reads serves 4 columns;
//     codes are decoded with shifts fixed at compile time (the 32-element
//     slab unrolls completely, so 3-, 5- and 6-bit codes that straddle words
//     cost one extra shift and or) into byte offsets of a static shared
//     codebook;
//   * the group scale is hoisted: a slab accumulates sum x * codebook[code]
//     and multiplies by scale[g, n] once per (slab, row);
//   * on the int path the block first widens all 2^abits codes with
//     Algorithm 1 (sail_int_to_f32) into a shared table; each x element of
//     the block's slice is then widened once, in place in its stage, through
//     that table.  Widening each element by Algorithm 1 itself (~120 integer
//     operations at abits = 8, on the card's half-rate integer pipe) cost as
//     much as the FMAs it feeds;
//   * reduction, in a fixed order with no float atomics: the 4 warps' sums
//     meet in shared memory (warp 0 first); the splits of a tile form one
//     thread-block cluster, and block q sums the q-th chunk of the tile over
//     the cluster's blocks in split order, through distributed shared memory,
//     then multiplies by x_scale and stores.  No workspace, no second pass,
//     no global round trip; results are bit-identical from call to call.
// No integer division or modulo by a runtime value appears in the kernel
// (see typeconv.cuh): counts and strides come from the host, and the slab ->
// group map is a multiply by a host-computed reciprocal.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "typeconv.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MT = 8;           // rows of x per block
constexpr int BN = 128;         // output columns per block (4 per lane)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SLAB = 32;        // K-elements per slab
constexpr int NSTAGE = 4;       // ring depth per warp (a power of two)

// 32-bit words of one stage: packed rows [BITS][BN], scales [BN], x [SLAB][MT]
template <int BITS>
__host__ __device__ constexpr int stage_words() { return BITS * BN + BN + SLAB * MT; }

// dynamic shared memory: the warps' rings (the codebook is static)
template <int BITS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * WARPS * NSTAGE * stage_words<BITS>();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;   // 0 bytes read: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

struct Args {
  const float* x;          // [M, K] f32        (ABITS == 0)
  const int32_t* xq;       // [M, K] int codes  (ABITS > 0)
  const float* xscale;     // [M]               (ABITS > 0)
  const uint32_t* packed;  // [(K/G)*wpg, N]
  const float* scales;     // [K/G, N]
  const float* codebook;   // [2^BITS]
  float* y;                // [M, N]
  int M, K, N, G, wpg;
  int spg;                 // slabs per group, ceil(G / 32)
  unsigned long long magic;  // ceil(2^32 / spg): slab j is in group (j * magic) >> 32
  int splits, slab_base, slab_rem;   // split s holds slab_base + (s < slab_rem) slabs
  int chunk;               // outputs of a tile each split sums: ceil(MT * BN / splits)
};

// One lane's part of the copies, fixed for the whole block: its column
// bases, which of its 4 columns and 8 rows exist, and its x element.  Copies
// of words that do not exist (ragged N or M, the tail of a partial slab)
// read nothing: cp.async zero-fills them.
struct LaneCopy {
  const uint32_t* wcol;    // packed + n0 + lane
  const float* scol;       // scales + n0 + lane
  const uint32_t* xcol;    // x (or xq) + m0 * K + lane, as 32-bit words
  unsigned cols;           // bit q: column n0 + lane + 32q < N
  unsigned rows;           // bit r: row m0 + r < M
};

// Issue slab (g, c)'s copies into a stage: packed rows [BITS][BN], the
// group's scale row [BN] and the x slice [SLAB][MT] (transposed).
template <int BITS>
__device__ __forceinline__ void issue_slab(const Args& a, const LaneCopy& lc, uint32_t* st,
                                           int g, int c, int lane) {
  const int nw = min(BITS, a.wpg - c * BITS);            // words of this slab
  const uint32_t* wp = lc.wcol + (static_cast<long long>(g) * a.wpg + c * BITS) * a.N;
#pragma unroll
  for (int i = 0; i < BITS; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async4(st + i * BN + lane + 32 * q, wp + 32 * q, i < nw && (lc.cols >> q & 1u));
    wp += a.N;
  }
  const float* sp = lc.scol + static_cast<long long>(g) * a.N;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    cp_async4(st + BITS * BN + lane + 32 * q, sp + 32 * q, lc.cols >> q & 1u);
  const bool kin = c * SLAB + lane < a.G;
  const uint32_t* xp = lc.xcol + g * a.G + c * SLAB;
  uint32_t* xs = st + BITS * BN + BN + lane * MT;         // [SLAB][MT]
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    cp_async4(xs + r, xp, kin && (lc.rows >> r & 1u));
    xp += a.K;
  }
}

constexpr int MAX_SPLITS = 16;   // a tile's splits form one cluster (at most 16 blocks)

// y[m, n] = v (times the row's x_scale on the int path), rows past M dropped.
template <int ABITS>
__device__ __forceinline__ void store(const Args& a, int m, int n, float v) {
  if (m < a.M) {
    if constexpr (ABITS > 0) v *= a.xscale[m];
    a.y[static_cast<long long>(m) * a.N + n] = v;
  }
}

template <int BITS, int ABITS>
__global__ void __launch_bounds__(THREADS)
    lut_matmul_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float cb[1 << BITS];
  __shared__ float xlut[ABITS > 0 ? 1 << ABITS : 1];   // code + 2^(ABITS-1) -> f32
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);            // [WARPS][NSTAGE] stages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  uint32_t* my_ring = ring + warp * NSTAGE * stage_words<BITS>();

  // this block's slabs, then this warp's contiguous share of them
  const int nblk = a.slab_base + (split < a.slab_rem ? 1 : 0);
  const int blk0 = split * a.slab_base + min(split, a.slab_rem);
  const int wq = nblk >> 2, wr = nblk & 3;
  const int nsl = wq + (warp < wr ? 1 : 0);
  const int j0 = blk0 + warp * wq + min(warp, wr);
  int g = static_cast<int>((static_cast<unsigned long long>(j0) * a.magic) >> 32);
  int c = j0 - g * a.spg;

  LaneCopy lc;
  lc.wcol = a.packed + n0 + lane;
  lc.scol = a.scales + n0 + lane;
  lc.xcol = (ABITS > 0 ? reinterpret_cast<const uint32_t*>(a.xq)
                       : reinterpret_cast<const uint32_t*>(a.x)) +
            static_cast<long long>(m0) * a.K + lane;
  lc.cols = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) lc.cols |= (n0 + lane + 32 * q < a.N ? 1u : 0u) << q;
  lc.rows = 0u;
#pragma unroll
  for (int r = 0; r < MT; ++r) lc.rows |= (m0 + r < a.M ? 1u : 0u) << r;

  // prologue: the first NSTAGE slabs in flight (one commit group each)
#pragma unroll
  for (int p = 0; p < NSTAGE; ++p) {
    if (p < nsl) {
      issue_slab<BITS>(a, lc, my_ring + p * stage_words<BITS>(), g, c, lane);
      if (++c == a.spg) { c = 0; ++g; }
    }
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < (1 << BITS); i += THREADS) cb[i] = a.codebook[i];
  if constexpr (ABITS > 0) {
    // Algorithm 1 once per block for each of the 2^ABITS codes
    for (int i = threadIdx.x; i < (1 << ABITS); i += THREADS)
      xlut[i] = sail_int_to_f32<ABITS>(i - (1 << (ABITS - 1)));
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int i = 0; i < nsl; ++i) {
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();
    uint32_t* st = my_ring + (i & (NSTAGE - 1)) * stage_words<BITS>();
    float* xs = reinterpret_cast<float*>(st + BITS * BN + BN);
    if constexpr (ABITS > 0) {
      // widen this lane's x codes (element v = lane, all MT rows) in place
      // through the block's Algorithm-1 table
      constexpr int kHalf = 1 << (ABITS - 1), kCodes = (1 << ABITS) - 1;
      int4* mine = reinterpret_cast<int4*>(st + BITS * BN + BN + lane * MT);
#pragma unroll
      for (int h = 0; h < MT / 4; ++h) {
        const int4 q = mine[h];
        reinterpret_cast<float4*>(mine)[h] =
            make_float4(xlut[(q.x + kHalf) & kCodes], xlut[(q.y + kHalf) & kCodes],
                        xlut[(q.z + kHalf) & kCodes], xlut[(q.w + kHalf) & kCodes]);
      }
      __syncwarp();
    }

    uint32_t w[BITS][4];
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      const uint4 v4 = reinterpret_cast<const uint4*>(st + b * BN)[lane];
      w[b][0] = v4.x; w[b][1] = v4.y; w[b][2] = v4.z; w[b][3] = v4.w;
    }
    const float4 s4 = reinterpret_cast<const float4*>(st + BITS * BN)[lane];
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};

    float part[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[r][q] = 0.f;

#pragma unroll
    for (int v = 0; v < SLAB; ++v) {
      const float4 xa = reinterpret_cast<const float4*>(xs + v * MT)[0];
      const float4 xb = reinterpret_cast<const float4*>(xs + v * MT)[1];
      const float xv[MT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      constexpr unsigned kMask = (1u << BITS) - 1u;
      const int bit = v * BITS;
      const int lo = bit >> 5, sh = bit & 31;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t code = w[lo][q] >> sh;
        if (sh + BITS > 32) code |= w[lo + 1 < BITS ? lo + 1 : lo][q] << (32 - sh);
        const float wv = cb[code & kMask];   // static shared: [reg + imm] address
#pragma unroll
        for (int r = 0; r < MT; ++r) part[r][q] = fmaf(xv[r], wv, part[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(part[r][q], sc[q], acc[r][q]);

    __syncwarp();                     // every lane done with this stage
    if (i + NSTAGE < nsl) {
      issue_slab<BITS>(a, lc, st, g, c, lane);
      if (++c == a.spg) { c = 0; ++g; }
    }
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();                    // the rings are free: reuse them

  // the 4 warps' sums, in warp order, in shared memory [WARPS][MT][BN]
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < MT; ++r)
    reinterpret_cast<float4*>(red + (warp * MT + r) * BN)[lane] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  const int t = threadIdx.x;          // column n0 + t, all MT rows
  const int n = n0 + t;
  float sum[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    float s = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < WARPS; ++w2) s += red[(w2 * MT + r) * BN + t];
    sum[r] = s;
  }

  if (a.splits == 1) {
    if (n < a.N) {
#pragma unroll
      for (int r = 0; r < MT; ++r) store<ABITS>(a, m0 + r, n, sum[r]);
    }
    return;
  }
  // The splits of this tile form one thread-block cluster: every block puts
  // its sum in its shared memory, and block q sums the q-th chunk of the
  // tile over all of them, in split order, through distributed shared
  // memory.
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = red + WARPS * MT * BN;                 // [MT][BN]
#pragma unroll
  for (int r = 0; r < MT; ++r) mine[r * BN + t] = sum[r];
  cluster.sync();
  const int o0 = split * a.chunk;
  for (int j = t; j < a.chunk && o0 + j < MT * BN; j += THREADS) {
    const int o = o0 + j;
    float s = 0.f;
    for (int q = 0; q < a.splits; ++q) s += cluster.map_shared_rank(mine, q)[o];
    const int cn = n0 + (o & (BN - 1));
    if (cn < a.N) store<ABITS>(a, m0 + (o >> 7), cn, s);
  }
  cluster.sync();                     // keep this block's sum until all have read it
}

// One instance of the kernel: its shared memory, its attributes (set once)
// and its launch.
template <int BITS, int ABITS>
struct Instance {
  static constexpr size_t kSmem = smem_bytes<BITS>();

  static cudaError_t setup() {
    static const cudaError_t attr = [] {
      cudaError_t e = cudaFuncSetAttribute(lut_matmul_kernel<BITS, ABITS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem));
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lut_matmul_kernel<BITS, ABITS>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      return e;
    }();
    return attr;
  }

  // blocks of this instance one SM holds at once, or -(CUDA error)
  static int occupancy(int* smem, int* regs) {
    *smem = static_cast<int>(kSmem);
    int blocks = 0;
    cudaFuncAttributes attrs = {};
    cudaError_t e = setup();
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attrs, lut_matmul_kernel<BITS, ABITS>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lut_matmul_kernel<BITS, ABITS>,
                                                        THREADS, kSmem);
    *regs = attrs.numRegs;
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  }

  static int launch(const Args& a, cudaStream_t stream) {
    const cudaError_t attr = setup();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.N + BN - 1) / BN, a.splits, (a.M + MT - 1) / MT);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = a.splits;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, lut_matmul_kernel<BITS, ABITS>, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
};

// f(Instance<bits, abits>{}) for the instance the arguments name.
template <int BITS, typename F>
int with_abits(int abits, F&& f) {
  switch (abits) {
    case 0: return f(Instance<BITS, 0>{});
    case 4: return f(Instance<BITS, 4>{});
    case 6: return f(Instance<BITS, 6>{});
    case 8: return f(Instance<BITS, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int with_instance(int bits, int abits, F&& f) {
  switch (bits) {
    case 1: return with_abits<1>(abits, f);
    case 2: return with_abits<2>(abits, f);
    case 3: return with_abits<3>(abits, f);
    case 4: return with_abits<4>(abits, f);
    case 5: return with_abits<5>(abits, f);
    case 6: return with_abits<6>(abits, f);
    case 8: return with_abits<8>(abits, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Blocks of the (bits, abits) instance one SM holds at once (the launch
// plan's wave), or -(CUDA error); *smem gets its dynamic shared memory and
// *regs its registers per thread.
extern "C" int repro_lut_matmul_occupancy(int bits, int abits, int* smem, int* regs) {
  return with_instance(bits, abits,
                       [&](auto inst) { return decltype(inst)::occupancy(smem, regs); });
}

// abits == 0: f32 activations in x (xq, xscale unused).
// abits in {4, 6, 8}: int32 codes in xq, per-row scales xscale [M] (x unused).
// The launch plan (splits <= MAX_SPLITS, slab counts, the reduction chunk,
// the reciprocal) comes from repro_torch.kernels.lut_gemv.kernel.plan, which
// also checks shapes, types and contiguity.
extern "C" int repro_lut_matmul(const void* x, const void* xq, const void* xscale,
                                const void* packed, const void* scales, const void* codebook,
                                void* y, int M, int K, int N, int G, int wpg, int bits,
                                int abits, int splits, int slab_base, int slab_rem, int spg,
                                int chunk, unsigned long long magic, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (splits < 1 || splits > MAX_SPLITS || chunk * splits < MT * BN)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x), static_cast<const int32_t*>(xq),
         static_cast<const float*>(xscale), static_cast<const uint32_t*>(packed),
         static_cast<const float*>(scales), static_cast<const float*>(codebook),
         static_cast<float*>(y), M, K, N, G, wpg, spg, magic, splits, slab_base, slab_rem,
         chunk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_instance(bits, abits, [&](auto inst) { return decltype(inst)::launch(a, st); });
}
