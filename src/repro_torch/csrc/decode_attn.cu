// Decode attention for Hopper: one query token per sequence over a KV cache
// [B, S, KV, D], int8 with per-position scales [B, S, KV, 1] or f32, as
// split-S flash-decoding.  Replaces decode_attention_pallas
// (src/repro/kernels/decode_attn/kernel.py:79) in its lengths mode and, in
// ring mode, the jnp _decode_attend the reference decode step calls
// (src/repro/models/blocks.py:236, 438-462).  Table mode is ring mode over
// a paged block pool [NB, BS, KV, D] (scales [NB, BS, KV, 1]): logical slot
// j of sequence b lives in physical block tables[b, j / BS], row j % BS, so
// the kernel reads each lane's rows through its block table in place where
// the reference gathers the lane's blocks into a contiguous f32 view first
// (src/repro/models/blocks.py:191-216) and then calls _decode_attend.
//
// Bound: device-memory bytes, the valid K and V rows (1 byte per element when
// int8) plus their scales; the work is 4*H*D flops per valid slot, 2 per
// cached byte per query head, far below the f32 ridge, so tensor cores do
// not help.  At decode sizes the kernel is bound by latency: the first
// version ran one block per (kv head, sequence), 64 blocks on 132 SMs, each
// walking all S slots with scalar byte loads and a serial P.V chain per
// thread (0.1648 ms a launch at B 8, S 512, H100 80GB HBM3, 700 W).
//
// Design:
//   * valid slots only: from len[b] each block computes once the sequence's
//     valid range as (n, start): n slots, the oldest at slot `start`, the
//     rest following it around the ring (valid_range; lengths mode
//     [max(0, L - w), min(L, S)), ring mode the n = min(p + 1, w, S) newest
//     slots ending at p mod S).  Logical row j lives at slot start + j,
//     wrapped once (row_of: the one slot -> address map).  Table mode keeps
//     the ring's range with S = (table width) * BS (a paged lane never
//     wraps, so its valid slots are max(0, p + 1 - w) .. p) and row_of
//     sends slot j through the table: one 4-byte table load per 16-byte
//     chunk, which hits L1 (caching a warp's entries in shared memory, or
//     TMA row reads, are later work).  The launch plan does not see the
//     mode: at the same S the two modes run the same splits, warps and row
//     order, so on the same rows their outputs are bit-equal;
//   * split S across blocks: the grid is (splits, KV, B); the n rows of one
//     (b, kv head) are cut into `splits` chunks of ceil(n / splits) rows,
//     and each chunk into W contiguous warp shares (W = 16 warps a block, 8
//     for G > 8).  The host plan picks splits (a power of two) so that every
//     cluster is resident at once, and only where a sequence can hold more
//     than MIN_SPLIT_ROWS rows: at S = 512 one split measured as fast as two
//     (the launch and the combine cost more than the rows).  A split with no
//     rows loads nothing and leaves the neutral partial (m = NEG_INF, l = 0,
//     acc = 0);
//   * vector loads: every warp streams its rows through a private ring of
//     NSTAGE shared-memory stages with 16-byte cp.async (8-byte when a row
//     is a multiple of 8 bytes and not of 16, 4-byte when it is a multiple
//     of 4 and not of 8: an int8 row of a narrow head, D 12 or 20, whose
//     rows are only 4-byte aligned); a stage holds TW rows of K and V,
//     each padded with zero-filled bytes to the lanes' width, and the rows'
//     (k scale, v scale) pairs, one 4-byte copy each per row;
//   * lanes: a row is read by P = 2^lg_p lanes, E elements each (16 for
//     G <= 2, 8 for G = 4, 4 for G >= 8; 8 at most for f32), so a warp takes
//     32 / P rows at once.  A lane keeps its q slice for all GM query heads
//     of the group in registers (GQA reuse: every K element is dequantised
//     once and feeds G dot products), reduces the G partial dots over its
//     row's P lanes with shuffles, and runs its own online softmax (m, l,
//     acc per head) over the rows it sees: no block barrier inside the loop.
//     P.V is as parallel as the scores: each lane accumulates its E columns
//     over its rows;
//   * lazy rescale: a running max is raised only when a score passes it by
//     RESCALE (2^8), so one exp2 per row and head remains and the rescale,
//     rare after a sequence's first rows, is skipped by the whole warp;
//   * int8 codes are widened without a conversion instruction: the byte
//     c + 128 goes into the mantissa of 2^23 by a byte permute and
//     2^23 + 128 is subtracted (exact).  Scales multiply once per row: the
//     k scale the reduced dot, the v scale the probability;
//   * combine in a fixed order: row groups of a warp by a shuffle
//     butterfly, the W warps in warp order through shared memory, and the
//     splits of a (b, kv head) - one thread-block cluster - in split order
//     through distributed shared memory, each block finishing its share of
//     the G * D outputs.  No atomics, no workspace: two calls are
//     bit-identical, and a launch can be captured in a CUDA graph;
//   * softmax in base 2: q is prescaled by log2(e) / sqrt(D) and ex2.approx
//     is taken of differences.  NEG_INF = -1e30 and the final
//     max(l, 1e-30) of the Pallas kernel are kept (kernel.py:27, 73): an
//     empty window gives zeros.
// No runtime integer division or modulo appears (nvcc lowers it through
// I2F): counts come from the host as shifts, p mod S is one multiply-high
// by a host reciprocal per block, the ring wrap is a compare, and a slot's
// block j / BS one multiply-high by a second host reciprocal (any BS >= 1).
// Its times beside its bound, the parent version's and SDPA's, and a split
// sweep: PERF.md (tools/decode_attn_times.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 16;          // warps per block, a power of two
constexpr int WARPS_G16 = 8;       // for G > 8, whose registers allow fewer
constexpr int NSTAGE = 4;          // ring depth per warp (a power of two)
constexpr int MAX_TW = 32;         // rows per stage: one scale pair per lane
constexpr int MAX_SPLITS = 16;     // a (b, kv head)'s splits form one cluster
constexpr int MAX_G = 16;          // query heads per kv head
constexpr int MAX_D = 128;         // head width (a multiple of 4)
constexpr int MAX_E = 16;          // row elements per lane (int8 K/V)
constexpr int MAX_E_F32 = 8;       // row elements per lane (f32 K/V)
constexpr int MIN_E = 4;
constexpr int LANE_REGS = 32;      // GM * E: q slice registers per lane, where E >= MIN_E
constexpr int MAX_SMEM = 163840;   // dynamic shared memory a plan may ask for
constexpr float NEG_INF = -1e30f;
constexpr float RESCALE = 8.f;     // a running max is raised only past this (log2 units)

template <int GM>
__host__ __device__ constexpr int warps_of() { return GM > 8 ? WARPS_G16 : WARPS; }

template <int GM, bool QUANT>
__host__ __device__ constexpr int lane_elems() {
  constexpr int cap = QUANT ? MAX_E : MAX_E_F32;
  constexpr int want = LANE_REGS / GM > MIN_E ? LANE_REGS / GM : MIN_E;
  return want < cap ? want : cap;
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 0 for x <= -126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Args {
  const float* q;        // [B, H, D]
  const void* k;         // [B, S, KV, D] int8 or f32
  const void* v;
  const float* ks;       // [B, S, KV] (QUANT)
  const float* vs;
  const int32_t* lens;   // [B] lengths, or positions (ring)
  const int32_t* tables; // table mode: [B, MBS] physical blocks; else null
  float* out;            // [B, H, D]
  int H, KV, S, D, G;
  int window;            // ring: the effective window (> 0); lengths: <= 0 is none
  int ring;
  int BS, MBS;           // table mode: rows per block, table width (S = MBS * BS)
  unsigned s_magic;      // floor((2^32 - 1) / S): p / S by a multiply-high, at most 1 low
  unsigned bs_magic;     // floor((2^32 - 1) / BS), the same for a slot's block
  float qscale;          // log2(e) / sqrt(D)
  int lg_splits;         // splits = 2^lg_splits = the cluster's size
  int lg_p;              // lanes per row
  int lg_tw;             // rows per stage
  int lg_cpr;            // copies per padded row
  int lg_cb;             // bytes per copy: 16, 8 or 4 (a divisor of row_bytes)
  int row_bytes;         // D * element size
  int stage_bytes;       // K rows, V rows [TW][padded row], scale pairs [TW]
};

// A sequence's valid rows: n slots, the oldest at slot `start`.
struct Range {
  int n;
  int start;
};

__device__ __forceinline__ Range valid_range(const Args& a, int len) {
  Range r{0, 0};
  if (a.ring) {
    if (len >= 0) {
      r.n = min(len, min(a.window, a.S) - 1) + 1;
      const unsigned quot = __umulhi(static_cast<unsigned>(len), a.s_magic);
      int pm = len - static_cast<int>(quot) * a.S;   // p mod S, or that + S
      if (pm >= a.S) pm -= a.S;
      r.start = pm - r.n + 1;
      if (r.start < 0) r.start += a.S;
    }
  } else {
    const int hi = min(len, a.S);
    const int lo = a.window > 0 ? max(0, len - a.window) : 0;
    if (hi > lo) {
      r.n = hi - lo;
      r.start = lo;
    }
  }
  return r;
}

// Row index (in rows of D elements, and in scales) of logical row j of kv
// head h in sequence b: the one place that maps a row to its cache address.
// Table mode: slot -> (tables[b, slot / BS] * BS + slot % BS), the quotient
// by a multiply-high that is exact or one low, corrected by one compare.
__device__ __forceinline__ long long row_of(const Args& a, const Range& r, int b, int h, int j) {
  int slot = r.start + j;
  if (slot >= a.S) slot -= a.S;
  if (a.tables != nullptr) {
    int blk = static_cast<int>(__umulhi(static_cast<unsigned>(slot), a.bs_magic));
    int off = slot - blk * a.BS;
    if (off >= a.BS) {
      off -= a.BS;
      ++blk;
    }
    const long long phys = __ldg(a.tables + static_cast<long long>(b) * a.MBS + blk);
    return (phys * a.BS + off) * a.KV + h;
  }
  return (static_cast<long long>(b) * a.S + slot) * a.KV + h;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// n bytes copied of `bytes`, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Copy rows [j0, j0 + rows) of this warp into stage `st`: K and V rows
// padded to 2^lg_cpr copies (bytes past the row zero-filled), then the
// scale pairs.
template <bool QUANT>
__device__ __forceinline__ void issue_tile(const Args& a, const Range& rg, int b, int h,
                                           unsigned char* st, int j0, int rows, int lane) {
  const int cb = 1 << a.lg_cb;
  const int rbp = cb << a.lg_cpr;
  const int tw = 1 << a.lg_tw;
  unsigned char* sk = st;
  unsigned char* sv = st + tw * rbp;
  const char* kb = static_cast<const char*>(a.k);
  const char* vb = static_cast<const char*>(a.v);
  const int cmask = (1 << a.lg_cpr) - 1;
  for (int c = lane; c < (rows << a.lg_cpr); c += 32) {
    const int r = c >> a.lg_cpr;
    const int off = (c & cmask) * cb;
    const int n = off < a.row_bytes ? cb : 0;
    const long long src = n ? row_of(a, rg, b, h, j0 + r) * a.row_bytes + off : 0;
    if (a.lg_cb == 4) {
      cp_async16(sk + r * rbp + off, kb + src, n);
      cp_async16(sv + r * rbp + off, vb + src, n);
    } else if (a.lg_cb == 3) {
      cp_async8(sk + r * rbp + off, kb + src, n);
      cp_async8(sv + r * rbp + off, vb + src, n);
    } else {
      cp_async4(sk + r * rbp + off, kb + src, n);
      cp_async4(sv + r * rbp + off, vb + src, n);
    }
  }
  if constexpr (QUANT) {
    if (lane < rows) {
      float* sc = reinterpret_cast<float*>(st + 2 * tw * rbp);
      const long long row = row_of(a, rg, b, h, j0 + lane);
      cp_async4(sc + 2 * lane, a.ks + row, 4);
      cp_async4(sc + 2 * lane + 1, a.vs + row, 4);
    }
  }
}

// int8 code c (as its byte) -> float c exactly: c + 128 into the mantissa
// of 2^23, minus 2^23 + 128.
__device__ __forceinline__ float widen(unsigned biased, unsigned i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.0f;
}

// E row elements of this lane from shared memory, as floats
template <bool QUANT, int E>
__device__ __forceinline__ void load_slice(const unsigned char* p, float (&x)[E]) {
  if constexpr (QUANT) {
    unsigned w[E / 4];
    if constexpr (E == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (E == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const unsigned biased = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) x[4 * i + j] = widen(biased, j);
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = f.x; x[4 * i + 1] = f.y; x[4 * i + 2] = f.z; x[4 * i + 3] = f.w;
    }
  }
}

template <int GM, bool QUANT>
__global__ void __launch_bounds__(32 * warps_of<GM>())
    decode_attn_kernel(const Args a) {
  constexpr int E = lane_elems<GM, QUANT>();
  constexpr int W = warps_of<GM>();
  constexpr int LGW = W == 16 ? 4 : 3;
  constexpr int THREADS = 32 * W;
  constexpr int ES = QUANT ? 1 : 4;           // bytes per element
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lanes = 1 << a.lg_p;
  const int slice = lane & (lanes - 1);       // this lane's E columns
  const int rgi = lane >> a.lg_p;             // this lane's row within a pass
  const int rw = 32 >> a.lg_p;                // rows per pass
  const int tw = 1 << a.lg_tw;
  const int rbp = 1 << (a.lg_cb + a.lg_cpr);

  // the group's queries, this lane's slice, prescaled; zero past G and D
  float qr[GM][E];
  {
    const int col = slice * E;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float* qp = a.q + (static_cast<long long>(b) * a.H + h * a.G + g) * a.D + col;
      const bool in = g < a.G;
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && col + 4 * i < a.D) f = *reinterpret_cast<const float4*>(qp + 4 * i);
        qr[g][4 * i] = f.x * a.qscale;
        qr[g][4 * i + 1] = f.y * a.qscale;
        qr[g][4 * i + 2] = f.z * a.qscale;
        qr[g][4 * i + 3] = f.w * a.qscale;
      }
    }
  }

  // this block's rows, then this warp's contiguous share of them
  const Range rg = valid_range(a, a.lens[b]);
  const int chunk = (rg.n + (1 << a.lg_splits) - 1) >> a.lg_splits;
  const int s0 = split * chunk;
  const int scount = max(0, min(chunk, rg.n - s0));
  const int wq = scount >> LGW, wr = scount & (W - 1);
  const int w0 = s0 + warp * wq + min(warp, wr);
  const int wcnt = wq + (warp < wr ? 1 : 0);
  const int ntiles = (wcnt + tw - 1) >> a.lg_tw;
  unsigned char* ring = smem + warp * NSTAGE * a.stage_bytes;

#pragma unroll
  for (int p = 0; p < NSTAGE; ++p) {
    if (p < ntiles)
      issue_tile<QUANT>(a, rg, b, h, ring + p * a.stage_bytes, w0 + (p << a.lg_tw),
                        min(tw, wcnt - (p << a.lg_tw)), lane);
    cp_async_commit();
  }

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NSTAGE - 1>();
    __syncwarp();
    unsigned char* st = ring + (t & (NSTAGE - 1)) * a.stage_bytes;
    const int rows = min(tw, wcnt - (t << a.lg_tw));
    const float2* sc = reinterpret_cast<const float2*>(st + 2 * tw * rbp);
    for (int ps = 0; ps < rows; ps += rw) {
      const int r = ps + rgi;
      float x[E];
      load_slice<QUANT, E>(st + r * rbp + slice * E * ES, x);
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], x[e], d);
        dot[g] = d;
      }
      for (int o = 1; o < lanes; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GM; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      }
      const bool valid = r < rows;
      float ksc = 1.f, vsc = 1.f;
      if constexpr (QUANT) {
        if (valid) {
          const float2 s2 = sc[r];
          ksc = s2.x;
          vsc = s2.y;
        }
      }
      // Lazy rescale: the running max is raised only when a score passes
      // it by RESCALE, so p = 2^(s - m) stays below 2^RESCALE and the
      // rescale (rare after the first rows) is skipped by the whole warp.
      bool grow = false;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        dot[g] *= ksc;
        grow |= valid && dot[g] > m[g] + RESCALE;
      }
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (valid && dot[g] > m[g]) {
            const float f = fast_exp2(m[g] - dot[g]);
            m[g] = dot[g];
            l[g] *= f;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] *= f;
          }
        }
      }
      if (valid) {
        load_slice<QUANT, E>(st + tw * rbp + r * rbp + slice * E * ES, x);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = fast_exp2(dot[g] - m[g]);
          l[g] += p;
          const float pv = p * vsc;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, x[e], acc[g][e]);
        }
      }
    }
    __syncwarp();                   // every lane done with this stage
    if (t + NSTAGE < ntiles)
      issue_tile<QUANT>(a, rg, b, h, st, w0 + ((t + NSTAGE) << a.lg_tw),
                        min(tw, wcnt - ((t + NSTAGE) << a.lg_tw)), lane);
    cp_async_commit();
  }
  cp_async_wait_all();

  // the warp's row groups, lanes of one slice: a butterfly in a fixed order
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float f0 = fast_exp2(m[g] - mn), f1 = fast_exp2(mo - mn);
      l[g] = l[g] * f0 + lo * f1;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * f0 + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * f1;
      m[g] = mn;
    }
  }
  __syncthreads();                  // the rings are free: reuse them

  // warp partials [WARPS][GM][PE] and their (m, l) [WARPS][GM][2], then the
  // block's partial [GM][PE] and (m, l) [GM][2]
  const int lg_pe = a.lg_p + (E == 16 ? 4 : E == 8 ? 3 : 2);
  const int pe = 1 << lg_pe;
  float* wacc = reinterpret_cast<float*>(smem);
  float* wml = wacc + W * GM * pe;
  float* bacc = wml + W * GM * 2;
  float* bml = bacc + GM * pe;
  if (rgi == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[(warp * GM + g) * pe + slice * E + e] = acc[g][e];
      if (slice == 0) {
        wml[(warp * GM + g) * 2] = m[g];
        wml[(warp * GM + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < (GM << lg_pe); o += THREADS) {
    const int g = o >> lg_pe;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wml[(w * GM + g) * 2]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = fast_exp2(wml[(w * GM + g) * 2] - mx);
      ls += wml[(w * GM + g) * 2 + 1] * f;
      as += wacc[(w * GM) * pe + o] * f;
    }
    if (a.lg_splits == 0) {
      const int col = o & (pe - 1);
      if (g < a.G && col < a.D)
        a.out[(static_cast<long long>(b) * a.H + h * a.G + g) * a.D + col] = as / fmaxf(ls, 1e-30f);
    } else {
      bacc[o] = as;
      if ((o & (pe - 1)) == 0) {
        bml[2 * g] = mx;
        bml[2 * g + 1] = ls;
      }
    }
  }
  if (a.lg_splits == 0) return;

  // The splits of this (b, kv head) form one cluster: block q finishes the
  // q-th share of the outputs over all splits, in split order, through
  // distributed shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = 1 << a.lg_splits;
  const int share = (GM << lg_pe) >> a.lg_splits;
  for (int j = threadIdx.x; j < share; j += THREADS) {
    const int o = split * share + j;
    const int g = o >> lg_pe;
    const int col = o & (pe - 1);
    float mx = NEG_INF;
    for (int q = 0; q < splits; ++q) mx = fmaxf(mx, cluster.map_shared_rank(bml, q)[2 * g]);
    float ls = 0.f, as = 0.f;
    for (int q = 0; q < splits; ++q) {
      const float* rml = cluster.map_shared_rank(bml, q);
      const float f = fast_exp2(rml[2 * g] - mx);
      ls += rml[2 * g + 1] * f;
      as += cluster.map_shared_rank(bacc, q)[o] * f;
    }
    if (g < a.G && col < a.D)
      a.out[(static_cast<long long>(b) * a.H + h * a.G + g) * a.D + col] = as / fmaxf(ls, 1e-30f);
  }
  cluster.sync();                   // keep this block's partial until all have read it
}

// One instance of the kernel: its attributes (set once), occupancy and launch.
template <int GM, bool QUANT>
struct Instance {
  static cudaError_t setup() {
    static const cudaError_t attr = [] {
      cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<GM, QUANT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(decode_attn_kernel<GM, QUANT>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      return e;
    }();
    return attr;
  }

  // blocks of this instance one SM holds at once with `smem` bytes of
  // dynamic shared memory, or -(CUDA error)
  static constexpr int THREADS = 32 * warps_of<GM>();

  static int occupancy(int smem, int* regs) {
    int blocks = 0;
    cudaFuncAttributes attrs = {};
    cudaError_t e = setup();
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attrs, decode_attn_kernel<GM, QUANT>);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_attn_kernel<GM, QUANT>,
                                                        THREADS, smem);
    *regs = attrs.numRegs;
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  }

  // clusters of `splits` blocks the card holds at once, or -(CUDA error)
  static int clusters(int splits, int smem) {
    cudaError_t e = setup();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, 1024, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = splits;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, decode_attn_kernel<GM, QUANT>, &cfg);
    return e == cudaSuccess ? n : -static_cast<int>(e);
  }

  static int launch(const Args& a, int B, int smem, cudaStream_t stream) {
    const cudaError_t attr = setup();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1u << a.lg_splits, a.KV, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1u << a.lg_splits;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attn_kernel<GM, QUANT>, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
};

template <typename F>
int with_instance(int gm, int quantized, F&& f) {
  if (quantized) {
    switch (gm) {
      case 1: return f(Instance<1, true>{});
      case 2: return f(Instance<2, true>{});
      case 4: return f(Instance<4, true>{});
      case 8: return f(Instance<8, true>{});
      case 16: return f(Instance<16, true>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (gm) {
    case 1: return f(Instance<1, false>{});
    case 2: return f(Instance<2, false>{});
    case 4: return f(Instance<4, false>{});
    case 8: return f(Instance<8, false>{});
    case 16: return f(Instance<16, false>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Blocks of the (gm, quantized) instance one SM holds at once with `smem`
// bytes of dynamic shared memory (the plan's wave), or -(CUDA error); *regs
// gets its registers per thread.
extern "C" int repro_decode_attention_occupancy(int gm, int quantized, int smem, int* regs) {
  return with_instance(gm, quantized,
                       [&](auto inst) { return decltype(inst)::occupancy(smem, regs); });
}

// Clusters of `splits` blocks of the (gm, quantized) instance with `smem`
// bytes of dynamic shared memory the card holds at once, or -(CUDA error).
extern "C" int repro_decode_attention_clusters(int gm, int quantized, int splits, int smem) {
  return with_instance(gm, quantized,
                       [&](auto inst) { return decltype(inst)::clusters(splits, smem); });
}

// q f32 [B, H, D]; k, v [B, S, KV, D] int8 (quantized != 0, scales
// [B, S, KV, 1] f32) or f32; lens int32 [B] (lengths, or positions when
// ring != 0); out f32 [B, H, D].  Table mode (tables != null, ring != 0):
// k, v are a block pool [NB, BS, KV, D] (scales [NB, BS, KV, 1]), tables
// int32 [B, mbs] its physical blocks, S = mbs * BS; every table entry must
// lie in [0, NB).  The launch plan (gm = G rounded up to a power of two,
// the lane layout, the stage, the splits, the shared memory) comes from
// repro_torch.kernels.decode_attn.kernel.plan, which also checks shapes,
// types, contiguity and alignment.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lens, const void* tables, void* out,
                                      int B, int H, int KV, int S, int D, int window,
                                      int quantized, int ring, int gm, int lg_splits, int lg_p,
                                      int lg_tw, int lg_cpr, int lg_cb, int stage_bytes,
                                      int smem, int bs, int mbs, unsigned s_magic,
                                      unsigned bs_magic, float qscale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (lg_splits < 0 || (1 << lg_splits) > MAX_SPLITS || lg_tw < 0 || (1 << lg_tw) > MAX_TW ||
      lg_cb < 2 || lg_cb > 4 || lg_cpr < 0 ||
      H % KV != 0 || H / KV > gm || gm > MAX_G || D > MAX_D || smem > MAX_SMEM ||
      smem < WARPS_G16 * NSTAGE * stage_bytes ||
      (tables != nullptr && (!ring || bs < 1 || mbs < 1 || static_cast<long long>(bs) * mbs != S)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), static_cast<const int32_t*>(lens),
         static_cast<const int32_t*>(tables), static_cast<float*>(out), H, KV, S, D, H / KV,
         window, ring, bs, mbs, s_magic, bs_magic, qscale, lg_splits, lg_p, lg_tw, lg_cpr,
         lg_cb, quantized ? D : 4 * D, stage_bytes};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_instance(gm, quantized,
                       [&](auto inst) { return decltype(inst)::launch(a, B, smem, st); });
}
