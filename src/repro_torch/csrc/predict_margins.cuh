// Sign-bit predictor kernels, shared by the decode kernel
// (predict_group_margins.cu), the prefill-chunk kernel
// (predict_chunk_group_margins.cu) and the negative-product counts
// (predict_counts.cu).
//
// For every token b and every gate-weight row r it computes
//     n_neg[b, r] = popcount(sign(x[b]) XOR signs(Wg[r]))
// and then one of two epilogues.  Margins (the two predictors), per row
// group of G rows:
//     m[b, r]     = n_neg - alpha[b] * (d_valid - n_neg)     (paper eq. 2)
//     gm[b, g]    = min over the G rows of group g
//     cnt[b]      = number of groups with gm <= 0
// Counts (the paper's Listing 1, G = 1): out[b, r] = n_neg[b, r].
// n_neg is an integer and the margin is one fmaf, a single rounding, as the
// jitted reference computes it, so gm and cnt are bitwise equal to the
// plain version, and a row's outputs do not depend on the launch, the token
// tile or the CTA that computed them.
//
// What bounds it on an H100: bytes.  It reads the packed gate signs,
// k * w * 4 bytes (5.6 MB at k=11008, w=128: ~1.7 us at 3.35 TB/s), and x;
// the counts write S * k * 4 bytes (2.8 MB at S=64).
// On the CUDA cores its S*k*w popcounts would take ~22 us at S=64
// (__popc issues 16 a clock per SM); here they run on the binary tensor
// cores, through the identity
//     popc(x ^ w) = popc(x) + popc(w) - 2 * popc(x & w)
// (exact in int32, word for word, zero pads included): the AND-popcount
// products of all tokens and rows are mma.sync m16n8k256 b1 .and.popc
// (0.59 of them a clock per SM, as many as int8 m16n8k32), popc(w) is
// counted once per row from the fragments and popc(x) once per token.
//
// Two template parameters choose the kernel's data routes:
//   XT, the source of x: its values (float or __nv_bfloat16), packed in
//      phase 1, or its packed sign words (uint32_t, as sign_pack writes
//      them), which arrive like the gate-sign rows in phase 0;
//   kCounts, the epilogue: margins -> group minima -> cnt, or the counts.
// Phase 2, the products, is one piece of code for all of them.
//
// Design (the host plan, kernels/predict.py:margins_plan, sizes the grid):
// grid (ctas, token tiles) in clusters of kCluster CTAs along x (of 1 CTA
// when x comes packed); a token tile holds at most 64 tokens.  CTA i owns
// the units [i*n/ctas, (i+1)*n/ctas) of lcm(16, G) rows, so no group
// straddles two CTAs.
//   0. The copy engines bring the CTA's gate-sign rows into shared memory
//      (one bulk copy a row on an mbarrier; 4-byte cp.asyncs when a row is
//      not a multiple of 16 bytes), so no warp stalls on their address
//      translation, which after a cold start is the longest wait (~4 us on
//      the H100); packed x's rows come the same way.  The CTA zeroes the
//      rows' pads, its copy of the tile's x signs (packed x: their pads)
//      and its counts, and arrives on the cluster barrier.
//   1. Values of x: the cluster packs the tile's x signs once: CTA `rank`
//      takes an even share of the tile's words, a lane a word (its 32
//      values in 16-byte loads, 64 registers of them in flight), and stores
//      each word into the shared memory of all kCluster CTAs (distributed
//      shared memory), so x is read once per cluster, not once per CTA.
//      cluster.sync().  Packed x: nothing to do but wait for the copies.
//   2. popc(x) per token.  Each warp then walks its 16-row tiles: per tile
//      and chunk of 4096 columns, popc(w) of its rows and, for every 512-bit
//      span, two MMAs for each 8-token slice (independent accumulators),
//      A and B one 16-byte shared load a lane each, into an int32 product
//      per (row, token) in shared memory.
//   3. Margins: the CTA takes each group's minimum over its rows' margins,
//      counts gm <= 0 per token in shared memory and adds the counts into
//      cnt with one integer atomicAdd per token (cnt is zeroed by the
//      caller).  Counts: n_neg = popc(x) + popc(w) - 2 * product per
//      (token, row) straight from the shared products into out[b, r],
//      token-major and coalesced; every output is written once by one CTA,
//      so there is nothing for the caller to zero.
// The k-step's words: lane (g, t) reads words 16j+4t .. 16j+4t+3 of span
// j of rows g and g+8; the first MMA of the span takes words 4t and 4t+1
// as its chunks t and 4+t, the second 4t+2 and 4t+3, and B the same words
// of token g: every word of the span meets its token's word once.  Rows
// of both operands sit xstride (16 mod 32) words apart, so these reads are
// free of bank conflicts.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace predict {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;          // CTAs that share one packing of x,
                                     // where a tile holds more than 8 tokens
constexpr int kChunkSpans = 8;       // 512-bit spans of A held at once
constexpr int kMaxSlices = 8;        // 8-token slices of a tile (64 tokens)
constexpr int kSmemLimit = 230400;   // dynamic: 227 KB less 2 KB for static
constexpr int kPackedWords = 2;      // x_dtype of x's packed sign words

// The launch's layout, decided by the host plan and checked by check().
struct Plan {
  int S, w, k, G;
  float d_valid;
  int tile;        // tokens of a token tile (the last one may hold fewer)
  int tile_pad;    // tile rounded up to the MMA's 8 columns
  int unit_rows;   // lcm(16, G): rows a CTA takes as a whole
  int n_units;     // ceil(k / unit_rows)
  int cluster;     // 1 or kCluster
  int ctas;        // CTAs per token tile, a multiple of cluster
  int rows_max;    // rows of the largest CTA range: ceil(n_units/ctas)*unit
  int xstride;     // words per row of the packed signs (x and w), 16 mod 32
  int rstride;     // ints per row of the products, 8 mod 32
  int smem;        // bytes of dynamic shared memory
  bool counts;     // the epilogue: counts (true) or margins
};

__host__ __device__ inline int spans_of(int w) { return (w + 15) / 16; }

__host__ __device__ inline size_t smem_bytes(const Plan& p) {
  return (size_t)p.rows_max * p.xstride * 4   // the CTA's gate-sign rows
         + (size_t)p.tile_pad * p.xstride * 4   // the tile's x signs
         + (size_t)p.rows_max * p.rstride * 4   // AND-popcount products
         + (size_t)p.rows_max * 4             // popc(w)
         + (size_t)p.tile_pad * 4 * (p.counts ? 1 : 2);   // popc(x), and
                                              // the margins' kept groups
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// bulk copy (the TMA unit) of n bytes (n and both addresses multiples of
// 16) global -> shared, completing on mbarrier bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(n), "r"(bar)
      : "memory");
}
// global -> shared, 4 bytes (rows whose width is not a multiple of 4 words)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
// wait for phase 0 of the copies' mbarrier; a copy that never lands traps
// (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// c += popc(A & B) over one 256-bit k-step (16 rows x 8 tokens)
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// n_rows rows of w words, w apart at src, into shared memory xstride words
// apart at dst: a bulk copy a row on mbarrier bar (kVec: w a multiple of 4
// and src 16-byte aligned), else 4-byte cp.asyncs (waited by cp_wait_all)
template <bool kVec>
__device__ __forceinline__ void copy_rows(uint32_t* dst, const void* src,
                                          int n_rows, int w, int xstride,
                                          uint32_t bar) {
  const int32_t* s = static_cast<const int32_t*>(src);
  if (kVec) {
    for (int r = threadIdx.x; r < n_rows; r += kThreads)
      bulk_copy(smem_addr(dst + r * xstride), s + (size_t)r * w, w * 4, bar);
  } else {
    for (int i = threadIdx.x; i < n_rows * w; i += kThreads) {
      const int r = i / w;
      cp4(smem_addr(dst + r * xstride + i - r * w), s + i);
    }
  }
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// x's signs: one word (32 values, 64 or 128 bytes) a lane, LSB-first
__device__ __forceinline__ uint32_t neg_bits(const uint4* v, __nv_bfloat16) {
  uint32_t m = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t h[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> float is exact; -0.0, +0.0 and NaN pack as 0
      if (__uint_as_float(h[i] << 16) < 0.f) m |= 1u << (8 * c + 2 * i);
      if (__uint_as_float(h[i] & 0xffff0000u) < 0.f)
        m |= 1u << (8 * c + 2 * i + 1);
    }
  }
  return m;
}
__device__ __forceinline__ uint32_t neg_bits(const uint4* v, float) {
  uint32_t m = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (__uint_as_float(v[c].x) < 0.f) m |= 1u << (4 * c);
    if (__uint_as_float(v[c].y) < 0.f) m |= 1u << (4 * c + 1);
    if (__uint_as_float(v[c].z) < 0.f) m |= 1u << (4 * c + 2);
    if (__uint_as_float(v[c].w) < 0.f) m |= 1u << (4 * c + 3);
  }
  return m;
}

// XT: x's values (float, __nv_bfloat16) or its packed words (uint32_t);
// kCounts: the counts epilogue, into cnt as (S, k), in place of margins
// into gm (S, k/G) and kept-group counts into cnt (S,).
template <typename XT, bool kVec, int kCl, bool kCounts>
__global__ void __launch_bounds__(kThreads, 1)
predict_kernel(const XT* __restrict__ x, const int32_t* __restrict__ pw,
               const float* __restrict__ alpha, float* __restrict__ gm,
               int32_t* __restrict__ cnt, const Plan p) {
  constexpr bool kPacked = std::is_same<XT, uint32_t>::value;
  static_assert(!kPacked || kCl == 1, "packed x needs no cluster");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* as = reinterpret_cast<uint32_t*>(smem_raw);  // (rows_max, xstride)
  uint32_t* xs = as + p.rows_max * p.xstride;            // (tile_pad, xstride)
  int* rp = reinterpret_cast<int*>(xs + p.tile_pad * p.xstride);
  int* wpop = rp + p.rows_max * p.rstride;               // (rows_max,)
  int* xpop = wpop + p.rows_max;                         // (tile_pad,)
  int* cnt_s = xpop + p.tile_pad;
  __shared__ __align__(8) uint64_t a_bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = kCl > 1 ? (int)cluster.block_rank() : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tok0 = blockIdx.y * p.tile;
  const int T = min(p.tile, p.S - tok0);
  const int u0 = (int)((long long)blockIdx.x * p.n_units / p.ctas);
  const int u1 = (int)((long long)(blockIdx.x + 1) * p.n_units / p.ctas);
  const int r0 = u0 * p.unit_rows;
  const int r1 = min(u1 * p.unit_rows, p.k);
  const int rows = r1 - r0;
  const int n_mt = (rows + 15) / 16;
  const int ns = spans_of(p.w);
  const int n_chunks = (ns + kChunkSpans - 1) / kChunkSpans;
  const uint32_t bar = smem_addr(&a_bar);

  // 0. the copies' mbarrier; zero the rows' pads, the x signs (packed x:
  //    their pads) and the counts; arrive on the cluster barrier
  if (kVec && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"((uint32_t)((rows + (kPacked ? T : 0)) * p.w * 4))
        : "memory");
  }
  {
    const int ws = ns * 16, pad = ws - p.w;   // words [w, ws) of a row
    for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
      const int r = i / pad;
      as[r * p.xstride + p.w + i - r * pad] = 0u;
    }
    for (int i = threadIdx.x; i < (n_mt * 16 - rows) * ws; i += kThreads) {
      const int r = i / ws;                     // rows past the CTA's last
      as[(rows + r) * p.xstride + i - r * ws] = 0u;
    }
  }
  if (kPacked) {   // words [w, xstride) of the tile's tokens, pad tokens
    const int pad = p.xstride - p.w;
    for (int i = threadIdx.x; i < T * pad; i += kThreads) {
      const int b = i / pad;
      xs[b * p.xstride + p.w + i - b * pad] = 0u;
    }
    for (int i = T * p.xstride + threadIdx.x; i < p.tile_pad * p.xstride;
         i += kThreads)
      xs[i] = 0u;
  } else {
    for (int i = threadIdx.x * 4; i < p.tile_pad * p.xstride;
         i += kThreads * 4)
      *reinterpret_cast<uint4*>(xs + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!kCounts)
    for (int i = threadIdx.x; i < p.tile_pad; i += kThreads) cnt_s[i] = 0;
  __syncthreads();   // the mbarrier is set up before any copy names it
  if (kCl > 1) cluster_arrive();

  // 1. the cluster packs the tile's x signs once: CTA `rank` takes an
  //    even share of the tile's T*w words, a thread one word at a time (its
  //    64 or 128 bytes in 16-byte loads, kWordsInFlight words in flight),
  //    and stores each word into all kCl CTAs' shared memory.  Between
  //    issuing its first loads of x and using them, each thread issues its
  //    share of the copies of the CTA's gate-sign rows into shared memory
  //    (a bulk copy a row on the copy engine, or 4-byte cp.asyncs when rows
  //    are not 16-byte aligned): issuing them can wait for their transfer,
  //    which then overlaps x's loads.  Packed x: the copies of the rows and
  //    of the tile's words of x are all there is
  if constexpr (kPacked) {
    copy_rows<kVec>(as, pw + (size_t)r0 * p.w, rows, p.w, p.xstride, bar);
    copy_rows<kVec>(xs, x + (size_t)tok0 * p.w, T, p.w, p.xstride, bar);
  } else {
    constexpr int kLoads = 2 * (int)sizeof(XT);    // 16-byte loads a word
    constexpr int kWordsInFlight = 8 / (int)sizeof(XT);   // 64 registers
    const int total = T * p.w;
    const int f0 = (int)((long long)rank * total / kCl);
    const int f1 = (int)((long long)(rank + 1) * total / kCl);
    const int cols = p.w * 32;
    bool first = true;
    for (int blk = f0; first || blk < f1; blk += kThreads * kWordsInFlight) {
      uint4 v[kWordsInFlight][kLoads];
#pragma unroll
      for (int i = 0; i < kWordsInFlight; ++i) {
        const int f = blk + i * kThreads + threadIdx.x;
        const int b = f / p.w, wi = f - b * p.w;
        const uint4* src = reinterpret_cast<const uint4*>(
            x + (size_t)(tok0 + b) * cols + wi * 32);
#pragma unroll
        for (int c = 0; c < kLoads; ++c)
          v[i][c] = f < f1 ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
      }
      if (first) {        // once, before any remote store
        first = false;
        copy_rows<kVec>(as, pw + (size_t)r0 * p.w, rows, p.w, p.xstride,
                        bar);
        if (kCl > 1) cluster_wait();   // every CTA has zeroed its copy
      }
      if (blk >= f1) break;
#pragma unroll
      for (int i = 0; i < kWordsInFlight; ++i) {
        const int f = blk + i * kThreads + threadIdx.x;
        if (f < f1) {
          const uint32_t word = neg_bits(v[i], XT());
          const int b = f / p.w, wi = f - b * p.w;
          uint32_t* dst = xs + b * p.xstride + wi;
          if (kCl > 1) {
#pragma unroll
            for (int r = 0; r < kCl; ++r)
              *cluster.map_shared_rank(dst, r) = word;
          } else {
            *dst = word;
          }
        }
      }
    }
  }
  if (!kVec) cp_wait_all();
  if (kCl > 1)
    cluster.sync();   // every CTA holds the tile's signs
  else
    __syncthreads();
  if (kVec && kPacked) mbar_wait0(bar);   // x's words came with the rows

  // 2a. popc(x) per token, tpt threads a token (pad tokens are zero)
  {
    int tpt = 32;
    while (tpt * p.tile_pad > kThreads) tpt >>= 1;
    const int b = threadIdx.x / tpt, sub = threadIdx.x - b * tpt;
    int s = 0;
    if (b < p.tile_pad)
      for (int i = sub * 4; i < p.xstride; i += tpt * 4)
        s += popc4(*reinterpret_cast<const uint4*>(xs + b * p.xstride + i));
    for (int o = tpt >> 1; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (sub == 0 && b < p.tile_pad) xpop[b] = s;
  }

  // 2b. AND-popcount products and popc(w), one 16-row tile a warp at a
  //     time: per span the 8-token slices' MMAs are independent chains
  if (kVec && !kPacked && warp < n_mt) mbar_wait0(bar);
  const int n_slices = p.tile_pad / 8;
  for (int mt = warp; mt < n_mt; mt += kWarps) {
    int ws0 = 0, ws1 = 0;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int nsp = min(kChunkSpans, ns - chunk * kChunkSpans);
      const uint32_t* ab = as + (mt * 16 + g) * p.xstride +
                           chunk * kChunkSpans * 16 + 4 * t;
      const uint32_t* xb = xs + g * p.xstride + chunk * kChunkSpans * 16 +
                           4 * t;
      int c[kMaxSlices][4];
#pragma unroll
      for (int sl = 0; sl < kMaxSlices; ++sl)
        c[sl][0] = c[sl][1] = c[sl][2] = c[sl][3] = 0;
#pragma unroll
      for (int j = 0; j < kChunkSpans; ++j) {
        if (j < nsp) {
          const uint4 a0 = *reinterpret_cast<const uint4*>(ab + j * 16);
          const uint4 a1 = *reinterpret_cast<const uint4*>(
              ab + 8 * p.xstride + j * 16);
          ws0 += popc4(a0);
          ws1 += popc4(a1);
          uint4 bx[kMaxSlices];
#pragma unroll
          for (int sl = 0; sl < kMaxSlices; ++sl)
            if (sl < n_slices)
              bx[sl] = *reinterpret_cast<const uint4*>(
                  xb + sl * 8 * p.xstride + j * 16);
#pragma unroll
          for (int sl = 0; sl < kMaxSlices; ++sl)
            if (sl < n_slices)
              mma_and_popc(c[sl], a0.x, a1.x, a0.y, a1.y, bx[sl].x,
                           bx[sl].y);
#pragma unroll
          for (int sl = 0; sl < kMaxSlices; ++sl)
            if (sl < n_slices)
              mma_and_popc(c[sl], a0.z, a1.z, a0.w, a1.w, bx[sl].z,
                           bx[sl].w);
        }
      }
#pragma unroll
      for (int sl = 0; sl < kMaxSlices; ++sl) {
        if (sl < n_slices) {
          int2* o0 = reinterpret_cast<int2*>(
              rp + (mt * 16 + g) * p.rstride + sl * 8 + 2 * t);
          int2* o1 = reinterpret_cast<int2*>(
              reinterpret_cast<int*>(o0) + 8 * p.rstride);
          if (chunk == 0) {
            *o0 = make_int2(c[sl][0], c[sl][1]);
            *o1 = make_int2(c[sl][2], c[sl][3]);
          } else {
            const int2 v0 = *o0, v1 = *o1;
            *o0 = make_int2(v0.x + c[sl][0], v0.y + c[sl][1]);
            *o1 = make_int2(v1.x + c[sl][2], v1.y + c[sl][3]);
          }
        }
      }
    }
    ws0 += __shfl_xor_sync(0xffffffffu, ws0, 1);
    ws0 += __shfl_xor_sync(0xffffffffu, ws0, 2);
    ws1 += __shfl_xor_sync(0xffffffffu, ws1, 1);
    ws1 += __shfl_xor_sync(0xffffffffu, ws1, 2);
    if (t == 0) {
      wpop[mt * 16 + g] = ws0;
      wpop[mt * 16 + g + 8] = ws1;
    }
  }
  __syncthreads();

  // 3. counts, token-major: a warp at a time writes a cell of 8 rows x 4
  //    tokens, lane (r, b) = (lane & 7, lane >> 3), so each token's 8 rows
  //    are one 32-byte sector and the products' reads (rows rstride = 8 mod
  //    32 words apart) hit each bank at most twice; the cells of a token
  //    quad run along the rows
  if constexpr (kCounts) {
    const int n_rc = (rows + 7) / 8, n_cells = n_rc * ((T + 3) / 4);
    for (int c = warp; c < n_cells; c += kWarps) {
      const int bc = c / n_rc;
      const int r = (c - bc * n_rc) * 8 + (lane & 7), b = bc * 4 + (lane >> 3);
      if (r < rows && b < T)
        cnt[(size_t)(tok0 + b) * p.k + r0 + r] =
            xpop[b] + wpop[r] - 2 * rp[r * p.rstride + b];
    }
    return;
  }
  // 3. margins, group minima (rows in ascending order, as the reference
  //    takes them) and the per-token count of kept groups: one integer
  //    atomicAdd a token and CTA into cnt, which the caller zeroes
  const int n_groups = p.k / p.G;
  const int g0 = r0 / p.G;
  const int ng = rows / p.G;
  for (int i = threadIdx.x; i < ng * T; i += kThreads) {
    const int gl = i / T, b = i - gl * T;
    const float al = alpha[tok0 + b];
    const int xp = xpop[b];
    const int* rr = rp + gl * p.G * p.rstride + b;
    const int* wr = wpop + gl * p.G;
    float m = 0.f;
#pragma unroll 8
    for (int j = 0; j < p.G; ++j) {
      const float nn = (float)(xp + wr[j] - 2 * rr[j * p.rstride]);
      const float mj = fmaf(-al, p.d_valid - nn, nn);
      m = j ? fminf(m, mj) : mj;
    }
    gm[(size_t)(tok0 + b) * n_groups + g0 + gl] = m;
    if (m <= 0.f) atomicAdd(cnt_s + b, 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < T; b += kThreads)
    if (cnt_s[b]) atomicAdd(cnt + tok0 + b, cnt_s[b]);
}

// The plan's fields against this file's layout.
inline bool check(const Plan& p) {
  if (p.S < 1 || p.w < 1 || p.k < 1 || p.G < 1 || p.k % p.G) return false;
  if (p.counts && (p.G != 1 || p.cluster != 1)) return false;
  if (p.tile < 1 || p.tile > kMaxSlices * 8 ||
      p.tile_pad != (p.tile + 7) / 8 * 8)
    return false;
  const long long tiles = (p.S + p.tile - 1) / p.tile;
  if (tiles > 65535) return false;
  if (p.unit_rows < 16 || p.unit_rows % 16 || p.unit_rows % p.G) return false;
  if (p.n_units != (p.k + p.unit_rows - 1) / p.unit_rows) return false;
  if (p.cluster != 1 && p.cluster != kCluster) return false;
  if (p.ctas < p.cluster || p.ctas % p.cluster) return false;
  const long long per = (p.n_units + p.ctas - 1) / p.ctas;
  if (p.rows_max != per * p.unit_rows) return false;
  if (p.xstride != (spans_of(p.w) * 16 | 16)) return false;
  if (p.rstride < p.tile_pad || p.rstride % 32 != 8) return false;
  return smem_bytes(p) == (size_t)p.smem && p.smem <= kSmemLimit;
}

// Launches the plan p (max_clusters == nullptr), or asks the occupancy
// calculator how many clusters of kCl CTAs with p.smem bytes of shared
// memory the card runs at once (only p.smem is read).
template <typename XT, bool kVec, int kCl, bool kCounts>
int launch(const void* x, const void* pw, const void* alpha, void* gm,
           void* cnt, const Plan& p, cudaStream_t stream, int* max_clusters) {
  auto kern = predict_kernel<XT, kVec, kCl, kCounts>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = max_clusters ? dim3(kCl, 1, 1)
                             : dim3(p.ctas, (p.S + p.tile - 1) / p.tile, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters && kCl == 1) {   // CTAs a SM, times the SMs
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kThreads, p.smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *max_clusters = per_sm * sms;
    return (int)e;
  }
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(
        max_clusters, reinterpret_cast<const void*>(kern), &cfg);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const XT*>(x), static_cast<const int32_t*>(pw),
      static_cast<const float*>(alpha), static_cast<float*>(gm),
      static_cast<int32_t*>(cnt), p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows of w words go by bulk copies where w is a multiple of 4 words and
// the rows start 16-byte aligned.
inline bool bulk_rows(int w, const void* a, const void* b) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// The margins epilogue.  x_dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = launched).
inline int dispatch(const void* x, int x_dtype, const void* pw,
                    const void* alpha, void* gm, void* cnt, const Plan& p,
                    void* stream) {
  if (p.counts || !check(p) || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bulk_rows(p.w, pw, pw);
#define PREDICT_LAUNCH(XT, V)                                               \
  return p.cluster == 1                                                     \
             ? launch<XT, V, 1, false>(x, pw, alpha, gm, cnt, p, s, nullptr) \
             : launch<XT, V, kCluster, false>(x, pw, alpha, gm, cnt, p, s,   \
                                              nullptr)
  if (x_dtype == 0) {
    if (vec) PREDICT_LAUNCH(float, true);
    PREDICT_LAUNCH(float, false);
  }
  if (vec) PREDICT_LAUNCH(__nv_bfloat16, true);
  PREDICT_LAUNCH(__nv_bfloat16, false);
#undef PREDICT_LAUNCH
}

// The counts epilogue on packed x (S, w) int32 -> out (S, k) int32.
inline int dispatch_counts(const void* px, const void* pw, void* out,
                           const Plan& p, void* stream) {
  if (!p.counts || !check(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bulk_rows(p.w, pw, px)
             ? launch<uint32_t, true, 1, true>(px, pw, nullptr, nullptr, out,
                                               p, s, nullptr)
             : launch<uint32_t, false, 1, true>(px, pw, nullptr, nullptr,
                                                out, p, s, nullptr);
}

// How many clusters of `cluster` CTAs (1 or kCluster) with smem bytes of
// shared memory the card runs at once, for x_dtype (kPackedWords: the
// counts kernel, clusters of 1) and rows of w words; a negative value is
// minus a CUDA error code.
inline int max_clusters(int x_dtype, int w, int cluster, int smem) {
  if (x_dtype < 0 || x_dtype > kPackedWords || w < 1 || smem < 0 ||
      smem > kSmemLimit || (cluster != 1 && cluster != kCluster) ||
      (x_dtype == kPackedWords && cluster != 1))
    return -(int)cudaErrorInvalidValue;
  Plan p = {};
  p.smem = smem;
  int n = 0;
  const bool vec = w % 4 == 0;
  int rc;
#define PREDICT_FIT(XT, V)                                                \
  (cluster == 1                                                           \
       ? launch<XT, V, 1, false>(nullptr, nullptr, nullptr, nullptr,      \
                                 nullptr, p, nullptr, &n)                 \
       : launch<XT, V, kCluster, false>(nullptr, nullptr, nullptr,        \
                                        nullptr, nullptr, p, nullptr, &n))
  if (x_dtype == kPackedWords)
    rc = vec ? launch<uint32_t, true, 1, true>(nullptr, nullptr, nullptr,
                                               nullptr, nullptr, p, nullptr,
                                               &n)
             : launch<uint32_t, false, 1, true>(nullptr, nullptr, nullptr,
                                                nullptr, nullptr, p, nullptr,
                                                &n);
  else if (x_dtype == 0)
    rc = vec ? PREDICT_FIT(float, true) : PREDICT_FIT(float, false);
  else
    rc = vec ? PREDICT_FIT(__nv_bfloat16, true)
             : PREDICT_FIT(__nv_bfloat16, false);
#undef PREDICT_FIT
  return rc ? -rc : n;
}

// The plan of a launch from the host plan's choices; check() then holds it
// against this file's layout.
inline Plan make_plan(int S, int w, int k, int G, float d_valid, int tile,
                      int cluster, int unit_rows, int ctas, int rstride,
                      int smem, bool counts) {
  Plan p;
  p.S = S;
  p.w = w;
  p.k = k;
  p.G = G;
  p.d_valid = d_valid;
  p.tile = tile;
  p.tile_pad = (tile + 7) / 8 * 8;
  p.unit_rows = unit_rows;
  p.cluster = cluster;
  p.n_units = unit_rows > 0 ? (k + unit_rows - 1) / unit_rows : 0;
  p.ctas = ctas;
  p.rows_max = ctas > 0 ? (p.n_units + ctas - 1) / ctas * unit_rows : 0;
  p.xstride = spans_of(w) * 16 | 16;
  p.rstride = rstride;
  p.smem = smem;
  p.counts = counts;
  return p;
}

}  // namespace predict
