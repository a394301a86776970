// The float32 chunk MLP on Hopper's tensor cores, instantiated by
// fused_sparse_mlp_chunk.cu (see its note for what it replaces and why).
//
// For the first `count` of the C selected row groups sel[0..C) and the S
// rows of a chunk x (float32 or bfloat16) it computes
//     g = act(x Wg[rows]^T),  h = g * (x Wu[rows]^T)  (h = g when ungated)
//     h rounded to x's dtype (a no-op for float32 x)
//     y = h Wd[rows]                                   (float32)
// and, when tel is given, the per-token int32 counters (actual, false_neg,
// realized): rows with g > 0, of those the ones whose own group margin
// gm_tok[s, sel] said skip, and G * groups the token itself kept.
//
// Numerics: float32 products from TF32 MMAs.  Every float32 operand v is
// split into big = rna_tf32(v) and small = rna_tf32(v - big) (cvt.rna:
// round to nearest, ties away; the 13 low mantissa bits of each part are
// zero, so the MMA drops nothing).  v - big is exact, so
// |v - big - small| <= 2^-22 |v|.  A bf16 value is exact in TF32 and is not
// split.  Each product is a sum of exact TF32 x TF32 products:
//   bf16 x:    x.W  = x.Wsmall + x.Wbig                 (2 MMAs)
//              h.Wd = h.Wdsmall + h.Wdbig  (h rounded to bf16: exact)
//   float32 x: a.b  = asmall.bbig + abig.bsmall + abig.bbig   (3 MMAs; the
//              dropped asmall.bsmall is below 2^-22 |a||b|)
// The MMA aligns its addends to the largest one and truncates what falls
// below it.  Chaining a whole dot product through the MMAs would drop up
// to an ulp of the running sum at every step, always toward zero; so each
// stage's passes (32 deep) are summed by the MMAs into a zeroed fragment,
// which is then added to the float32 sum with round-to-nearest adds.
//
// Work split: one cooperative launch of `grid` blocks of 4 warps (every
// block resident), four phases between grid barriers, fixed-order sums,
// no float atomics.
//   1. gate/up.  An item is 64 consecutive selected rows x a split of d's
//      32-column chunks (split ks takes chunks ks, ks + splits, ..., so the
//      splits of a row tile read neighbouring pieces of the same rows at
//      once; the split count grows while the grid has room for more items,
//      so a short selection still fills the card).  Each warp owns 16
//      rows: m16n8k8 MMAs with M over weight rows, N over the token tile's
//      tokens, K over d.  Weight and x tiles of 32 columns stream through a
//      4-stage ring of 16-byte cp.asyncs in shared memory; the ring runs on
//      across items and token tiles, so a block has loads in flight until
//      its last tile.  A chunk longer than one token tile (64 tokens) walks
//      its token tiles inside the item, so each weight row leaves device
//      memory once and is read again from L2.  Each split's partial sums
//      go to scratch.
//   2. combine.  Every block takes a share of the selected rows: the
//      splits added in split order, act, h rounded and written transposed
//      (hT: token-major), the telemetry counted in shared memory and added
//      with one global integer atomicAdd per token and counter.
//   3. down.  An item is 128 columns of d x a slice of the selected rows
//      (slices start on a multiple of 8 rows); yT = WdT hT with M over
//      columns, N over tokens, K over rows (each warp two m16 tiles), Wd
//      and hT tiles of 32 rows through the same ring: Wd by bulk copies
//      (the TMA unit, one 512-byte copy a row, completing on a stage's
//      mbarrier), hT by cp.async.  Each slice's partial goes to scratch.
//   4. y = the sum of the slice partials in slice order.
// Only count*G rows of each matrix are read: items past the count do not
// exist, which is where a short selection saves its bytes.
//
// Fragments: the MMA sums over its 8-deep K in any order, so lane tig
// takes K positions tig and tig + 4 from two adjacent columns (2 tig,
// 2 tig + 1) and loads both with one 64-bit shared-memory read; down also
// pairs its M positions gid and gid + 8 on columns 2 gid, 2 gid + 1.  The
// cp.async tiles' 16-byte segments are XOR-swizzled by row and the bulk-
// copied Wd rows are padded to 132 floats, so the reads of a half-warp hit
// 32 distinct banks.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mlp {
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kMaxNT = 8;            // 8-token MMA tiles in a token tile
// gate/up: 64 weight rows x 32 columns of d a stage; x: 32 columns
constexpr int kRows = 64;
constexpr int kKC = 32;
// down: 32 selected rows x 128 columns of Wd, 64 tokens x 32 rows of hT
constexpr int kCols = 128;
constexpr int kDStride = kCols + 4;  // floats a Wd-tile row (padded)
constexpr int kMT = kCols / (16 * kWarps);   // m16 tiles of a warp in down
constexpr int kKR = 32;
constexpr int kSliceUnit = 8;        // slices start on multiples of 8 rows
constexpr int kMaxSplits = 16;
constexpr int kMinSliceRows = 64;

__host__ __device__ constexpr int stage_bytes(int nt, bool bf16) {
  // max of gate/up (Wg, Wu, x) and down (Wd, hT) tiles
  return 2 * kRows * kKC * 4 + 8 * nt * kKC * (bf16 ? 2 : 4) >
                 kKR * kDStride * 4 + 8 * kMaxNT * kKR * 4
             ? 2 * kRows * kKC * 4 + 8 * nt * kKC * (bf16 ? 2 : 4)
             : kKR * kDStride * 4 + 8 * kMaxNT * kKR * 4;
}

// the split of d for rt row tiles, and the slices of nrows selected rows
// (kernels/sparse_mlp_fused.py: splits, slices)
__host__ __device__ inline int splits(int grid, int rt, int max_splits) {
  const int s = rt > 0 ? grid / rt : 1;
  return s < 1 ? 1 : (s < max_splits ? s : max_splits);
}
__host__ __device__ inline int slices(int grid, int col_tiles, int nrows) {
  if (nrows <= 0) return 0;
  int s = grid / col_tiles;
  const int by_rows = (nrows + kMinSliceRows - 1) / kMinSliceRows;
  s = s < by_rows ? s : by_rows;
  return s < 1 ? 1 : s;
}

// float offset of 16-byte segment `seg` of row `row` in a swizzled tile of
// 32 floats a row (8 segments); bf16 offset in a tile of 32 bf16 a row (4
// segments).  (Down's Wd tile, which bulk copies fill row by row, is
// padded instead: kDStride.)
__device__ __forceinline__ int swz32(int row, int seg) {
  return row * 32 + ((seg ^ ((row & 3) << 1)) << 2);
}
__device__ __forceinline__ int swz16(int row, int seg) {
  return row * 32 + ((seg ^ ((row >> 1) & 3)) << 3);
}

// ---- primitives -----------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}
// c += a b, m16n8k8, TF32 in, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// one 8-deep step of the passes, asmall.bbig (+ abig.bsmall when b is
// split) + abig.bbig, over the NT token tiles: each pass runs over all
// tiles before the next, so consecutive MMAs feed different accumulators
// and a warp does not wait on one MMA to issue the next
template <bool kSplitB, int NT>
__device__ __forceinline__ void passes(float (&c)[NT][4],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&bb)[NT][2],
                                       const uint32_t (&bs)[NT][2]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) mma(c[t], as, bb[t][0], bb[t][1]);
  if (kSplitB) {
#pragma unroll
    for (int t = 0; t < NT; ++t) mma(c[t], ab, bs[t][0], bs[t][1]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) mma(c[t], ab, bb[t][0], bb[t][1]);
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, 16 bytes of which the first n come from src (the rest
// zero-filled; src is not read when n is 0), or 8 bytes
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
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
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
// the one arrival of a stage's phase, with the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait for the phase of parity `parity`; a copy that never lands traps
// (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = phase * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// position in a block's sequence of (item, token tile, chunk) steps: the
// item's chunks are c0, c0 + step, ... below c1
struct Cursor {
  int item, tt, c, c0, c1, step;
};

// The optional phase trace: per block, %globaltimer (ns) at kernel start,
// gate/up done, past barrier 1, combine done, past barrier 2, down done,
// past barrier 3 and the end.
constexpr int kTracePoints = 8;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Args {
  const void* x;
  const float* wg;
  const float* wu;        // null: ungated
  const float* wd;
  const int32_t* sel;
  const int32_t* count;
  const float* gm_tok;    // null: no telemetry
  float* y;               // (S, d)
  int32_t* tel;           // (S, 3) zeroed, or null
  float* gu;              // gate/up split partials, g then u at u_off
  float* ht;              // hT: (s_pad, h_stride)
  float* part;            // down's slice partials (slices, S, d)
  unsigned* bar;          // zeroed grid barrier
  unsigned long long* trace;  // null, or kTracePoints per block
  long long u_off;
  int S, d, k, C, G, act_kind;
  float thr;
  int s_pad, max_splits, h_stride;
};

template <typename XT, int NT>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const Args a) {
  constexpr bool kBf16 = std::is_same<XT, __nv_bfloat16>::value;
  constexpr int TN = 8 * NT;              // tokens of a token tile
  constexpr int kStage = stage_bytes(NT, kBf16);
  extern __shared__ __align__(16) unsigned char smem[];
  // one mbarrier a ring stage: the bulk copies of its weight tile
  __shared__ __align__(8) uint64_t full[kStages];
  // kernel parameters as locals: the lambdas below capture these
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const float* __restrict__ wg = a.wg;
  const float* __restrict__ wu = a.wu;
  const float* __restrict__ wd = a.wd;
  const int32_t* __restrict__ sel = a.sel;
  const float* __restrict__ gm_tok = a.gm_tok;
  int32_t* const tel = a.tel;
  float* const ht = a.ht;
  float* const part = a.part;
  float* const gp = a.gu;
  float* const up = a.gu + a.u_off;
  const int act_kind = a.act_kind;
  const float thr = a.thr;
  unsigned long long* const trace =
      a.trace != nullptr && threadIdx.x == 0
          ? a.trace + (size_t)blockIdx.x * kTracePoints
          : nullptr;
  if (trace) trace[0] = global_ns();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = a.S, d = a.d, G = a.G, s_pad = a.s_pad;
  const int h_stride = a.h_stride;
  const int count = min(max(*a.count, 0), a.C);
  const int nrows = count * G;
  const int n_groups = a.k / G;
  const bool gated = wu != nullptr;
  const bool stats = tel != nullptr;
  const int ntt = s_pad / TN;
  const int grid = gridDim.x;
  const int g_shift = (G & (G - 1)) == 0 ? __ffs(G) - 1 : -1;
  // The ring starts zeroed: bulk copies fill only the rows and columns that
  // exist, and what stays behind (zeros, or an earlier tile's weights) is
  // finite and meets zeros in the other operand (x, hT are zero-filled).
  for (int i = tid; i < kStages * kStage / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // order these writes before the bulk copies' writes (another proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_addr(&full[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // down's ring steps issued and consumed: step j fills stage j % kStages,
  // whose barrier then completes phase j / kStages (gate/up counts its
  // steps in the same variables and resets them: it uses no barrier)
  int produced = 0, consumed = 0;
  auto wait_stage = [&]() {
    mbar_wait(smem_addr(&full[consumed % kStages]),
              (consumed / kStages) & 1);
  };
  // the weight row of selected row n
  auto row_of = [&](int n) -> size_t {
    if (g_shift >= 0)
      return ((size_t)__ldg(sel + (n >> g_shift)) << g_shift) + (n & (G - 1));
    return (size_t)__ldg(sel + n / G) * G + n % G;
  };

  // =================== phase 1: gate/up split partials ====================
  const int kchunks = (d + kKC - 1) / kKC;
  const int rt_live = (nrows + kRows - 1) / kRows;
  const int nks = min(splits(grid, rt_live, a.max_splits), kchunks);
  const int items1 = rt_live * nks;

  // split ks takes the chunks ks, ks + nks, ...: the splits of a row tile
  // read neighbouring pieces of the same rows at the same time
  auto start1 = [&](Cursor& q, int item) {
    q.item = item;
    q.tt = 0;
    const int ks = item % nks;
    q.c0 = q.c = ks;
    q.c1 = kchunks;
    q.step = nks;
  };
  auto next1 = [&](Cursor& q) {
    if ((q.c += q.step) < q.c1) return;
    q.c = q.c0;
    if (++q.tt < ntt) return;
    start1(q, q.item + grid);
  };
  // one ring step: 16-byte cp.asyncs of the weight rows' 128-byte pieces
  // and of the x tile (a bulk copy a 128-byte piece costs more than it
  // saves)
  auto load1 = [&](const Cursor& q) {
    const int stage = produced % kStages;
    float* wg_s = reinterpret_cast<float*>(smem + stage * kStage);
    float* wu_s = wg_s + kRows * kKC;
    float* x_s = wu_s + kRows * kKC;
    const int rt = q.item / nks;
    const int col0 = q.c * kKC;
#pragma unroll
    for (int j = 0; j < kRows * (kKC / 4) / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx >> 3, seg = idx & 7;
      const int n = rt * kRows + r;
      const int col = col0 + seg * 4;
      const bool ok = n < nrows && col < d;
      const size_t off = ok ? row_of(n) * d + col : 0;
      cp16(smem_addr(wg_s + swz32(r, seg)), wg + off, ok ? 16 : 0);
      if (gated) cp16(smem_addr(wu_s + swz32(r, seg)), wu + off, ok ? 16 : 0);
    }
    const int tok0 = q.tt * TN;
    if (!kBf16) {
      for (int idx = tid; idx < TN * (kKC / 4); idx += kThreads) {
        const int r = idx >> 3, seg = idx & 7;
        const int s = tok0 + r, col = col0 + seg * 4;
        const bool ok = s < S && col < d;
        cp16(smem_addr(x_s + swz32(r, seg)),
             x + (ok ? (size_t)s * d + col : 0), ok ? 16 : 0);
      }
    } else {
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(x_s);
      if (d % 8 == 0) {   // 16-byte segments of 8 values
        for (int idx = tid; idx < TN * (kKC / 8); idx += kThreads) {
          const int r = idx >> 2, seg = idx & 3;
          const int s = tok0 + r, col = col0 + seg * 8;
          const bool ok = s < S && col < d;
          cp16(smem_addr(xs + swz16(r, seg)),
               x + (ok ? (size_t)s * d + col : 0), ok ? 16 : 0);
        }
      } else {            // rows only 8-byte aligned: halves of segments
        for (int idx = tid; idx < TN * (kKC / 4); idx += kThreads) {
          const int r = idx >> 3, hs = idx & 7;
          const int s = tok0 + r, col = col0 + hs * 4;
          const bool ok = s < S && col < d;
          cp8(smem_addr(xs + swz16(r, hs >> 1) + (hs & 1) * 4),
              x + (ok ? (size_t)s * d + col : 0), ok);
        }
      }
    }
    ++produced;
  };

  float accg[NT][4], accu[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) accg[t][e] = accu[t][e] = 0.f;
  // one stage: the passes of its 4 steps summed by the MMAs, then added
  auto compute1 = [&](int stage) {
    const float* wg_s = reinterpret_cast<const float*>(smem + stage * kStage);
    const float* wu_s = wg_s + kRows * kKC;
    const float* x_s = wu_s + kRows * kKC;
    float pg[NT][4], pu[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pg[t][e] = pu[t][e] = 0.f;
    const int r0 = warp * 16 + gid;
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      // K positions tig, tig + 4 <- columns kk*8 + 2 tig, + 1
      const int seg = 2 * kk + (tig >> 1), w2 = 2 * (tig & 1);
      const int wo0 = swz32(r0, seg) + w2, wo1 = swz32(r0 + 8, seg) + w2;
      uint32_t gb[4], gs[4], ub[4], us[4];
      {
        const float2 v0 = *reinterpret_cast<const float2*>(wg_s + wo0);
        const float2 v1 = *reinterpret_cast<const float2*>(wg_s + wo1);
        split(v0.x, gb[0], gs[0]);   // (row gid, k tig)
        split(v1.x, gb[1], gs[1]);   // (row gid + 8, k tig)
        split(v0.y, gb[2], gs[2]);   // (row gid, k tig + 4)
        split(v1.y, gb[3], gs[3]);   // (row gid + 8, k tig + 4)
      }
      if (gated) {
        const float2 v0 = *reinterpret_cast<const float2*>(wu_s + wo0);
        const float2 v1 = *reinterpret_cast<const float2*>(wu_s + wo1);
        split(v0.x, ub[0], us[0]);
        split(v1.x, ub[1], us[1]);
        split(v0.y, ub[2], us[2]);
        split(v1.y, ub[3], us[3]);
      }
      // B: tokens t*8 + gid, K positions tig, tig + 4
      uint32_t xb[NT][2], xs[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (kBf16) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const __nv_bfloat16*>(x_s) +
              swz16(t * 8 + gid, kk) + 2 * tig);
          xb[t][0] = v << 16;
          xb[t][1] = v & 0xffff0000u;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(
              x_s + swz32(t * 8 + gid, seg) + w2);
          split(v.x, xb[t][0], xs[t][0]);
          split(v.y, xb[t][1], xs[t][1]);
        }
      }
      passes<!kBf16, NT>(pg, gb, gs, xb, xs);
      if (gated) passes<!kBf16, NT>(pu, ub, us, xb, xs);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accg[t][e] += pg[t][e];
        accu[t][e] += pu[t][e];
      }
  };
  // the split partial of one token tile: rows item*64 + r, tokens of tile tt
  auto store1 = [&](const Cursor& q) {
    const size_t base = (size_t)q.item * kRows;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int s = q.tt * TN + t * 8 + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const size_t o = (base + warp * 16 + gid + 8 * hf) * s_pad + s;
        __stcg(reinterpret_cast<float2*>(gp + o),
               make_float2(accg[t][2 * hf], accg[t][2 * hf + 1]));
        if (gated)
          __stcg(reinterpret_cast<float2*>(up + o),
                 make_float2(accu[t][2 * hf], accu[t][2 * hf + 1]));
        accg[t][2 * hf] = accg[t][2 * hf + 1] = 0.f;
        accu[t][2 * hf] = accu[t][2 * hf + 1] = 0.f;
      }
    }
  };

  {
    Cursor qp, qc;
    start1(qp, blockIdx.x);
    start1(qc, blockIdx.x);
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i) {
      if (qp.item < items1) {
        load1(qp);
        next1(qp);
      }
      cp_commit();
    }
#pragma unroll 1
    while (qc.item < items1) {
      cp_wait<kStages - 2>();
      __syncthreads();
      if (qp.item < items1) {
        load1(qp);
        next1(qp);
      }
      cp_commit();
      compute1(consumed % kStages);
      ++consumed;
      if (qc.c + qc.step >= qc.c1) store1(qc);   // the tile's last chunk
      next1(qc);
    }
    cp_wait<0>();
  }
  produced = consumed = 0;
  if (trace) trace[1] = global_ns();
  grid_barrier(a.bar, 1);
  if (trace) trace[2] = global_ns();

  // =================== phase 2: combine the splits, h, telemetry ==========
  {
    // this block's rows; token windows small enough for the counters
    const int n_lo = (int)((long long)blockIdx.x * nrows / grid);
    const int n_hi = (int)((long long)(blockIdx.x + 1) * nrows / grid);
    int* tel_s = reinterpret_cast<int*>(smem);
    const int win = min(s_pad, kStages * kStage / 12 / 4 * 4);
    const size_t split_stride = (size_t)kRows * s_pad;
    for (int w0 = 0; w0 < s_pad; w0 += win) {
      const int wq = min(win, s_pad - w0) / 4;   // token quads
      if (stats) {
        for (int i = tid; i < wq * 12; i += kThreads) tel_s[i] = 0;
        __syncthreads();
      }
      const int E = (n_hi - n_lo) * wq;
#pragma unroll 1
      for (int e0 = tid; e0 < E; e0 += 2 * kThreads) {
        float4 gv[2], uv[2];
        size_t off[2];
        bool ok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = e0 + j * kThreads;
          ok[j] = e < E;
          const int n = n_lo + (ok[j] ? e / wq : 0);
          const int q = ok[j] ? e % wq : 0;
          off[j] = ((size_t)(n / kRows) * nks * kRows + n % kRows) * s_pad +
                   w0 + 4 * q;
          gv[j] = uv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int ks = 0; ks < nks; ++ks) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!ok[j]) continue;
            gv[j] = add4(gv[j], __ldcg(reinterpret_cast<const float4*>(
                                    gp + off[j] + ks * split_stride)));
            if (gated)
              uv[j] = add4(uv[j], __ldcg(reinterpret_cast<const float4*>(
                                      up + off[j] + ks * split_stride)));
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!ok[j]) continue;
          const int e = e0 + j * kThreads;
          const int n = n_lo + e / wq, q = e % wq;
          const int gsel = __ldg(sel + n / G);
          const float g4[4] = {gv[j].x, gv[j].y, gv[j].z, gv[j].w};
          const float u4[4] = {uv[j].x, uv[j].y, uv[j].z, uv[j].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = w0 + 4 * q + i;
            const float ga = act_kind == 0 ? fmaxf(g4[i], 0.f)
                                           : (g4[i] > thr ? g4[i] : 0.f);
            const float h = gated ? ga * u4[i] : ga;
            __stcg(ht + (size_t)s * h_stride + n,
                   s < S ? round_to(h, (const XT*)nullptr) : 0.f);
            if (stats && s < S) {
              const bool live = ga > 0.f;
              const bool keep = gm_tok[(size_t)s * n_groups + gsel] <= 0.f;
              const int sl = (s - w0) * 3;
              if (live) atomicAdd(&tel_s[sl + 0], 1);
              if (live && !keep) atomicAdd(&tel_s[sl + 1], 1);
              if (keep) atomicAdd(&tel_s[sl + 2], 1);
            }
          }
        }
      }
      if (stats) {
        __syncthreads();
        for (int i = tid; i < wq * 12; i += kThreads) {
          const int s = w0 + i / 3;
          if (s < S && tel_s[i]) atomicAdd(tel + (size_t)w0 * 3 + i, tel_s[i]);
        }
        __syncthreads();
      }
    }
  }
  // the counters' shared-memory writes before the next bulk copies'
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (trace) trace[3] = global_ns();
  grid_barrier(a.bar, 2);
  if (trace) trace[4] = global_ns();

  // =================== phase 3: slice partials of h Wd ====================
  const int n_ct = (d + kCols - 1) / kCols;
  const int nsl = slices(grid, n_ct, nrows);
  const int items2 = nsl * n_ct;
  const int units = (nrows + kSliceUnit - 1) / kSliceUnit;
  auto slice_lo = [&](int sl) {
    return min(nrows, (int)((long long)sl * units / nsl) * kSliceUnit);
  };
  // item = sl * n_ct + ct: rows [slice_lo(sl), slice_lo(sl + 1)), columns
  // [ct*128, ct*128 + 128); chunks of 32 rows
  auto start2 = [&](Cursor& q, int item) {
    q.item = item;
    q.tt = 0;
    q.c0 = q.c = 0;
    q.step = 1;
    if (item < items2) {
      const int sl = item / n_ct;
      q.c1 = (slice_lo(sl + 1) - slice_lo(sl) + kKR - 1) / kKR;
    }
  };
  auto next2 = [&](Cursor& q) {
    if ((q.c += q.step) < q.c1) return;
    q.c = 0;
    if (++q.tt < ntt) return;
    start2(q, q.item + grid);
  };
  // one ring step: warp 0 bulk-copies the Wd rows, everyone the hT tile
  auto load2 = [&](const Cursor& q) {
    const int stage = produced % kStages;
    float* wd_s = reinterpret_cast<float*>(smem + stage * kStage);
    float* h_s = wd_s + kKR * kDStride;
    const int sl = q.item / n_ct, ct = q.item - sl * n_ct;
    const int r_lo = slice_lo(sl) + q.c * kKR;
    const int r_hi = slice_lo(sl + 1);
    if (warp == 0) {
      const int rows = min(kKR, r_hi - r_lo);
      const uint32_t nb = min(kCols, d - ct * kCols) * 4;
      const uint32_t bar = smem_addr(&full[stage]);
      if (lane == 0) mbar_expect(bar, rows * nb);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane < rows)
        bulk_copy(smem_addr(wd_s + lane * kDStride),
                  wd + row_of(r_lo + lane) * d + ct * kCols, nb, bar);
    }
    // hT rows: TN tokens x 32 selected rows (8 segments of 4 rows)
    for (int idx = tid; idx < TN * (kKR / 4); idx += kThreads) {
      const int t = idx >> 3, seg = idx & 7;
      const int n = r_lo + seg * 4;
      const int valid = min(max(r_hi - n, 0), 4);
      cp16(smem_addr(h_s + swz32(t, seg)),
           ht + (valid ? (size_t)(q.tt * TN + t) * h_stride + n : 0),
           4 * valid);
    }
    ++produced;
  };
  float acc[kMT][NT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
  auto compute2 = [&](int stage) {
    const float* wd_s = reinterpret_cast<const float*>(smem + stage * kStage);
    const float* h_s = wd_s + kKR * kDStride;
    float p[kMT][NT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[m][t][e] = 0.f;
    const int c2 = 2 * (gid & 1);
#pragma unroll
    for (int kk = 0; kk < kKR / 8; ++kk) {
      const int seg = 2 * kk + (tig >> 1), w2 = 2 * (tig & 1);
      // B = hT: tokens t*8 + gid, K positions tig, tig + 4
      uint32_t hb[NT][2], hs[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float2 v = *reinterpret_cast<const float2*>(
            h_s + swz32(t * 8 + gid, seg) + w2);
        if (kBf16) {   // h was rounded to bf16: exact in TF32
          hb[t][0] = __float_as_uint(v.x);
          hb[t][1] = __float_as_uint(v.y);
        } else {
          split(v.x, hb[t][0], hs[t][0]);
          split(v.y, hb[t][1], hs[t][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        // M positions gid, gid + 8 <- columns of m-tile m: 2 gid, + 1;
        // K positions tig, tig + 4 <- rows kk*8 + 2 tig, + 1
        const int wo = (kk * 8 + 2 * tig) * kDStride + (warp * kMT + m) * 16 +
                       2 * gid;
        uint32_t ab[4], as[4];
        const float2 v0 = *reinterpret_cast<const float2*>(wd_s + wo);
        const float2 v1 =
            *reinterpret_cast<const float2*>(wd_s + wo + kDStride);
        split(v0.x, ab[0], as[0]);   // (m gid, k tig)
        split(v0.y, ab[1], as[1]);   // (m gid + 8, k tig)
        split(v1.x, ab[2], as[2]);   // (m gid, k tig + 4)
        split(v1.y, ab[3], as[3]);   // (m gid + 8, k tig + 4)
        passes<!kBf16, NT>(p[m], ab, as, hb, hs);
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] += p[m][t][e];
  };
  // C: (m gid, n 2 tig (+1)) -> column 2 gid, (m gid + 8) -> 2 gid + 1
  auto store2 = [&](const Cursor& q) {
    const int sl = q.item / n_ct, ct = q.item - sl * n_ct;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int col = ct * kCols + (warp * kMT + m) * 16 + 2 * gid;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = q.tt * TN + t * 8 + 2 * tig + e;
          if (s < S && col < d)
            __stcg(reinterpret_cast<float2*>(
                       part + ((size_t)sl * S + s) * d + col),
                   make_float2(acc[m][t][e], acc[m][t][2 + e]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
      }
    }
  };
  {
    Cursor qp, qc;
    start2(qp, blockIdx.x);
    start2(qc, blockIdx.x);
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i) {
      if (qp.item < items2) {
        load2(qp);
        next2(qp);
      }
      cp_commit();
    }
#pragma unroll 1
    while (qc.item < items2) {
      wait_stage();
      cp_wait<kStages - 2>();
      __syncthreads();
      if (qp.item < items2) {
        load2(qp);
        next2(qp);
      }
      cp_commit();
      compute2(consumed % kStages);
      ++consumed;
      if (qc.c + 1 == qc.c1) store2(qc);
      next2(qc);
    }
    cp_wait<0>();
  }
  if (trace) trace[5] = global_ns();
  grid_barrier(a.bar, 3);
  if (trace) trace[6] = global_ns();

  // =================== phase 4: y = sum of the slices, in order ===========
  // 4 columns a thread (d % 4 == 0), the slices' loads issued together
  const size_t total4 = (size_t)S * d / 4;
  const float4* part4 = reinterpret_cast<const float4*>(part);
  float4* y4 = reinterpret_cast<float4*>(a.y);
  for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < total4;
       e += (size_t)grid * kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sl = 0; sl < nsl; ++sl)
      v = add4(v, __ldcg(part4 + sl * total4 + e));
    y4[e] = v;
  }
  if (trace) trace[7] = global_ns();
}

template <typename XT, int NT>
cudaError_t occupancy(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel<XT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chunk_kernel<XT, NT>, kThreads, smem);
}

template <typename XT, int NT>
cudaError_t launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel<XT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  Args args = a;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)chunk_kernel<XT, NT>,
                                  dim3(grid), dim3(kThreads), argv,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dispatch on the x dtype (0 float32, 1 bfloat16) and NT (1, 2, 4, 8)
template <template <typename, int> class F, typename... Ts>
cudaError_t dispatch(int x_dtype, int nt, Ts... ts) {
#define MLP_TC_CASE(XT, N) \
  if (nt == N) return F<XT, N>::run(ts...);
  if (x_dtype == 0) {
    MLP_TC_CASE(float, 1) MLP_TC_CASE(float, 2) MLP_TC_CASE(float, 4)
    MLP_TC_CASE(float, 8)
  } else if (x_dtype == 1) {
    MLP_TC_CASE(__nv_bfloat16, 1) MLP_TC_CASE(__nv_bfloat16, 2)
    MLP_TC_CASE(__nv_bfloat16, 4) MLP_TC_CASE(__nv_bfloat16, 8)
  }
#undef MLP_TC_CASE
  return cudaErrorInvalidValue;
}

template <typename XT, int NT>
struct Occupancy {
  static cudaError_t run(int smem, int* blocks) {
    return occupancy<XT, NT>(smem, blocks);
  }
};
template <typename XT, int NT>
struct Launch {
  static cudaError_t run(const Args* a, int grid, int smem, cudaStream_t s) {
    return launch<XT, NT>(*a, grid, smem, s);
  }
};

}  // namespace tc
}  // namespace mlp
