// The chunk MLP on Hopper's tensor cores, for float32 weights (instantiated
// by fused_sparse_mlp_chunk.cu) and int8 weights with float32 scales
// (fused_sparse_mlp_chunk_q.cu); see their notes for what each replaces
// and what bounds it.  The template parameter WT picks the weight type;
// both share the ring, the items, the split of d, the combine, the slices,
// the grid barriers and the phase trace, and differ in the tile loads,
// the scale loads, the conversion into MMA fragments, the pass counts and
// the scale epilogues.
//
// For the first `count` of the C selected row groups sel[0..C) and the S
// rows of a chunk x (float32 or bfloat16) it computes
//     g = act(x Wg[rows]^T),  h = g * (x Wu[rows]^T)  (h = g when ungated)
//     float32 weights: h rounded to x's dtype (a no-op for float32 x)
//     y = h Wd[rows]                                   (float32)
// (int8: the reference's per-quant-group scales, fused_sparse_mlp_chunk_q.cu)
// and, when tel is given, the per-token int32 counters (actual, false_neg,
// realized): rows with g > 0, of those the ones whose own group margin
// gm_tok[s, sel] said skip, and G * groups the token itself kept.
//
// Numerics: float32 products from TF32 MMAs.  Every float32 operand v is
// split into big = rna_tf32(v) and small = rna_tf32(v - big) (cvt.rna:
// round to nearest, ties away; the 13 low mantissa bits of each part are
// zero, so the MMA drops nothing).  v - big is exact, so
// |v - big - small| <= 2^-22 |v|.  A bf16 value, and an int8 one, is exact
// in TF32 and is not split.  Each product is a sum of exact TF32 x TF32
// products:
//   float32 weights, bf16 x:    x.W  = x.Wsmall + x.Wbig         (2 MMAs)
//              h.Wd = h.Wdsmall + h.Wdbig  (h rounded to bf16: exact)
//   float32 weights and x: a.b  = asmall.bbig + abig.bsmall + abig.bbig
//              (3 MMAs; the dropped asmall.bsmall is below 2^-22 |a||b|)
//   int8 weights: x.W = x.W (bf16 x: one bf16 m16n8k16 MMA, int8 exact in
//              bf16) or xsmall.W + xbig.W (float32 x, 2 TF32 MMAs);
//              h.Wd = hsmall.Wd + hbig.Wd (h float32, 2 TF32 MMAs)
// The MMA aligns its addends to the largest one and truncates what falls
// below it.  Chaining a whole dot product through the MMAs would drop up
// to an ulp of the running sum at every step, always toward zero; so each
// stage's passes (32 deep; int8: each quant slab's piece of a 128-column
// stage, and each selection group) are summed by the MMAs into a zeroed
// fragment, which is then added to the float32 sum with round-to-nearest
// adds (int8: multiplied by its scale and added in one fmaf).
//
// Work split: one cooperative launch of `grid` blocks of 4 warps (every
// block resident), four phases between grid barriers, fixed-order sums,
// no float atomics.
//   1. gate/up.  An item is 64 consecutive selected rows x a split of d's
//      chunks (32 columns; int8 128) (split ks takes chunks ks, ks +
//      splits, ..., so the splits of a row tile read neighbouring pieces of
//      the same rows at once; the split count grows while the grid has
//      room for more items, so a short selection still fills the card).
//      Each warp owns 16 rows: m16n8k8 MMAs with M over weight rows, N over
//      the token tile's tokens, K over d.  Weight and x tiles of a chunk
//      stream through a ring (4 stages; int8 3, so that two blocks of 32 KB
//      stages fit an SM, with the stage's first-slab scales in it) of
//      16-byte cp.asyncs in shared memory; the ring
//      runs on across items and token tiles, so a block has loads in
//      flight until its last tile.  A chunk longer than one token tile (64
//      tokens) walks its token tiles inside the item, so each weight row
//      leaves device memory once and is read again from L2.  Each split's
//      partial sums go to scratch.
//   2. combine.  Every block takes a share of the selected rows: the
//      splits added in split order, act, h rounded (int8: split into its
//      two TF32 parts) and written transposed (hT: token-major), the
//      telemetry counted in shared memory and added with one global integer
//      atomicAdd per token and counter.
//   3. down.  An item is 128 columns of d x a slice of the selected rows
//      (slices start on a multiple of 8 rows; int8 of lcm(8, G), so that a
//      group never straddles two); yT = WdT hT with M over columns, N over
//      tokens, K over rows (each warp two m16 tiles), Wd and hT tiles of 32
//      rows through the same ring: float32 Wd by bulk copies (the TMA unit,
//      one 512-byte copy a row, completing on a stage's mbarrier), int8 Wd
//      (128-byte row pieces), hT and the K steps' scale rows by cp.async,
//      in as many of down's smaller stages as the ring holds.  Each slice's
//      partial goes to scratch.
//   4. y = the sum of the slice partials in slice order.
// Only count*G rows of each matrix are read: items past the count do not
// exist, which is where a short selection saves its bytes.
//
// Fragments: the MMA sums over its K in any order.  float32 weights: lane
// tig takes K positions tig and tig + 4 from two adjacent columns (2 tig,
// 2 tig + 1) and loads both with one 64-bit shared-memory read; down also
// pairs its M positions gid and gid + 8 on columns 2 gid, 2 gid + 1.  int8
// weights: lane tig reads 8 adjacent columns of a 32-column group (one
// 64-bit read of int8, one 128-bit read of bf16 x); a TF32 K step j takes
// columns 8 tig + 2 j and + 1, a bf16 K step j columns 8 tig + 4 j .. + 3,
// so bf16 x goes to the MMA as it lies in shared memory.  Down's lane reads
// 4 adjacent int8 columns of a row (one 32-bit read for both m16 tiles) and
// hT's (big, small) pairs of two rows in one 128-bit read.  The cp.async
// tiles' 16-byte segments are XOR-swizzled by row and the Wd rows are
// padded (132 floats; int8 144 bytes), so the reads hit distinct banks.
// int8 keeps the selection in shared memory: every stage's row lookups
// read it.
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
// int8 weights: gate/up stages of 128 columns (64 x 128 bytes a matrix),
// down's Wd tile rows padded to 144 bytes, 3 stages
constexpr int kKCQ = 128;
constexpr int kDStrideQ = kCols + 16;
constexpr int kStagesQ = 3;
constexpr int kSlotBytes = kCols * 4;   // down: one scale row of the tile

__host__ __device__ constexpr int stage_bytes(int nt, bool bf16) {
  // max of gate/up (Wg, Wu, x) and down (Wd, hT) tiles
  return 2 * kRows * kKC * 4 + 8 * nt * kKC * (bf16 ? 2 : 4) >
                 kKR * kDStride * 4 + 8 * kMaxNT * kKR * 4
             ? 2 * kRows * kKC * 4 + 8 * nt * kKC * (bf16 ? 2 : 4)
             : kKR * kDStride * 4 + 8 * kMaxNT * kKR * 4;
}
// int8: down's stage (Wd: 32 x 144 bytes; hT: 8*nt tokens x 32 (big,
// small) pairs; 4 scale rows of 128 floats), and the ring's stage, the max
// of gate/up's (Wg, Wu: 64 x 128 bytes; x: 8*nt tokens x 128 values; the
// 64 rows' scales of the stage's first slab, gate then up) and down's.
// Down cuts the same ring into as many of its smaller stages as fit, at
// most 8.  The selection follows the ring (sel_bytes).
__host__ __device__ constexpr int down_stage_bytes_q(int nt) {
  return kKR * kDStrideQ + 8 * nt * kKR * 8 + (kKR / 8) * kSlotBytes;
}
__host__ __device__ constexpr int gu_stage_bytes_q(int nt, bool bf16) {
  return 2 * kRows * kKCQ + 8 * nt * kKCQ * (bf16 ? 2 : 4) + 2 * kRows * 4;
}
__host__ __device__ constexpr int stage_bytes_q(int nt, bool bf16) {
  return gu_stage_bytes_q(nt, bf16) > down_stage_bytes_q(nt)
             ? gu_stage_bytes_q(nt, bf16)
             : down_stage_bytes_q(nt);
}
__host__ __device__ constexpr int down_stages_q(int nt, bool bf16) {
  return kStagesQ * stage_bytes_q(nt, bf16) / down_stage_bytes_q(nt) < 8
             ? kStagesQ * stage_bytes_q(nt, bf16) / down_stage_bytes_q(nt)
             : 8;
}
// int8: the selection's C group ids, copied to shared memory after the ring
__host__ __device__ constexpr int sel_bytes(int C) {
  return (C * 4 + 15) / 16 * 16;
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
// int8 tiles, byte offsets: a 64 x 128 weight tile (8 segments a row); x
// rows of 128 bf16 (16 segments) or float32 (32 segments); hT rows of 32
// (big, small) pairs (16 segments)
__device__ __forceinline__ int swz_w8(int row, int seg) {
  return row * 128 + ((seg ^ ((row & 3) << 1)) << 4);
}
__device__ __forceinline__ int swz_xb(int row, int seg) {
  return row * 256 + ((seg ^ ((row & 1) << 2)) << 4);
}
__device__ __forceinline__ int swz_xf(int row, int seg) {
  return row * 512 + ((seg ^ (row & 1)) << 4);
}
__device__ __forceinline__ int swz_h(int row, int seg) {
  return row * 256 + ((seg ^ ((row & 1) << 2)) << 4);
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
// c = a b (the accumulator starts at 0)
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// c += a b, m16n8k16, bf16 in, float32 accumulators
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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
// 16 bytes of int8 weights of which the first n (a multiple of 4) exist:
// one 16-byte copy where rows are 16-byte aligned (d % 16 == 0), else four
// 4-byte copies
__device__ __forceinline__ void cp_w8(uint32_t dst, const int8_t* src, int n,
                                      bool aligned16) {
  if (aligned16) {
    cp16(dst, src, n);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * i),
                 "l"(src + (n > 4 * i ? 4 * i : 0)), "r"(n > 4 * i ? 4 : 0));
}
// byte b of w (a signed int8) as a float32 whose bits are exact TF32:
// 0x4B000000 | (byte ^ 0x80) is 2^23 + byte + 128
__device__ __forceinline__ uint32_t i8_tf32(uint32_t w, int b) {
  const uint32_t f = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | b);
  return __float_as_uint(__uint_as_float(f) - 8388736.f);
}
// y + p * s, rounded once to nearest (the reference's multiply and add,
// the product kept exact)
__device__ __forceinline__ float add_scaled(float y, float p, float s) {
  return __fmaf_rn(p, s, y);
}
__device__ __forceinline__ float i8_f(uint32_t w, int b) {
  return __uint_as_float(i8_tf32(w, b));
}
// two floats as a bf16x2 word, lo in the low half (exact for int8 values)
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
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
  const void* wg;         // float32 or int8 (the kernel's WT)
  const void* wu;         // null: ungated
  const void* wd;
  const float* wg_s;      // int8: (k, nq) scales of wg, wu; (k/qg, d) of wd
  const float* wu_s;
  const float* wd_s;
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
  int qg, nq;             // int8: quant group width, d / qg
  int slice_unit;         // down's slices start on multiples of it
};

template <typename WT, typename XT, int NT>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const Args a) {
  constexpr bool kBf16 = std::is_same<XT, __nv_bfloat16>::value;
  constexpr bool kQ = std::is_same<WT, int8_t>::value;
  constexpr int TN = 8 * NT;              // tokens of a token tile
  constexpr int KC = kQ ? kKCQ : kKC;     // columns of d a gate/up stage
  constexpr int kNS = kQ ? kStagesQ : kStages;
  constexpr int kStage =
      kQ ? stage_bytes_q(NT, kBf16) : stage_bytes(NT, kBf16);
  // down's ring: int8 cuts the same bytes into more, smaller stages
  constexpr int kNS2 = kQ ? down_stages_q(NT, kBf16) : kStages;
  constexpr int kStage2 = kQ ? down_stage_bytes_q(NT) : kStage;
  extern __shared__ __align__(16) unsigned char smem[];
  // one mbarrier a ring stage: the bulk copies of its weight tile
  __shared__ __align__(8) uint64_t full[kStages];
  // kernel parameters as locals: the lambdas below capture these
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const WT* __restrict__ wg = static_cast<const WT*>(a.wg);
  const WT* __restrict__ wu = static_cast<const WT*>(a.wu);
  const WT* __restrict__ wd = static_cast<const WT*>(a.wd);
  const float* __restrict__ wgs = a.wg_s;
  const float* __restrict__ wus = a.wu_s;
  const float* __restrict__ wds = a.wd_s;
  const int qg = a.qg, nq = a.nq;
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
  // (int8: every copy zero-fills what does not exist, so no zeroing.)
  for (int i = tid; i < (kQ ? 0 : kNS * kStage / 16); i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kQ) {
    int32_t* s_sel = reinterpret_cast<int32_t*>(smem + kNS * kStage);
    for (int i = tid; i < a.C; i += kThreads) s_sel[i] = __ldg(sel + i);
  }
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
  // int8: the selection from shared memory (the row lookups are on every
  // stage's load path)
  const int32_t* sel_s = reinterpret_cast<const int32_t*>(smem + kNS * kStage);
  auto sel_at = [&](int i) -> int {
    if constexpr (kQ) return sel_s[i];
    else return __ldg(sel + i);
  };
  auto row_of = [&](int n) -> size_t {
    if (g_shift >= 0)
      return ((size_t)sel_at(n >> g_shift) << g_shift) + (n & (G - 1));
    return (size_t)sel_at(n / G) * G + n % G;
  };

  // =================== phase 1: gate/up split partials ====================
  const int kchunks = (d + KC - 1) / KC;
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

  // ---- int8 weights: 128-column stages, the scales on each slab's sum ----
  const bool w16 = d % 16 == 0;           // 16-byte copies of weight rows
  // one ring step: 16-byte cp.asyncs of the rows' 128-byte pieces and of x
  auto load1q = [&](const Cursor& q) {
    unsigned char* st = smem + (produced % kNS) * kStage;
    const int8_t* w8g = reinterpret_cast<const int8_t*>(wg);
    const int8_t* w8u = reinterpret_cast<const int8_t*>(wu);
    const int rt = q.item / nks;
    const int col0 = q.c * KC;
#pragma unroll
    for (int j = 0; j < kRows * 8 / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx >> 3, seg = idx & 7;
      const int n = rt * kRows + r, col = col0 + seg * 16;
      const int nb = n < nrows && col < d ? min(16, d - col) : 0;
      const size_t off = nb ? row_of(n) * d + col : 0;
      cp_w8(smem_addr(st + swz_w8(r, seg)), w8g + off, nb, w16);
      if (gated)
        cp_w8(smem_addr(st + kRows * KC + swz_w8(r, seg)), w8u + off, nb, w16);
    }
    // the first slab's scales of the 64 rows: gate, then up
    {
      float* sc = reinterpret_cast<float*>(st + 2 * kRows * KC +
                                           TN * KC * (kBf16 ? 2 : 4));
      const int r = tid & (kRows - 1), n = rt * kRows + r;
      const float* s = tid < kRows ? wgs : wus;
      const bool ok = n < nrows && (tid < kRows || gated);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(sc + tid)),
                   "l"(s + (ok ? row_of(n) * nq + col0 / qg : 0)),
                   "r"(ok ? 4 : 0));
    }
    unsigned char* xs = st + 2 * kRows * KC;
    const int tok0 = q.tt * TN;
    if (!kBf16) {        // 32 segments of 4 floats a token
      for (int idx = tid; idx < TN * 32; idx += kThreads) {
        const int r = idx >> 5, seg = idx & 31;
        const int s = tok0 + r, col = col0 + seg * 4;
        const bool ok = s < S && col < d;
        cp16(smem_addr(xs + swz_xf(r, seg)),
             x + (ok ? (size_t)s * d + col : 0), ok ? 16 : 0);
      }
    } else if (d % 8 == 0) {   // 16 segments of 8 values a token
      for (int idx = tid; idx < TN * 16; idx += kThreads) {
        const int r = idx >> 4, seg = idx & 15;
        const int s = tok0 + r, col = col0 + seg * 8;
        const bool ok = s < S && col < d;
        cp16(smem_addr(xs + swz_xb(r, seg)),
             x + (ok ? (size_t)s * d + col : 0), ok ? 16 : 0);
      }
    } else {              // rows only 8-byte aligned: halves of segments
      for (int idx = tid; idx < TN * 32; idx += kThreads) {
        const int r = idx >> 5, hs = idx & 31;
        const int s = tok0 + r, col = col0 + hs * 4;
        const bool ok = s < S && col < d;
        cp8(smem_addr(xs + swz_xb(r, hs >> 1) + (hs & 1) * 8),
            x + (ok ? (size_t)s * d + col : 0), ok);
      }
    }
    ++produced;
  };
  // One stage, columns [col0, col0 + 128) in 32-column groups: lane tig
  // reads 8 adjacent columns 8 tig .. 8 tig + 7 of its rows and tokens.
  // The int8 weights are exact in bf16 and in TF32: bf16 x takes one bf16
  // m16n8k16 MMA a product (step16), float32 x two TF32 m16n8k8 MMAs, x
  // small then x big (step).  Each quant slab's products go into the
  // zeroed fragments pg/pu; where the slab ends (or the stage), flush()
  // scales each fragment row by its weight row's scale and adds it to the
  // float32 sum: the reference's _qdot order.  A slab that does not cover
  // whole groups (qg % 32 != 0) runs its groups' K steps with the other
  // slabs' columns masked to 0.
  float pg[NT][4], pu[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) pg[t][e] = pu[t][e] = 0.f;
  auto compute1q = [&](int stage, const Cursor& q) {
    const unsigned char* st = smem + stage * kStage;
    const unsigned char* xs = st + 2 * kRows * KC;
    const int rt = q.item / nks;
    const int col0 = q.c * KC, c_end = min(col0 + KC, d);
    const int r0 = warp * 16 + gid;
    const int na = rt * kRows + r0, nb = na + 8;
    const float* sc = reinterpret_cast<const float*>(
        xs + TN * KC * (kBf16 ? 2 : 4));
    // another slab's scale (qg < 128), from global memory
    auto scale = [&](const float* s, int n, int qq) {
      return n < nrows ? __ldg(s + row_of(n) * nq + qq) : 0.f;
    };
    // the scales of the stage's first slab came with the stage
    const int qa = col0 / qg;
    const float sga = sc[r0], sgb = sc[r0 + 8];
    const float sua = sc[kRows + r0], sub = sc[kRows + r0 + 8];
    auto flush = [&](int qq) {
      float g0 = sga, g1 = sgb, u0 = sua, u1 = sub;
      if (qq != qa) {
        g0 = scale(wgs, na, qq);
        g1 = scale(wgs, nb, qq);
        if (gated) {
          u0 = scale(wus, na, qq);
          u1 = scale(wus, nb, qq);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accg[t][e] = add_scaled(accg[t][e], pg[t][e], e < 2 ? g0 : g1);
          if (gated)
            accu[t][e] = add_scaled(accu[t][e], pu[t][e], e < 2 ? u0 : u1);
          pg[t][e] = pu[t][e] = 0.f;
        }
    };
#pragma unroll 1
    for (int g = 0; g < KC / 32; ++g) {
      const int gc0 = col0 + 32 * g;
      if (gc0 >= c_end) break;
      // A: 8 bytes of rows r0 and r0 + 8
      const int wo = 2 * g + (tig >> 1), wh = 8 * (tig & 1);
      const uint2 ga =
          *reinterpret_cast<const uint2*>(st + swz_w8(r0, wo) + wh);
      const uint2 gb =
          *reinterpret_cast<const uint2*>(st + swz_w8(r0 + 8, wo) + wh);
      uint2 ua = make_uint2(0, 0), ub = make_uint2(0, 0);
      if (gated) {
        ua = *reinterpret_cast<const uint2*>(st + kRows * KC +
                                             swz_w8(r0, wo) + wh);
        ub = *reinterpret_cast<const uint2*>(st + kRows * KC +
                                             swz_w8(r0 + 8, wo) + wh);
      }
      // bf16 x: the 8 values of tokens t*8 + gid, one 16-byte read a tile
      uint4 xv[NT];
      if (kBf16) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
          xv[t] = *reinterpret_cast<const uint4*>(
              xs + swz_xb(t * 8 + gid, 4 * g + tig));
      }
      // float32 x: TF32 K step j (0..3) takes columns 8 tig + 2 j (K
      // position tig) and 8 tig + 2 j + 1 (tig + 4); the columns outside
      // [l, h) of the group masked
      auto step = [&](int j, bool masked, int l, int h) {
        const uint32_t wga = j < 2 ? ga.x : ga.y, wgb = j < 2 ? gb.x : gb.y;
        const uint32_t wua = j < 2 ? ua.x : ua.y, wub = j < 2 ? ub.x : ub.y;
        const int b0 = 2 * (j & 1);
        const int c = 8 * tig + 2 * j;
        const bool in0 = !masked || (c >= l && c < h);
        const bool in1 = !masked || (c + 1 >= l && c + 1 < h);
        uint32_t ag[4], au[4];
        ag[0] = in0 ? i8_tf32(wga, b0) : 0u;        // (row gid, k tig)
        ag[1] = in0 ? i8_tf32(wgb, b0) : 0u;        // (row gid + 8, k tig)
        ag[2] = in1 ? i8_tf32(wga, b0 + 1) : 0u;    // (row gid, k tig + 4)
        ag[3] = in1 ? i8_tf32(wgb, b0 + 1) : 0u;
        if (gated) {
          au[0] = in0 ? i8_tf32(wua, b0) : 0u;
          au[1] = in0 ? i8_tf32(wub, b0) : 0u;
          au[2] = in1 ? i8_tf32(wua, b0 + 1) : 0u;
          au[3] = in1 ? i8_tf32(wub, b0 + 1) : 0u;
        }
        // B: tokens t*8 + gid, K positions tig, tig + 4
        uint32_t xb[NT][2], xsm[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (kBf16) {
            const uint32_t v = j == 0 ? xv[t].x : j == 1 ? xv[t].y
                             : j == 2 ? xv[t].z : xv[t].w;
            xb[t][0] = v << 16;
            xb[t][1] = v & 0xffff0000u;
          } else {
            const float4 v = *reinterpret_cast<const float4*>(
                xs + swz_xf(t * 8 + gid, 8 * g + 2 * tig + (j >> 1)));
            split(j & 1 ? v.z : v.x, xb[t][0], xsm[t][0]);
            split(j & 1 ? v.w : v.y, xb[t][1], xsm[t][1]);
          }
        }
        if (!kBf16) {
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            mma(pg[t], ag, xsm[t][0], xsm[t][1]);
            if (gated) mma(pu[t], au, xsm[t][0], xsm[t][1]);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          mma(pg[t], ag, xb[t][0], xb[t][1]);
          if (gated) mma(pu[t], au, xb[t][0], xb[t][1]);
        }
      };
      // bf16 x: K step j (0, 1) of m16n8k16 takes columns 8 tig + 4 j and
      // + 1 (K positions 2 tig, 2 tig + 1) and + 2, + 3 (2 tig + 8, + 9),
      // the int8 weights as bf16 (exact) and x as it lies in shared memory
      auto step16 = [&](int j, bool masked, int l, int h) {
        const uint32_t wga = j ? ga.y : ga.x, wgb = j ? gb.y : gb.x;
        const uint32_t wua = j ? ua.y : ua.x, wub = j ? ub.y : ub.x;
        const int c = 8 * tig + 4 * j;
        bool in[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          in[e] = !masked || (c + e >= l && c + e < h);
        auto pk = [&](uint32_t w, int b) {
          return bf2(in[b] ? i8_f(w, b) : 0.f,
                     in[b + 1] ? i8_f(w, b + 1) : 0.f);
        };
        uint32_t ag[4], au[4];
        ag[0] = pk(wga, 0);    // (row gid, k 2 tig, 2 tig + 1)
        ag[1] = pk(wgb, 0);    // (row gid + 8, ...)
        ag[2] = pk(wga, 2);    // (row gid, k 2 tig + 8, 2 tig + 9)
        ag[3] = pk(wgb, 2);
        if (gated) {
          au[0] = pk(wua, 0);
          au[1] = pk(wub, 0);
          au[2] = pk(wua, 2);
          au[3] = pk(wub, 2);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint32_t b0 = j ? xv[t].z : xv[t].x;
          const uint32_t b1 = j ? xv[t].w : xv[t].y;
          mma16(pg[t], ag, b0, b1);
          if (gated) mma16(pu[t], au, b0, b1);
        }
      };
      // the K steps of the group: 2 of 16 (bf16 x) or 4 of 8 (float32 x)
      constexpr int kSteps = kBf16 ? 2 : 4, kLaneCols = kBf16 ? 4 : 2;
      auto kstep = [&](int j, bool masked, int l, int h) {
        if constexpr (kBf16) step16(j, masked, l, h);
        else step(j, masked, l, h);
      };
      if (qg % 32 == 0) {     // the group lies inside one slab
#pragma unroll
        for (int j = 0; j < kSteps; ++j) kstep(j, false, 0, 32);
        if (gc0 + 32 >= c_end || (gc0 + 32) % qg == 0) flush(gc0 / qg);
      } else {                // the slabs of the group, one after another
        const int g_end = min(gc0 + 32, c_end);
#pragma unroll 1
        for (int lo = gc0; lo < g_end;) {
          const int qq = lo / qg;
          const int hi = min((qq + 1) * qg, g_end);
          const int l = lo - gc0, h = hi - gc0;
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            bool any = false;   // does step j have a column in [l, h)?
#pragma unroll
            for (int t4 = 0; t4 < 4; ++t4)
              any |= max(l, 8 * t4 + kLaneCols * j) <
                     min(h, 8 * t4 + kLaneCols * (j + 1));
            if (any) kstep(j, true, l, h);
          }
          if (hi == (qq + 1) * qg || hi == c_end) flush(qq);
          lo = hi;
        }
      }
    }
  };

  {
    Cursor qp, qc;
    start1(qp, blockIdx.x);
    start1(qc, blockIdx.x);
#pragma unroll 1
    for (int i = 0; i < kNS - 1; ++i) {
      if (qp.item < items1) {
        if constexpr (kQ) load1q(qp); else load1(qp);
        next1(qp);
      }
      cp_commit();
    }
#pragma unroll 1
    while (qc.item < items1) {
      cp_wait<kNS - 2>();
      __syncthreads();
      if (qp.item < items1) {
        if constexpr (kQ) load1q(qp); else load1(qp);
        next1(qp);
      }
      cp_commit();
      if constexpr (kQ) compute1q(consumed % kNS, qc);
      else compute1(consumed % kStages);
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
    const int win = min(s_pad, kNS * kStage / 12 / 4 * 4);
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
          const int gsel = sel_at(n / G);
          const float g4[4] = {gv[j].x, gv[j].y, gv[j].z, gv[j].w};
          const float u4[4] = {uv[j].x, uv[j].y, uv[j].z, uv[j].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = w0 + 4 * q + i;
            const float ga = act_kind == 0 ? fmaxf(g4[i], 0.f)
                                           : (g4[i] > thr ? g4[i] : 0.f);
            const float h = gated ? ga * u4[i] : ga;
            if constexpr (kQ) {   // h stays float32: its two TF32 parts
              uint32_t hb = 0, hs = 0;
              if (s < S) split(h, hb, hs);
              __stcg(reinterpret_cast<float2*>(ht) + (size_t)s * h_stride + n,
                     make_float2(__uint_as_float(hb), __uint_as_float(hs)));
            } else {
              __stcg(ht + (size_t)s * h_stride + n,
                     s < S ? round_to(h, (const XT*)nullptr) : 0.f);
            }
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
  const int unit = a.slice_unit;
  const int units = (nrows + unit - 1) / unit;
  auto slice_lo = [&](int sl) {
    if constexpr (kQ)   // sl * units < 2^31: 32-bit division
      return min(nrows, sl * units / nsl * unit);
    else
      return min(nrows, (int)((long long)sl * units / nsl) * unit);
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
  // ---- int8 weights: Wd by cp.async, h in two parts, scales per group ----
  // Each group's products go into the zeroed fragments pd, which are scaled
  // per column by the group's scale row and added to acc where the group
  // ends: the reference's (h_g Wd_g) * wd_s[q(g)], added in selection order.
  // With G % 8 == 0 a K step lies inside one group and its scale row comes
  // through the ring (a slot per K step); otherwise a K step is cut into
  // its groups' rows (the other rows of h masked to 0) and the scale rows
  // are read from global memory.  The groups never straddle a slice: the
  // slices start on multiples of lcm(8, G).
  const bool g8 = G % 8 == 0;
  auto load2q = [&](const Cursor& q) {
    unsigned char* st = smem + (produced % kNS2) * kStage2;
    unsigned char* hs_ = st + kKR * kDStrideQ;
    unsigned char* slots = hs_ + TN * kKR * 8;
    const int8_t* w8d = reinterpret_cast<const int8_t*>(wd);
    const int sl = q.item / n_ct, ct = q.item - sl * n_ct;
    const int r_lo = slice_lo(sl) + q.c * kKR;
    const int r_hi = slice_lo(sl + 1);
    // Wd: 32 rows x 8 segments of 16 columns
#pragma unroll
    for (int j = 0; j < kKR * 8 / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx >> 3, seg = idx & 7;
      const int n = r_lo + r, col = ct * kCols + seg * 16;
      const int nb = n < r_hi && col < d ? min(16, d - col) : 0;
      cp_w8(smem_addr(st + r * kDStrideQ + seg * 16),
            w8d + (nb ? row_of(n) * d + col : 0), nb, w16);
    }
    // hT: TN tokens x 16 segments of two (big, small) pairs
    for (int idx = tid; idx < TN * 16; idx += kThreads) {
      const int t = idx >> 4, seg = idx & 15;
      const int n = r_lo + 2 * seg;
      const int valid = min(max(r_hi - n, 0), 2);
      cp16(smem_addr(hs_ + swz_h(t, seg)),
           ht + (valid ? ((size_t)(q.tt * TN + t) * h_stride + n) * 2 : 0),
           8 * valid);
    }
    // the scale row of each K step's group: 4 slots x 32 segments
    if (g8) {
      const int j = tid >> 5, seg = tid & 31;
      const int n = r_lo + 8 * j, col = ct * kCols + seg * 4;
      const bool ok = n < r_hi && col < d;
      cp16(smem_addr(slots + j * kSlotBytes + seg * 16),
           wds + (ok ? row_of(n) / qg * d + col : 0), ok ? 16 : 0);
    }
    ++produced;
  };
  float pd[kMT][NT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[m][t][e] = 0.f;
  // M positions: m-tile m's gid <- column 4 gid + 2 m, gid + 8 <- 4 gid +
  // 2 m + 1 of the warp's 32 (one 32-bit read gives both m-tiles' A of a
  // row); K positions tig, tig + 4 <- rows 2 tig, 2 tig + 1 of the step
  auto epilogue2 = [&](float4 sc, bool zero) {
    const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][t][e] =
              add_scaled(acc[m][t][e], pd[m][t][e], s4[2 * m + (e >> 1)]);
          if (zero) pd[m][t][e] = 0.f;
        }
  };
  auto compute2q = [&](int stage, const Cursor& q) {
    const unsigned char* st = smem + stage * kStage2;
    const unsigned char* hs_ = st + kKR * kDStrideQ;
    const unsigned char* slots = hs_ + TN * kKR * 8;
    const int sl = q.item / n_ct, ct = q.item - sl * n_ct;
    const int r_lo = slice_lo(sl) + q.c * kKR;
    const int r_hi = slice_lo(sl + 1);
    const int cw = warp * 32 + 4 * gid;     // the lane's 4 columns
#pragma unroll 1
    for (int kk = 0; kk < kKR / 8; ++kk) {
      const int n0 = r_lo + 8 * kk;
      if (n0 >= r_hi) break;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
          st + (8 * kk + 2 * tig) * kDStrideQ + cw);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          st + (8 * kk + 2 * tig + 1) * kDStrideQ + cw);
      uint32_t am[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        am[m][0] = i8_tf32(w0, 2 * m);       // (col 4 gid + 2m, row 2 tig)
        am[m][1] = i8_tf32(w0, 2 * m + 1);   // (col + 1, row 2 tig)
        am[m][2] = i8_tf32(w1, 2 * m);       // (col, row 2 tig + 1)
        am[m][3] = i8_tf32(w1, 2 * m + 1);
      }
      // B = hT: (big, small) of rows 2 tig and 2 tig + 1, tokens t*8 + gid
      uint32_t hb[NT][2], hsm[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            hs_ + swz_h(t * 8 + gid, 4 * kk + tig));
        hb[t][0] = v.x;
        hsm[t][0] = v.y;
        hb[t][1] = v.z;
        hsm[t][1] = v.w;
      }
      // the passes over the rows [lo, hi) of the step (the others masked);
      // fresh: the step starts its group, whose fragments start at 0
      auto run = [&](bool masked, int lo, int hi, bool fresh) {
        const int rr = n0 + 2 * tig;
        const bool in0 = !masked || (rr >= lo && rr < hi);
        const bool in1 = !masked || (rr + 1 >= lo && rr + 1 < hi);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint32_t s0 = in0 ? hsm[t][0] : 0u;
          const uint32_t s1 = in1 ? hsm[t][1] : 0u;
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            if (fresh) mma0(pd[m][t], am[m], s0, s1);
            else mma(pd[m][t], am[m], s0, s1);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint32_t b0 = in0 ? hb[t][0] : 0u;
          const uint32_t b1 = in1 ? hb[t][1] : 0u;
#pragma unroll
          for (int m = 0; m < kMT; ++m) mma(pd[m][t], am[m], b0, b1);
        }
      };
      if (g8) {
        run(false, 0, 0, n0 % G == 0);
        if ((n0 + 8) % G == 0)
          epilogue2(*reinterpret_cast<const float4*>(
                        slots + kk * kSlotBytes + cw * 4),
                    false);
      } else {
        const int end = min(n0 + 8, r_hi);
#pragma unroll 1
        for (int lo = n0; lo < end;) {
          const int hi = min((lo / G + 1) * G, end);
          run(true, lo, hi, false);
          if (hi % G == 0) {
            const int col = ct * kCols + cw;
            epilogue2(col < d ? __ldg(reinterpret_cast<const float4*>(
                                    wds + row_of(lo) / qg * d + col))
                              : make_float4(0.f, 0.f, 0.f, 0.f),
                      true);
          }
          lo = hi;
        }
      }
    }
  };
  // C: (m-tile m, M gid / gid + 8, N 2 tig + e) -> column 4 gid + 2 m (+1)
  // of the warp's 32, token 2 tig + e: one 16-byte store a token
  auto store2q = [&](const Cursor& q) {
    const int sl = q.item / n_ct, ct = q.item - sl * n_ct;
    const int col = ct * kCols + warp * 32 + 4 * gid;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = q.tt * TN + t * 8 + 2 * tig + e;
        if (s < S && col < d)
          __stcg(reinterpret_cast<float4*>(part + ((size_t)sl * S + s) * d +
                                           col),
                 make_float4(acc[0][t][e], acc[0][t][2 + e], acc[1][t][e],
                             acc[1][t][2 + e]));
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
    }
  };
  {
    Cursor qp, qc;
    start2(qp, blockIdx.x);
    start2(qc, blockIdx.x);
#pragma unroll 1
    for (int i = 0; i < kNS2 - 1; ++i) {
      if (qp.item < items2) {
        if constexpr (kQ) load2q(qp); else load2(qp);
        next2(qp);
      }
      cp_commit();
    }
#pragma unroll 1
    while (qc.item < items2) {
      if constexpr (!kQ) wait_stage();
      cp_wait<kNS2 - 2>();
      __syncthreads();
      if (qp.item < items2) {
        if constexpr (kQ) load2q(qp); else load2(qp);
        next2(qp);
      }
      cp_commit();
      if constexpr (kQ) compute2q(consumed % kNS2, qc);
      else compute2(consumed % kStages);
      ++consumed;
      if (qc.c + 1 == qc.c1) {
        if constexpr (kQ) store2q(qc); else store2(qc);
      }
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

template <typename WT, typename XT, int NT>
cudaError_t occupancy(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel<WT, XT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chunk_kernel<WT, XT, NT>, kThreads, smem);
}

template <typename WT, typename XT, int NT>
cudaError_t launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel<WT, XT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  Args args = a;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)chunk_kernel<WT, XT, NT>,
                                  dim3(grid), dim3(kThreads), argv,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// dispatch on the x dtype (0 float32, 1 bfloat16) and NT (1, 2, 4, 8), for
// weights WT (float or int8_t)
template <typename WT, template <typename, typename, int> class F,
          typename... Ts>
cudaError_t dispatch(int x_dtype, int nt, Ts... ts) {
#define MLP_TC_CASE(XT, N) \
  if (nt == N) return F<WT, XT, N>::run(ts...);
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

template <typename WT, typename XT, int NT>
struct Occupancy {
  static cudaError_t run(int smem, int* blocks) {
    return occupancy<WT, XT, NT>(smem, blocks);
  }
};
template <typename WT, typename XT, int NT>
struct Launch {
  static cudaError_t run(const Args* a, int grid, int smem, cudaStream_t s) {
    return launch<WT, XT, NT>(*a, grid, smem, s);
  }
};

}  // namespace tc
}  // namespace mlp
