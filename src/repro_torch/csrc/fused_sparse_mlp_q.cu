// Fused sparse gated MLP for one decode step (a batch of at most 16
// tokens), int8 weights with float32 scales, redesigned for Hopper's
// memory system.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_q (the
// Pallas TPU kernel built by _make_kernel_q).  For the first `count` of the
// C selected row groups sel[0..C) it computes what the reference does:
//   x taken as float32;
//   gate and up through _qdot: per quant slab q of qg columns of d the dot
//     of x with the int8 row, times the row's scale w*_s[row, q], the
//     terms added in ascending q;
//   h = act(g) * u (h = act(g) when ungated), NOT rounded;
//   y = the sum over the selected groups, in selection order, of
//       (h_g Wd_q[g rows]) * wd_s[sel // (qg / G), :];
// and, when tel is given, the per-token int32 counters (actual, false_neg,
// realized) = (rows with g > 0, of those the ones whose own group margin
// gm_tok[b, sel] said skip, G * groups the token itself kept).
//
// What bounds it on an H100.  Its floor is bytes: at B=4, C=288 groups of
// 8 rows, d=4096, qg=128 it reads 28.3 MB of int8 weights, 0.59 MB of
// gate/up scales, at most 1.4 MB of wd scale rows and ~0.1 MB of x and y,
// 30.4 MB or 0.0091 ms at 3.35 TB/s; its 6 B count*G d flops take 0.0034
// ms on the CUDA cores at B=4 (0.0135 ms at B=16, above the bytes).  The
// port's first kernel for it (one warp per selected row, 4-byte loads, a
// scale multiply on every weight) took 0.154 ms: 2304 rows over 2112 warps
// came in 1.09 waves of one row each, and a row-time was ~0.07 ms.  This one
// takes ~0.05 ms at B=4 (PERF.md): what bounds it now is the instruction
// stream of its CUDA-core FMAs (B per weight, x an operand of each) at 16
// warps a SM, with each phase's first stages waiting on a burst of loads
// from every block.
//
// What the design does about it (one cooperative launch of `grid`
// resident blocks of 256 threads, at most 2 a SM; fixed-order sums, no
// float atomics, two grid barriers):
//   1. gate/up.  The selected rows are cut into equal contiguous ranges,
//      one a block (2304 rows over 264 blocks: 8 or 9 each; a third of
//      them, 2 or 3), so no block waits on a second wave.  A block streams
//      its rows through a ring of 16-byte cp.asyncs in shared memory (6
//      stages of one row of Wg and of Wu, a round of up to 4096 columns,
//      with the round's scales: 5 rows in flight a block, 10 a SM).  Each
//      thread takes 16 columns of a round as one 16-byte word a matrix,
//      converts the int8 with a byte permute and a subtract (exact, no I2F)
//      and multiplies them with x, held as float32 in its registers for the
//      round (read once a pass and round, never restaged; a pass is 4
//      tokens, so B > 4 takes 2 to 4 passes over the block's rows).
//      Scales in the reference's order: the lanes of a quant slab (8 lanes
//      of 16 columns at qg=128) add their partials in a fixed pairwise
//      tree, each slab's partial (a zeroed sum over its qg columns) goes to
//      shared memory, and at the end of each round of a batch of rows one
//      thread per (row, token) takes fmaf(partial, s[row, q], acc) over
//      the round's slabs in ascending q, for gate and for up, carrying the
//      sums of a slab cut by the round's end into the next round; after
//      the last round act, h = g*u and the telemetry (shared-memory integer
//      counters, one global integer atomicAdd per token and counter a
//      block).  No scale is read per weight.  Quant widths that are not a
//      multiple of 16 take one column a thread (kSlab1).  A row's slab
//      partials are held for one round only, so every d fits.
//   2. down.  The work is (512-column tile, selected group) units, cut
//      into equal contiguous ranges a block (tile-major: 8 x 288 units over
//      264 blocks, 8 or 9 each).  A unit's G rows of Wd (512 bytes each),
//      its h rows and its scale-row piece come through the same ring (8
//      stages of down's size); each thread takes 2 columns: a zeroed
//      partial per token over the group's rows, times the group's scales,
//      added (fmaf) in selection order.  Each block's run in a tile goes to
//      its own slot of scratch.
//   3. y = the sum of a tile's runs in block (selection) order.
// Only count*G rows of each matrix are read: a short selection has fewer
// rows and units, cut the same way over the whole grid.  The layout (the
// gate/up mode and lanes, a round's items and scales, the stages' and a
// chain row's sizes) is chosen by kernels/sparse_mlp_fused.py:decode_q_plan;
// the C entry only checks that the buffers hold what the kernel writes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlpq {

constexpr int kThreads = 256;
constexpr int kPiece = 16;                      // columns a thread a round
constexpr int kRoundCols = kPiece * kThreads;   // columns of d a stage
constexpr int kNBp = 4;                         // tokens a gate/up pass
constexpr int kItem = 2 * kNBp;                 // floats of an item
constexpr int kState = 4 * kNBp;                // a chain row's carried sums
constexpr int kTile = 2 * kThreads;             // down: columns of a unit
constexpr int kRowsStep = 16;                   // down: rows of a stage
constexpr int kStages = 8;          // the most stages a ring has
constexpr int kMaxB = 16;
constexpr int kMaxBlocksPerSM = 2;
constexpr int kTracePoints = 8;
// how gate/up meets the quant slabs: 16-column pieces inside one slab (qg
// a multiple of 16), or one column a piece
enum { kSlab16 = 0, kSlab1 = 1 };

// ---- primitives -----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (0 .. kStages - 2) groups are pending
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    default: cp_wait<6>(); break;
  }
}
// n bytes global -> shared, the block's threads splitting them: 16-byte
// copies where rows are 16-byte aligned (wide), else 4-byte ones
__device__ __forceinline__ void copy_span(uint32_t dst, const int8_t* src,
                                          int n, bool wide) {
  if (wide) {   // n <= kRoundCols: at most one copy a thread
    const int i = threadIdx.x * 16;
    if (i < n) cp16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
      cp4(dst + i, src + i);
  }
}
// byte b of w (a signed int8) as a float32, exactly: 0x4B000000 | (byte ^
// 0x80) is 2^23 + byte + 128
__device__ __forceinline__ float i8_f(uint32_t w, int b) {
  const uint32_t f = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | b);
  return __uint_as_float(f) - 8388736.f;
}
// the same, for a word already xored with 0x80808080 (once a word); the
// byte selector an immediate, the constant in a register
template <int B>
__device__ __forceinline__ float i8x_f(uint32_t wx) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(f) : "r"(wx), "r"(0x4B000000u),
      "n"(0x7540 | B));
  return __uint_as_float(f) - 8388736.f;
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The sums over 8 lanes (lane & ~7 the same) of v = (g[0..3], u[0..3]),
// each the pairwise tree ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7))
// of an xor butterfly over offsets 1, 2, 4, scattered: each step keeps the
// half of the values its lane bit picks and adds the partner's sums of
// that half (addition commutes exactly), so lane l returns the sum of
// v[rev(l)], rev(l) = 4 (l & 1) + (l & 2) + (l & 4) / 4 (see rev8).
__device__ __forceinline__ float reduce_scatter8(const float (&g)[4],
                                                 const float (&u)[4],
                                                 int lane) {
  const bool h1 = lane & 1, h2 = lane & 2, h4 = lane & 4;
  float v4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = h1 ? u[i] : g[i], send = h1 ? g[i] : u[i];
    v4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
  float v2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = h2 ? v4[i + 2] : v4[i], send = h2 ? v4[i] : v4[i + 2];
    v2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float keep = h4 ? v2[1] : v2[0], send = h4 ? v2[0] : v2[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
}
__device__ __forceinline__ int rev8(int lane) {
  return (lane & 1) * 4 + (lane & 2) + ((lane & 4) >> 2);
}

__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = phase * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(bar) < target)
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

struct Args {
  const void* x;          // (B, d) float32 or bfloat16
  const int8_t* wg;       // (k, d) int8
  const int8_t* wu;       // null: ungated
  const int8_t* wd;
  const float* wg_s;      // (k, d/qg)
  const float* wu_s;
  const float* wd_s;      // (k/qg, d)
  const int32_t* sel;     // (C,) group ids
  const int32_t* count;   // ()
  const float* gm_tok;    // (B, k/G), null: no telemetry
  float* y;               // (B, d)
  int32_t* tel;           // (B, 3) zeroed, or null
  float* hbuf;            // (C*G, nb)
  float* part;            // (grid + n_tiles, nb, kTile): down's runs
  unsigned* bar;          // zeroed grid barrier
  unsigned long long* trace;  // null, or kTracePoints per block
  int B, d, k, C, G, qg, act_kind;
  float thr;
  int lr;                 // lanes whose partials one item sums (2^i <= 32)
  int ni;                 // items of a row in a round
  int nsc;                // kSlab16: gate (and up) scales a stage carries
  int rf;                 // floats of a chain row: kState, the round's
                          // items, then kSlab16's 2 nsc scales
  int s1, s2;             // bytes of a gate/up and of a down stage
  int cb;                 // rows a chain batch
  int stages;             // stages of the ring (2 .. kStages)
  int ring;               // bytes of the ring; the chain batch's rows follow
};

// The optional phase trace: per block, %globaltimer (ns) at the start,
// when the first gate/up stage has landed, gate/up's stream done (before
// the last chain), gate/up done, past barrier 1, down done, past barrier 2
// and the end.
__device__ __forceinline__ void mark(const Args& a, int point) {
  if (a.trace != nullptr && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.trace[blockIdx.x * kTracePoints + point] = ns;
  }
}

// Where a block is in its gate/up steps: token pass, chain batch, round of
// 4096 columns, row of the batch; the row (block-relative rows r0 + bi*cb
// + rr) as selection group gi and row go of the group, and the batch's
// first row as (bgi, bgo).  Advanced one step at a time: no division.
struct Cursor {
  int pass, bi, cr, rr, nbr, gi, go, bgi, bgo;
};

template <typename XT, int NB, int MODE>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
decode_q_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tel_s[kMaxB * 3];
  mark(a, 0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int d = a.d, G = a.G;
  const int count = min(max(*a.count, 0), a.C);
  const int nrows = count * G;
  const int nq = d / a.qg;
  const int n_groups = a.k / G;
  const bool gated = a.wu != nullptr;
  const bool stats = a.tel != nullptr;
  const bool wide = (d & 15) == 0;
  const XT* x = static_cast<const XT*>(a.x);
  unsigned char* ring = smem;
  float* rows_buf = reinterpret_cast<float*>(smem + a.ring);
  const int rf = a.rf;
  constexpr int kW = MODE == kSlab16 ? kPiece : 1;   // columns of a piece
  for (int i = t; i < kMaxB * 3; i += kThreads) tel_s[i] = 0;

  // ---- phase 1: gate/up over this block's rows [r0, r0 + nr) --------------
  {
    const int r0 = (int)((long long)nrows * blockIdx.x / gridDim.x);
    const int nr = (int)((long long)nrows * (blockIdx.x + 1) / gridDim.x) - r0;
    const int rounds = (d + kRoundCols - 1) / kRoundCols;
    const int passes = (a.B + kNBp - 1) / kNBp;
    const int steps = passes * rounds * nr;
    const int s1 = a.s1;
    const int ns = a.stages;
    const int wbytes = (min(d, kRoundCols) + 15) / 16 * 16;
    const int gi0 = r0 / G, go0 = r0 - gi0 * G;
    Cursor pc{0, 0, 0, 0, min(a.cb, nr), gi0, go0, gi0, go0};
    Cursor cc = pc;
    auto advance = [&](Cursor& c) {
      if (++c.rr < c.nbr) {
        if (++c.go == G) c.go = 0, ++c.gi;
        return;
      }
      c.rr = 0;
      if (++c.cr < rounds) {        // the batch's rows again, next round
        c.gi = c.bgi;
        c.go = c.bgo;
        return;
      }
      c.cr = 0;
      if (++c.go == G) c.go = 0, ++c.gi;   // the row after the batch
      if (++c.bi * a.cb >= nr) {    // the block's rows again, next pass
        c.bi = 0;
        ++c.pass;
        c.gi = gi0;
        c.go = go0;
      }
      c.nbr = min(a.cb, nr - c.bi * a.cb);
      c.bgi = c.gi;
      c.bgo = c.go;
    };
    // the round's slabs [q0, q0 + nqr): those its columns touch
    auto round_q = [&](int cr, int& q0, int& nqr) {
      const int c0 = cr * kRoundCols;
      q0 = c0 / a.qg;
      nqr = min(nq, (min(d, c0 + kRoundCols) + a.qg - 1) / a.qg) - q0;
    };
    int p_slot = 0, c_slot = 0;   // the ring stages of producer, consumer
    const uint32_t ring_s = smem_u32(ring);
    // kSlab16 with one round: the row's nq gate, then nq up scales, in
    // 16-byte copies by the first nq / 2 threads when nq % 4 == 0
    const bool sc16 = rounds == 1 && (nq & 3) == 0;
    auto issue = [&]() {
      const size_t wrow = (size_t)__ldg(a.sel + pc.gi) * G + pc.go;
      const int c0 = pc.cr * kRoundCols;
      const int len = min(kRoundCols, d - c0);
      const uint32_t dst = ring_s + p_slot * s1;
      p_slot = p_slot + 1 == ns ? 0 : p_slot + 1;
      copy_span(dst, a.wg + wrow * d + c0, len, wide);
      if (gated) copy_span(dst + wbytes, a.wu + wrow * d + c0, len, wide);
      if (MODE == kSlab16) {
        // the row's scales of the round's slabs, gate then up
        const uint32_t sd = dst + 2 * wbytes;
        const float* sg = a.wg_s + wrow * nq;
        const float* su = (gated ? a.wu_s : a.wg_s) + wrow * nq;
        if (sc16) {
          if (t < nq / 2)
            cp16(sd + t * 16, t < nq / 4 ? sg + 4 * t : su + 4 * t - nq);
        } else {
          int q0, nqr;
          round_q(pc.cr, q0, nqr);
          sg += q0;
          su += q0;
          for (int i = t; i < 2 * nqr; i += kThreads)
            cp4(sd + i * 4, i < nqr ? sg + i : su + (i - nqr));
        }
      }
      advance(pc);
    };
    // x of this thread's columns for the pass's tokens, as float32
    float xr[kPiece][kNBp];
    int x_pass = -1, x_round = -1;
    auto load_x = [&](int pass, int cr) {
#pragma unroll
      for (int c = 0; c < kPiece; ++c) {
        const int col = MODE == kSlab1 ? cr * kRoundCols + c * kThreads + t
                                       : (cr * kThreads + t) * kPiece + c;
#pragma unroll
        for (int b = 0; b < kNBp; ++b) {
          const int tok = pass * kNBp + b;
          xr[c][b] = col < d && tok < a.B ? to_f(x[(size_t)tok * d + col])
                                          : 0.f;
        }
      }
    };
    // The chain, at the end of a round of the batch: per (row, token) the
    // round's items added into their slab's partial, each slab's partial
    // times the row's scale (fmaf) in ascending q.  A chain row holds the
    // sums carried from round to round (gate acc, up acc, and the partials
    // of a slab the round's end cuts), then the round's items, then
    // (kSlab16) the round's scales.
    auto chain = [&](const Cursor& c) {
      const int m = a.qg / (kW * a.lr);          // items of a slab
      const int nir = min(kRoundCols, d - c.cr * kRoundCols) / (kW * a.lr);
      const int j0 = c.cr * a.ni;                // the round's first item
      const bool last = c.cr == rounds - 1;
      int q0, nqr;
      round_q(c.cr, q0, nqr);
      for (int i = t; i < c.nbr * kNBp; i += kThreads) {
        const int rr = i / kNBp, b = i - rr * kNBp;
        const int tok = c.pass * kNBp + b;
        if (tok >= a.B) continue;
        int gi = c.bgi, go = c.bgo + rr;   // the batch's row rr
        while (go >= G) go -= G, ++gi;
        const int gsel = __ldg(a.sel + gi);
        float* st = rows_buf + (size_t)rr * rf + b;
        const float* it = st + kState;
        float ag = 0.f, au = 0.f, pg = 0.f, pu = 0.f;
        if (c.cr > 0) {
          ag = st[0];
          au = st[kNBp];
          pg = st[2 * kNBp];
          pu = st[3 * kNBp];
        }
        const size_t wrow = (size_t)gsel * G + go;
        // slab q's scales: the round's copy (kSlab16) or global (kSlab1)
        const float* sg = MODE == kSlab16
                              ? rows_buf + (size_t)rr * rf + kState +
                                    a.ni * kItem
                              : a.wg_s + wrow * nq + q0;
        const float* su = MODE == kSlab16 ? sg + nqr
                          : gated         ? a.wu_s + wrow * nq + q0
                                          : sg;
        int q = j0 / m, e = j0 - q * m;
#pragma unroll 4
        for (int j = 0; j < nir; ++j) {
          const float vg = it[j * kItem], vu = it[j * kItem + kNBp];
          pg = e ? pg + vg : vg;
          pu = e ? pu + vu : vu;
          if (++e == m) {
            ag = fmaf(pg, MODE == kSlab16 ? sg[q - q0] : __ldg(sg + q - q0),
                      ag);
            au = fmaf(pu, MODE == kSlab16 ? su[q - q0] : __ldg(su + q - q0),
                      au);
            e = 0;
            ++q;
          }
        }
        if (!last) {
          st[0] = ag;
          st[kNBp] = au;
          st[2 * kNBp] = pg;
          st[3 * kNBp] = pu;
          continue;
        }
        const int row = gi * G + go;
        const float ga = a.act_kind == 0 ? fmaxf(ag, 0.f)
                                         : (ag > a.thr ? ag : 0.f);
        a.hbuf[(size_t)row * NB + tok] = gated ? ga * au : ga;
        if (stats) {
          const bool live = ga > 0.f;
          const bool keep =
              __ldg(a.gm_tok + (size_t)tok * n_groups + gsel) <= 0.f;
          if (live) atomicAdd(&tel_s[tok * 3 + 0], 1);
          if (live && !keep) atomicAdd(&tel_s[tok * 3 + 1], 1);
          if (keep) atomicAdd(&tel_s[tok * 3 + 2], 1);
        }
      }
    };

    for (int s = 0; s < ns - 1; ++s) {
      if (s < steps) issue();
      cp_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_wait_n(ns - 2);
      __syncthreads();
      if (s == 0) mark(a, 1);
      if (s + ns - 1 < steps) issue();
      cp_commit();
      if (cc.pass != x_pass || cc.cr != x_round) {
        load_x(cc.pass, cc.cr);
        x_pass = cc.pass;
        x_round = cc.cr;
      }
      const unsigned char* stg = ring + c_slot * s1;
      c_slot = c_slot + 1 == ns ? 0 : c_slot + 1;
      float* it = rows_buf + (size_t)cc.rr * rf + kState;
      if (MODE == kSlab16) {
        const bool valid = (cc.cr * kThreads + t) * kPiece < d;
        float pg[kNBp], pu[kNBp];
#pragma unroll
        for (int b = 0; b < kNBp; ++b) pg[b] = pu[b] = 0.f;
        {
          // the round's scales into the row's place in the batch buffer
          const float* ss = reinterpret_cast<const float*>(stg + 2 * wbytes);
          float* sr = it + a.ni * kItem;
          int q0, nqr;
          round_q(cc.cr, q0, nqr);
          for (int i = t; i < 2 * nqr; i += kThreads) sr[i] = ss[i];
        }
        if (valid) {
          // a piece of one slab: 16 columns, 4 a word
          const uint4 w4 = *reinterpret_cast<const uint4*>(stg + t * 16);
          const uint4 u4 =
              gated ? *reinterpret_cast<const uint4*>(stg + wbytes + t * 16)
                    : make_uint4(0, 0, 0, 0);
          const uint32_t ww[4] = {w4.x ^ 0x80808080u, w4.y ^ 0x80808080u,
                                  w4.z ^ 0x80808080u, w4.w ^ 0x80808080u};
          const uint32_t uw[4] = {u4.x ^ 0x80808080u, u4.y ^ 0x80808080u,
                                  u4.z ^ 0x80808080u, u4.w ^ 0x80808080u};
          if (gated) {   // gate's and up's FMAs side by side: one x read
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float f[4] = {i8x_f<0>(ww[q]), i8x_f<1>(ww[q]),
                                  i8x_f<2>(ww[q]), i8x_f<3>(ww[q])};
              const float g[4] = {i8x_f<0>(uw[q]), i8x_f<1>(uw[q]),
                                  i8x_f<2>(uw[q]), i8x_f<3>(uw[q])};
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int b = 0; b < kNBp; ++b) {
                  pg[b] = fmaf(f[e], xr[4 * q + e][b], pg[b]);
                  pu[b] = fmaf(g[e], xr[4 * q + e][b], pu[b]);
                }
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float f[4] = {i8x_f<0>(ww[q]), i8x_f<1>(ww[q]),
                                  i8x_f<2>(ww[q]), i8x_f<3>(ww[q])};
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int b = 0; b < kNBp; ++b)
                  pg[b] = fmaf(f[e], xr[4 * q + e][b], pg[b]);
            }
          }
        }
        // the slab's lanes, in a fixed pairwise tree: at 8 lanes (qg=128)
        // as a reduce-scatter, each lane left with one of the item's 8
        // sums; else a butterfly
        if (a.lr == kItem) {
          const float v = reduce_scatter8(pg, pu, lane);
          if (valid) it[(t / kItem) * kItem + rev8(lane)] = v;
        } else {
          for (int o = 1; o < a.lr; o <<= 1) {
#pragma unroll
            for (int b = 0; b < kNBp; ++b) {
              pg[b] += __shfl_xor_sync(0xffffffffu, pg[b], o);
              pu[b] += __shfl_xor_sync(0xffffffffu, pu[b], o);
            }
          }
          if (valid && (lane & (a.lr - 1)) == 0) {
            float4* dst = reinterpret_cast<float4*>(it + (t / a.lr) * kItem);
            dst[0] = make_float4(pg[0], pg[1], pg[2], pg[3]);
            dst[1] = make_float4(pu[0], pu[1], pu[2], pu[3]);
          }
        }
      } else {
        // kSlab1: column cr*4096 + c*256 + t; a slab is qg consecutive
        // columns, so consecutive lanes
#pragma unroll
        for (int c = 0; c < kPiece; ++c) {
          const int cl = c * kThreads + t;     // the column in the round
          const bool valid = cc.cr * kRoundCols + cl < d;
          float pg[kNBp], pu[kNBp];
          const float fg = valid ? i8_f(stg[cl], 0) : 0.f;
          const float fu = valid && gated ? i8_f(stg[wbytes + cl], 0) : 0.f;
#pragma unroll
          for (int b = 0; b < kNBp; ++b) {
            pg[b] = fg * xr[c][b];
            pu[b] = fu * xr[c][b];
          }
          for (int o = 1; o < a.lr; o <<= 1) {
#pragma unroll
            for (int b = 0; b < kNBp; ++b) {
              pg[b] += __shfl_xor_sync(0xffffffffu, pg[b], o);
              pu[b] += __shfl_xor_sync(0xffffffffu, pu[b], o);
            }
          }
          if (valid && (lane & (a.lr - 1)) == 0) {
            float4* dst = reinterpret_cast<float4*>(it + (cl / a.lr) * kItem);
            dst[0] = make_float4(pg[0], pg[1], pg[2], pg[3]);
            dst[1] = make_float4(pu[0], pu[1], pu[2], pu[3]);
          }
        }
      }
      if (cc.rr == cc.nbr - 1) {   // the batch's round is in: its chain
        if (s == steps - 1) mark(a, 2);
        __syncthreads();
        chain(cc);
      }
      advance(cc);
    }
    cp_wait<0>();
    if (steps == 0) {
      mark(a, 1);
      mark(a, 2);
    }
  }
  __syncthreads();
  if (stats && t < a.B * 3 && tel_s[t]) atomicAdd(a.tel + t, tel_s[t]);
  mark(a, 3);
  grid_barrier(a.bar, 1);
  mark(a, 4);

  // ---- phase 2: down over this block's (tile, group) units -----------------
  const int ng = count;
  const int n_ct = (d + kTile - 1) / kTile;
  const int U = n_ct * ng;
  {
    const int u0 = (int)((long long)U * blockIdx.x / gridDim.x);
    const int u1 = (int)((long long)U * (blockIdx.x + 1) / gridDim.x);
    const int rchunks = (G + kRowsStep - 1) / kRowsStep;
    const int steps = (u1 - u0) * rchunks;
    const int rs = min(G, kRowsStep);
    const int s2 = a.s2;
    // down's stages are smaller: as many as the ring holds, at most kStages
    const int ns = min(kStages, a.ring / s2);
    const int c = 2 * t;      // this thread's two columns of the tile
    // cursors (tile, group, row chunk) of the producer and the consumer
    const int ct0 = ng > 0 ? u0 / ng : 0;
    int p_ct = ct0, p_j = u0 - ct0 * ng, p_rc = 0;
    int c_ct = p_ct, c_j = p_j, c_rc = 0;
    int p_slot = 0, c_slot = 0;
    const uint32_t ring_s = smem_u32(ring);
    auto issue = [&]() {
      const int gsel = __ldg(a.sel + p_j);
      const int c0 = p_ct * kTile, len = min(kTile, d - c0);
      const int r_lo = p_rc * kRowsStep, nrr = min(kRowsStep, G - r_lo);
      const uint32_t dst = ring_s + p_slot * s2;
      p_slot = p_slot + 1 == ns ? 0 : p_slot + 1;
      const int8_t* src = a.wd + ((size_t)gsel * G + r_lo) * d + c0;
      if (wide && len == kTile) {    // 32 16-byte pieces a row
#pragma unroll 2
        for (int i = t; i < nrr * (kTile / 16); i += kThreads)
          cp16(dst + (i >> 5) * kTile + (i & 31) * 16,
               src + (size_t)(i >> 5) * d + (i & 31) * 16);
      } else {
        const int piece = wide ? 16 : 4, spr = len / piece;
        for (int i = t; i < nrr * spr; i += kThreads) {
          const int r = i / spr, sg = i - r * spr;
          if (wide)
            cp16(dst + r * kTile + sg * 16, src + (size_t)r * d + sg * 16);
          else
            cp4(dst + r * kTile + sg * 4, src + (size_t)r * d + sg * 4);
        }
      }
      const float* hs = a.hbuf + ((size_t)p_j * G + r_lo) * NB;
      const uint32_t hdst = dst + rs * kTile;
      for (int i = t; i < nrr * NB / 4; i += kThreads)
        cp16(hdst + i * 16, hs + i * 4);
      if (p_rc == rchunks - 1) {   // the group's scale row piece
        const float* ss = a.wd_s + (size_t)(gsel * G / a.qg) * d + c0;
        const uint32_t sdst = hdst + rs * NB * 4;
        for (int i = t; i < len / 4; i += kThreads)
          cp16(sdst + i * 16, ss + i * 4);
      }
      if (++p_rc == rchunks) {
        p_rc = 0;
        if (++p_j == ng) p_j = 0, ++p_ct;
      }
    };
    float acc[2][NB], prt[2][NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[0][b] = acc[1][b] = 0.f;
    for (int s = 0; s < ns - 1; ++s) {
      if (s < steps) issue();
      cp_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_wait_n(ns - 2);
      __syncthreads();
      if (s + ns - 1 < steps) issue();
      cp_commit();
      const int len = min(kTile, d - c_ct * kTile);
      const int nrr = min(kRowsStep, G - c_rc * kRowsStep);
      const unsigned char* stg = ring + c_slot * s2;
      c_slot = c_slot + 1 == ns ? 0 : c_slot + 1;
      const float* hst = reinterpret_cast<const float*>(stg + rs * kTile);
      if (c_rc == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) prt[0][b] = prt[1][b] = 0.f;
      }
      if (c < len) {
#pragma unroll 4
        for (int r = 0; r < nrr; ++r) {
          const uint32_t w2 =
              *reinterpret_cast<const uint16_t*>(stg + r * kTile + c) ^
              0x8080u;
          const float f0 = i8x_f<0>(w2), f1 = i8x_f<1>(w2);
          const float4* hv = reinterpret_cast<const float4*>(hst + r * NB);
#pragma unroll
          for (int b4 = 0; b4 < NB / 4; ++b4) {
            const float4 h4 = hv[b4];
            const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // each h read once, both columns
              prt[0][4 * b4 + i] = fmaf(h[i], f0, prt[0][4 * b4 + i]);
              prt[1][4 * b4 + i] = fmaf(h[i], f1, prt[1][4 * b4 + i]);
            }
          }
        }
      }
      if (c_rc == rchunks - 1) {
        // the group's products times its scales, added in selection order
        if (c < len) {
          const float2 sc = *reinterpret_cast<const float2*>(
              hst + rs * NB + c);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[0][b] = fmaf(prt[0][b], sc.x, acc[0][b]);
            acc[1][b] = fmaf(prt[1][b], sc.y, acc[1][b]);
          }
        }
        if (s == steps - 1 || c_j == ng - 1) {   // the run's end
          if (c < len) {
            float* dst = a.part +
                         (size_t)(blockIdx.x + c_ct) * NB * kTile + c;
#pragma unroll
            for (int b = 0; b < NB; ++b)
              *reinterpret_cast<float2*>(dst + b * kTile) =
                  make_float2(acc[0][b], acc[1][b]);
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[0][b] = acc[1][b] = 0.f;
        }
      }
      if (++c_rc == rchunks) {
        c_rc = 0;
        if (++c_j == ng) c_j = 0, ++c_ct;
      }
    }
    cp_wait<0>();
  }
  mark(a, 5);
  grid_barrier(a.bar, 2);
  mark(a, 6);

  // ---- phase 3: y = a tile's runs in block order ---------------------------
  // block i holds units [U i / grid, U (i+1) / grid); its run in tile ct is
  // in slot i + ct.  With U >= grid every block holds a unit and the tile's
  // runs are those of blocks owner(first unit) .. owner(last unit); with
  // U < grid a block holds at most one, so each of the tile's units is a
  // run of its own, in unit order.
  const long long grid = gridDim.x;
  const int total = a.B * d;
  for (int e = blockIdx.x * kThreads + t; e < total;
       e += gridDim.x * kThreads) {
    const int tok = e / d, col = e - tok * d;
    const int ct = col / kTile, cc = col - ct * kTile;
    const float* pp = a.part + ((size_t)ct * NB + tok) * kTile + cc;
    const size_t slot = (size_t)NB * kTile;
    float v = 0.f;
    if (U >= grid) {
      const long long lo = (long long)ct * ng;
      const int bf = (int)(((lo + 1) * grid - 1) / U);
      const int bl = (int)(((lo + ng) * grid - 1) / U);
#pragma unroll 16
      for (int i = bf; i <= bl; ++i) v += __ldcg(pp + i * slot);
    } else {
      for (int j = 0; j < ng; ++j) {
        const long long u = (long long)ct * ng + j;
        v += __ldcg(pp + ((u + 1) * grid - 1) / U * slot);
      }
    }
    a.y[e] = v;
  }
  mark(a, 7);
}

typedef void (*KernelFn)(const Args);

template <typename XT, int NB>
KernelFn pick_mode(int mode) {
  switch (mode) {
    case kSlab16: return decode_q_kernel<XT, NB, kSlab16>;
    case kSlab1: return decode_q_kernel<XT, NB, kSlab1>;
  }
  return nullptr;
}
template <typename XT>
KernelFn pick_nb(int nb, int mode) {
  switch (nb) {
    case 4: return pick_mode<XT, 4>(mode);
    case 8: return pick_mode<XT, 8>(mode);
    case 16: return pick_mode<XT, 16>(mode);
  }
  return nullptr;
}
inline KernelFn pick(int x_dtype, int nb, int mode) {
  return x_dtype == 0   ? pick_nb<float>(nb, mode)
         : x_dtype == 1 ? pick_nb<__nv_bfloat16>(nb, mode)
                        : nullptr;
}

// opt fn in to smem bytes of dynamic shared memory (above 48 KB a kernel
// must ask); each kernel asks again only for more than it has
constexpr int kKernels = 2 * 3 * 2;   // x dtypes x nb x modes
inline cudaError_t opt_in(KernelFn fn, int smem) {
  static KernelFn fns[kKernels] = {};
  static int granted[kKernels] = {};
  int i = 0;
  while (i < kKernels && fns[i] != nullptr && fns[i] != fn) ++i;
  if (i < kKernels && fns[i] == fn && granted[i] >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && i < kKernels) {
    fns[i] = fn;
    granted[i] = smem;
  }
  return e;
}

// Whether the plan's sizes hold what the kernel writes and reads: each
// item inside one quant slab, a round's items and scales inside a chain
// row, the stages' contents inside a stage, the ring and the chain batch
// inside the shared memory.
inline bool layout_fits(int d, int G, int qg, int nb, int mode, int lr,
                        int ni, int nsc, int rf, int s1, int s2, int cb,
                        int stages, int ring, int smem) {
  const int w = mode == kSlab16 ? kPiece : 1;
  const int cols = d < kRoundCols ? d : kRoundCols;
  const int rounds = (d + kRoundCols - 1) / kRoundCols;
  const int scales = mode != kSlab16 ? 0
                     : rounds == 1   ? d / qg
                                     : (kRoundCols + qg - 1) / qg + 1;
  const int rs = G < kRowsStep ? G : kRowsStep;
  return lr >= 1 && lr <= 32 && (lr & (lr - 1)) == 0 && qg % (w * lr) == 0 &&
         (rounds == 1 ? ni * w * lr >= cols : ni * w * lr == kRoundCols) &&
         nsc >= scales && rf % 4 == 0 &&
         rf >= kState + ni * kItem + 2 * nsc &&
         s1 % 16 == 0 && s1 >= 2 * ((cols + 15) / 16 * 16) + 8 * nsc &&
         s2 % 16 == 0 && s2 >= rs * (kTile + nb * 4) + kTile * 4 &&
         stages >= 2 && stages <= kStages && ring >= stages * s1 &&
         ring >= 2 * s2 && cb >= 1 && smem >= ring + cb * rf * 4;
}

}  // namespace mlpq

extern "C" {

// Blocks of the kernel for (x_dtype, nb, mode) with smem bytes of dynamic
// shared memory that one SM holds at once (the occupancy calculator).
int fused_sparse_mlp_q_occupancy(int x_dtype, int nb, int mode, int smem,
                                 int* blocks) {
  const mlpq::KernelFn fn = mlpq::pick(x_dtype, nb, mode);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = mlpq::opt_in(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, mlpq::kThreads, (size_t)smem);
}

// One cooperative launch.  x (B, d) float32 (x_dtype 0) or bfloat16 (1),
// 1 <= B <= nb; wg/wu/wd (k, d) int8 (wu null: ungated; 16-byte aligned),
// wg_s/wu_s (k, d/qg) and wd_s (k/qg, d) float32 (16-byte aligned); sel
// (C,) int32 group ids, count () int32; gm_tok (B, k/G) float32 and tel
// (B, 3) int32 zeroed, or both null; y (B, d) float32.  The layout and the
// scratch come from kernels/sparse_mlp_fused.py's decode_q_plan: nb in {4,
// 8, 16}; mode kSlab16 or kSlab1, lr, ni, nsc, rf (a chain row's floats),
// s1 and s2 (the stages' bytes), cb (rows a chain batch), stages (2 .. 8),
// ring (its bytes), grid, smem (ring + cb rows of rf floats); hbuf (C*G x
// nb floats), part ((grid + ceil(d/512)) x nb x 512 floats), bar (one
// zeroed uint32); trace: null, or grid x kTracePoints uint64.  act_kind 0 =
// relu, 1 = fatrelu(thr).  Returns cudaGetLastError() after the launch.
int fused_sparse_mlp_q(const void* x, int x_dtype, const void* wg,
                       const void* wg_s, const void* wu, const void* wu_s,
                       const void* wd, const void* wd_s, const void* sel,
                       const void* count, const void* gm_tok, void* y,
                       void* tel, void* hbuf, void* part, void* bar,
                       void* trace, int B,
                       int d, int k, int C, int G, int qg, int act_kind,
                       float thr, int nb, int mode, int lr, int ni, int nsc,
                       int rf, int s1, int s2, int cb, int stages, int ring,
                       int grid, int smem, void* stream) {
  using namespace mlpq;
  const KernelFn fn = pick(x_dtype, nb, mode);
  if (fn == nullptr || B < 1 || B > nb || d < 4 || d % 4 || G < 1 ||
      k % G || C < 1 || qg < 1 || d % qg || k % qg || qg % G ||
      (mode == kSlab16 && qg % kPiece) ||
      !layout_fits(d, G, qg, nb, mode, lr, ni, nsc, rf, s1, s2, cb, stages,
                   ring, smem) ||
      grid < 1 || (gm_tok == nullptr) != (tel == nullptr) ||
      wg_s == nullptr || wd_s == nullptr ||
      (wu == nullptr) != (wu_s == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.wg = static_cast<const int8_t*>(wg);
  a.wu = static_cast<const int8_t*>(wu);
  a.wd = static_cast<const int8_t*>(wd);
  a.wg_s = static_cast<const float*>(wg_s);
  a.wu_s = static_cast<const float*>(wu_s);
  a.wd_s = static_cast<const float*>(wd_s);
  a.sel = static_cast<const int32_t*>(sel);
  a.count = static_cast<const int32_t*>(count);
  a.gm_tok = static_cast<const float*>(gm_tok);
  a.y = static_cast<float*>(y);
  a.tel = static_cast<int32_t*>(tel);
  a.hbuf = static_cast<float*>(hbuf);
  a.part = static_cast<float*>(part);
  a.bar = static_cast<unsigned*>(bar);
  a.trace = static_cast<unsigned long long*>(trace);
  a.B = B;
  a.d = d;
  a.k = k;
  a.C = C;
  a.G = G;
  a.qg = qg;
  a.act_kind = act_kind;
  a.thr = thr;
  a.lr = lr;
  a.ni = ni;
  a.nsc = nsc;
  a.rf = rf;
  a.s1 = s1;
  a.s2 = s2;
  a.cb = cb;
  a.stages = stages;
  a.ring = ring;
  cudaError_t e = opt_in(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fn, dim3(grid),
                                  dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* fused_sparse_mlp_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
