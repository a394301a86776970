// Fused sparse gated MLP for one decode step (a batch of at most 16
// tokens), float32 weights, designed for Hopper's memory system.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp (the Pallas
// TPU kernel built by _make_kernel, telemetry by _telemetry_delta).  For
// the first `count` of the C selected row groups sel[0..C) it computes
//     g = act(x Wg[rows]^T),  h = g * (x Wu[rows]^T)   (h = g: ungated)
//     y = sum over the selected rows of h[:, row] * Wd[row, :]   (float32)
// with h rounded to x's dtype before the down projection, as the reference
// kernel does (a no-op for float32 x), and, when tel is given, the
// per-token int32 counters (actual, false_neg, realized) = (rows with g >
// 0, of those the ones whose own group margin gm_tok[b, sel] said skip, G
// * groups the token itself kept).
//
// What bounds it on an H100.  The weight bytes: 3 count*G rows of d
// floats, 113 MB a layer at C=288 groups of 8 rows and d=4096, 0.0338 ms at
// 3.35 TB/s.  Its 6 B count*G d flops take 0.0034 ms on the CUDA cores at
// B=4 and 0.0135 ms at B=16, so a decode batch is bound by bytes.  The
// port's first kernel for it (one warp per selected row, x restaged in
// shared memory) took 0.140 ms at B=4: 2304 rows over 2112 warps came in
// 1.09 waves, a third of its time, and down's 288 (slice, tile) items over
// 264 blocks had the same tail.  Reading the same bytes alone, with the L2
// flushed before, takes ~0.052 ms on the card (PERF.md); this kernel takes
// ~0.064 ms at B=4 and B=1 (the barriers, the launch and the runs' sum are
// most of the difference) and ~0.092 ms at B=16, where its instruction
// stream (FMAs and the reduce-scatter, every 8 KB stage) bounds gate/up.
//
// What the design does about it (one cooperative launch of `grid` resident
// blocks of 256 threads, at most 2 a SM; fixed-order sums, no float
// atomics, two grid barriers):
//   1. gate/up.  The selected rows are cut into equal contiguous ranges,
//      one a block (2304 rows over 264 blocks: 8 or 9 each, a third of
//      them 2 or 3), so no block waits on a second wave.  A block streams
//      its rows through a ring of 16-byte cp.asyncs in shared memory, each
//      stage one row's piece of Wg and of Wu, a round of 4096, 2048 or
//      1024 columns for batches of up to 4, 8 or 16 tokens (32, 16 or 8
//      KB; 3, 5 or 8 stages: 100-130 KB in flight a SM).  Each thread takes
//      16, 8 or 4 columns of a round as 16-byte pieces and holds x for
//      them as float32 in registers (64 values), read once a round and
//      never restaged, so every token of the batch is served by one pass
//      over the weights.  A thread's sums (gate and up per token) go
//      through a reduce-scatter over the warp's lanes (a fixed pairwise
//      tree); the 8 warps' sums of a row go to shared memory, and at the
//      end of each round of a batch of rows one thread per (row, token)
//      adds them in warp order and carries the sum to the next round.
//      After the last round: act, h = g*u rounded to x's dtype, and the
//      telemetry (shared-memory integer counters, a block's counters to
//      its own slot of scratch, summed by one block in phase 3).
//   2. down.  The work is (512-column tile, selected group) units, cut
//      into equal contiguous ranges a block (tile-major: 8 x 288 units over
//      264 blocks, 8 or 9 each).  A unit's G rows of Wd (2 KB each) and
//      their h rows come through the same ring, the first stages' Wd
//      fetched before barrier 1 (it does not depend on h); each thread takes 2
//      columns: a zeroed partial per token over the group's rows, added in
//      selection order into the block's run.  Each block's run in a tile
//      goes to its own slot of scratch.
//   3. y = the sum of a tile's runs in block (selection) order.
// Only count*G rows of each matrix are read: a short selection has fewer
// rows and units, cut the same way over the whole grid.  The barriers'
// counter is left at zero by each launch and the telemetry is written, not
// added, so the caller zeroes nothing before a launch.  The layout (the
// batch width nb, a chain row's and the stages' sizes, the chain batch,
// the ring, the grid) is chosen by kernels/sparse_mlp_fused.py:decode_plan;
// the C entry only checks that the buffers hold what the kernel writes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXRegs = 64;             // x values a thread holds for a round
constexpr int kTile = 2 * kThreads;    // down: columns of a unit
constexpr int kRowsStep = 16;          // down: rows of a stage
constexpr int kStages = 8;             // the most stages a ring has
constexpr int kMaxB = 16;
constexpr int kMaxBlocksPerSM = 2;
constexpr int kTracePoints = 8;

// ---- primitives -----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1, with a 256-byte L2 prefetch
// (the rows are streamed in long runs)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
                   dst),
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
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// four consecutive values of x as float32 (16-byte or 8-byte aligned)
__device__ __forceinline__ float4 x4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 x4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// One reduce-scatter step over the first N of v[0..V): lanes o = V/N apart
// swap halves; each keeps the half its lane bit picks, adds the partner's
// sums of that half, and goes on with N/2 values.
template <int N, int V>
struct Scatter {
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    constexpr int h = N / 2, o = V / N;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? v[i + h] : v[i];
      const float send = up ? v[i] : v[i + h];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    Scatter<h, V>::run(v, lane);
  }
};
template <int V>
struct Scatter<1, V> {
  static __device__ __forceinline__ void run(float (&)[V], int) {}
};

// The sums over the warp's 32 lanes of each of v[0..V): a reduce-scatter
// over the offsets 1, 2, ..., V/2, then a butterfly over the offsets V ..
// 16.  Every value is the pairwise tree ((l0 + l1) + (l2 + l3)) + ... over
// the lanes in order (addition commutes exactly); lane l returns the sum
// of v[scatter_index<V>(l)].
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  Scatter<V, V>::run(v, lane);
  float r = v[0];
#pragma unroll
  for (int o = V; o < 32; o <<= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}
template <int V>
__device__ __forceinline__ int scatter_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int n = V, o = 1; n > 1; n >>= 1, o <<= 1)
    if (lane & o) idx += n / 2;
  return idx;
}

// The grid barriers of a cooperative launch on a counter that every launch
// leaves at zero, so the caller zeroes it once: each block adds one at each
// of the two barriers and one more once past the second; the block whose
// last add completes the count has seen every block past the second
// barrier, so no block reads the counter again, and it resets it.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = phase * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(bar) < target)
      __nanosleep(32);
    __threadfence();
    if (phase == 2 && atomicAdd(bar, 1u) == 3 * gridDim.x - 1)
      atomicExch(bar, 0u);
  }
  __syncthreads();
}

struct Args {
  const void* x;          // (B, d) float32 or bfloat16
  const float* wg;        // (k, d)
  const float* wu;        // null: ungated
  const float* wd;
  const int32_t* sel;     // (C,) group ids
  const int32_t* count;   // ()
  const float* gm_tok;    // (B, k/G), null: no telemetry
  float* y;               // (B, d)
  int32_t* tel;           // (B, 3), or null
  int32_t* tel_part;      // (grid, kMaxB * 3): each block's counters
  float* hbuf;            // (C*G, nb)
  float* part;            // (grid + n_tiles, nb, kTile): down's runs
  unsigned* bar;          // grid barrier counter, zero at the launch
  unsigned long long* trace;  // null, or kTracePoints per block
  int B, d, k, C, G, act_kind;
  float thr;
  int rf;                 // floats of a chain row: 2 nb carried sums, then
                          // kWarps x 2 nb warp sums
  int s1, s2;             // bytes of a gate/up and of a down stage
  int cb;                 // rows a chain batch
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

// Where a block is in its gate/up steps: chain batch, round, row of the
// batch, rows in the batch.  Advanced one step at a time.
struct Cursor {
  int bi, cr, rr, nbr;
};

template <typename XT, int NB>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
decode_kernel(const Args a) {
  constexpr int P = kXRegs / (4 * NB);      // 16-byte pieces a thread
  constexpr int kRound = kThreads * 4 * P;  // columns of a round
  constexpr int V = 2 * NB;                 // a row's sums: gate, then up
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tel_s[kMaxB * 3];
  mark(a, 0);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int d = a.d, G = a.G;
  const int count = min(max(*a.count, 0), a.C);
  const int nrows = count * G;
  const int n_groups = a.k / G;
  const bool gated = a.wu != nullptr;
  const bool stats = a.tel != nullptr;
  const XT* x = static_cast<const XT*>(a.x);
  unsigned char* ring = smem;
  const uint32_t ring_s = smem_u32(ring);
  float* rows_buf = reinterpret_cast<float*>(smem + a.ring);
  for (int i = t; i < kMaxB * 3; i += kThreads) tel_s[i] = 0;

  // ---- phase 1: gate/up over this block's rows [r0, r0 + nr) --------------
  {
    const int r0 = (int)((long long)nrows * blockIdx.x / gridDim.x);
    const int nr = (int)((long long)nrows * (blockIdx.x + 1) / gridDim.x) - r0;
    const int rounds = (d + kRound - 1) / kRound;
    const int steps = rounds * nr;
    const int s1 = a.s1;
    const int ns = min(kStages, a.ring / s1);
    const int wcols = min(d, kRound);   // Wu's piece follows Wg's in a stage
    Cursor pc{0, 0, 0, min(a.cb, nr)};
    Cursor cc = pc;
    auto advance = [&](Cursor& c) {
      if (++c.rr < c.nbr) return;
      c.rr = 0;
      if (++c.cr < rounds) return;     // the batch's rows again, next round
      c.cr = 0;
      ++c.bi;
      c.nbr = min(a.cb, nr - c.bi * a.cb);
    };
    int p_slot = 0, c_slot = 0;   // the ring stages of producer, consumer
    auto issue = [&]() {
      const int n = r0 + pc.bi * a.cb + pc.rr;
      const size_t wrow = (size_t)__ldg(a.sel + n / G) * G + n % G;
      const int c0 = pc.cr * kRound;
      const int len4 = min(kRound, d - c0) / 4;
      const uint32_t dst = ring_s + p_slot * s1;
      p_slot = p_slot + 1 == ns ? 0 : p_slot + 1;
      const float* g = a.wg + wrow * d + c0;
      const float* u = gated ? a.wu + wrow * d + c0 : nullptr;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = j * kThreads + t;
        if (i < len4) {
          cp16(dst + i * 16, g + i * 4);
          if (gated) cp16(dst + wcols * 4 + i * 16, u + i * 4);
        }
      }
      advance(pc);
    };
    // x of this thread's columns (j*256 + t)*4 + c of the round, all NB
    // tokens, as float32
    float xr[P][4][NB];
    int x_round = -1;
    auto load_x = [&](int cr) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int col = cr * kRound + (j * kThreads + t) * 4;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 v = col < d && b < a.B ? x4(x + (size_t)b * d + col)
                                              : make_float4(0, 0, 0, 0);
          xr[j][0][b] = v.x;
          xr[j][1][b] = v.y;
          xr[j][2][b] = v.z;
          xr[j][3][b] = v.w;
        }
      }
    };
    // The chain, at the end of a round of the batch: per (row, token) the
    // 8 warps' sums added in warp order, then to the sums carried from
    // the earlier rounds; after the last round act, h and the telemetry.
    auto chain = [&](const Cursor& c) {
      const bool last = c.cr == rounds - 1;
      for (int i = t; i < c.nbr * NB; i += kThreads) {
        const int rr = i / NB, b = i - rr * NB;
        if (b >= a.B) continue;
        float* st = rows_buf + (size_t)rr * a.rf;
        const float* ws = st + V;
        float sg = ws[b], su = ws[NB + b];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sg += ws[w * V + b];
          su += ws[w * V + NB + b];
        }
        if (c.cr > 0) {
          sg = st[b] + sg;
          su = st[NB + b] + su;
        }
        if (!last) {
          st[b] = sg;
          st[NB + b] = su;
          continue;
        }
        const int n = r0 + c.bi * a.cb + rr;
        const int gsel = __ldg(a.sel + n / G);
        const float ga = a.act_kind == 0 ? fmaxf(sg, 0.f)
                                         : (sg > a.thr ? sg : 0.f);
        a.hbuf[(size_t)n * NB + b] =
            round_to(gated ? ga * su : ga, (const XT*)nullptr);
        if (stats) {
          const bool live = ga > 0.f;
          const bool keep =
              __ldg(a.gm_tok + (size_t)b * n_groups + gsel) <= 0.f;
          if (live) atomicAdd(&tel_s[b * 3 + 0], 1);
          if (live && !keep) atomicAdd(&tel_s[b * 3 + 1], 1);
          if (keep) atomicAdd(&tel_s[b * 3 + 2], 1);
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
      if (cc.cr != x_round) {
        load_x(cc.cr);
        x_round = cc.cr;
      }
      const float* stg = reinterpret_cast<const float*>(ring + c_slot * s1);
      c_slot = c_slot + 1 == ns ? 0 : c_slot + 1;
      const int len4 = min(kRound, d - cc.cr * kRound) / 4;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = j * kThreads + t;
        if (i < len4) {
          const float4 g4 = reinterpret_cast<const float4*>(stg)[i];
          const float gw[4] = {g4.x, g4.y, g4.z, g4.w};
          if (gated) {   // gate's and up's FMAs side by side: one x read
            const float4 u4 =
                reinterpret_cast<const float4*>(stg + wcols)[i];
            const float uw[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                v[b] = fmaf(gw[c], xr[j][c][b], v[b]);
                v[NB + b] = fmaf(uw[c], xr[j][c][b], v[NB + b]);
              }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int b = 0; b < NB; ++b)
                v[b] = fmaf(gw[c], xr[j][c][b], v[b]);
          }
        }
      }
      const float r = reduce_scatter<V>(v, lane);
      if (lane < V)
        rows_buf[(size_t)cc.rr * a.rf + V + warp * V +
                 scatter_index<V>(lane)] = r;
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
  if (stats && t < a.B * 3) a.tel_part[blockIdx.x * kMaxB * 3 + t] = tel_s[t];
  mark(a, 3);

  // ---- phase 2: down over this block's (tile, group) units -----------------
  // A stage holds a unit's rows of Wd, then their h rows.  Wd does not
  // depend on h: the first stages' rows are fetched before barrier 1, their
  // h rows after it.
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
    const int ns = min(kStages, a.ring / s2);
    const int c = 2 * t;      // this thread's two columns of the tile
    // where a stage is: tile, group, row chunk, ring slot; the producer's
    // cursors of Wd and of h (apart only before barrier 1) and the
    // consumer's
    struct Unit {
      int ct, j, rc, slot;
    };
    const int ct0 = ng > 0 ? u0 / ng : 0;
    Unit pw{ct0, u0 - ct0 * ng, 0, 0};
    Unit ph = pw, cu = pw;
    auto next = [&](Unit& u) {
      u.slot = u.slot + 1 == ns ? 0 : u.slot + 1;
      if (++u.rc == rchunks) {
        u.rc = 0;
        if (++u.j == ng) u.j = 0, ++u.ct;
      }
    };
    auto issue_w = [&]() {
      const int gsel = __ldg(a.sel + pw.j);
      const int c0 = pw.ct * kTile, len4 = min(kTile, d - c0) / 4;
      const int r_lo = pw.rc * kRowsStep, nrr = min(kRowsStep, G - r_lo);
      const uint32_t dst = ring_s + pw.slot * s2;
      const float* src = a.wd + ((size_t)gsel * G + r_lo) * d + c0;
      if (len4 == kTile / 4) {   // 128 16-byte pieces a row
#pragma unroll 4
        for (int i = t; i < nrr * (kTile / 4); i += kThreads)
          cp16(dst + (i >> 7) * (kTile * 4) + (i & 127) * 16,
               src + (size_t)(i >> 7) * d + (i & 127) * 4);
      } else {
        for (int i = t; i < nrr * len4; i += kThreads) {
          const int r = i / len4, sg = i - r * len4;
          cp16(dst + r * (kTile * 4) + sg * 16, src + (size_t)r * d + sg * 4);
        }
      }
      next(pw);
    };
    auto issue_h = [&]() {
      const int r_lo = ph.rc * kRowsStep, nrr = min(kRowsStep, G - r_lo);
      const float* hs = a.hbuf + ((size_t)ph.j * G + r_lo) * NB;
      const uint32_t hdst = ring_s + ph.slot * s2 + rs * kTile * 4;
      for (int i = t; i < nrr * NB / 4; i += kThreads)
        cp16(hdst + i * 16, hs + i * 4);
      next(ph);
    };
    // the prologue: Wd of the first ns - 1 stages in one group, then past
    // the barrier their h rows in a group each, so that step s waits for
    // its stage as the loop below expects (ns - 2 groups left pending)
    for (int s = 0; s < ns - 1 && s < steps; ++s) issue_w();
    cp_commit();
    grid_barrier(a.bar, 1);
    mark(a, 4);
    for (int s = 0; s < ns - 1; ++s) {
      if (s < steps) issue_h();
      cp_commit();
    }
    float acc[2][NB], prt[2][NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[0][b] = acc[1][b] = 0.f;
    for (int s = 0; s < steps; ++s) {
      cp_wait_n(ns - 2);
      __syncthreads();
      if (s + ns - 1 < steps) {
        issue_w();
        issue_h();
      }
      cp_commit();
      const int len = min(kTile, d - cu.ct * kTile);
      const int nrr = min(kRowsStep, G - cu.rc * kRowsStep);
      const float* stg = reinterpret_cast<const float*>(ring + cu.slot * s2);
      const float* hst = stg + rs * kTile;
      if (cu.rc == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) prt[0][b] = prt[1][b] = 0.f;
      }
      if (c < len) {
#pragma unroll 4
        for (int r = 0; r < nrr; ++r) {
          const float2 w2 =
              *reinterpret_cast<const float2*>(stg + r * kTile + c);
          const float4* hv = reinterpret_cast<const float4*>(hst + r * NB);
#pragma unroll
          for (int b4 = 0; b4 < NB / 4; ++b4) {
            const float4 h4 = hv[b4];
            const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // each h read once, both columns
              prt[0][4 * b4 + i] = fmaf(h[i], w2.x, prt[0][4 * b4 + i]);
              prt[1][4 * b4 + i] = fmaf(h[i], w2.y, prt[1][4 * b4 + i]);
            }
          }
        }
      }
      if (cu.rc == rchunks - 1) {
        // the group's partial, added in selection order
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          acc[0][b] += prt[0][b];
          acc[1][b] += prt[1][b];
        }
        if (s == steps - 1 || cu.j == ng - 1) {   // the run's end
          if (c < len) {
            float* dst = a.part +
                         (size_t)(blockIdx.x + cu.ct) * NB * kTile + c;
#pragma unroll
            for (int b = 0; b < NB; ++b)
              *reinterpret_cast<float2*>(dst + b * kTile) =
                  make_float2(acc[0][b], acc[1][b]);
          }
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[0][b] = acc[1][b] = 0.f;
        }
      }
      next(cu);
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
  if (stats && blockIdx.x == gridDim.x - 1 && t < a.B * 3) {
    int v = 0;   // the blocks' counters (integers: any order)
#pragma unroll 8
    for (int i = 0; i < gridDim.x; ++i)
      v += __ldcg(a.tel_part + i * kMaxB * 3 + t);
    a.tel[t] = v;
  }
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

template <typename XT>
KernelFn pick_nb(int nb) {
  switch (nb) {
    case 4: return decode_kernel<XT, 4>;
    case 8: return decode_kernel<XT, 8>;
    case 16: return decode_kernel<XT, 16>;
  }
  return nullptr;
}
inline KernelFn pick(int x_dtype, int nb) {
  return x_dtype == 0   ? pick_nb<float>(nb)
         : x_dtype == 1 ? pick_nb<__nv_bfloat16>(nb)
                        : nullptr;
}

// opt fn in to smem bytes of dynamic shared memory (above 48 KB a kernel
// must ask); each kernel asks again only for more than it has
constexpr int kKernels = 2 * 3;   // x dtypes x nb
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

// Whether the plan's sizes hold what the kernel writes and reads: a chain
// row's sums, a gate/up stage's two row pieces of one round, a down stage's
// rows of Wd and of h, at least two stages of each in the ring, the ring
// and the chain batch inside the shared memory.
inline bool layout_fits(int d, int G, int nb, int rf, int s1, int s2, int cb,
                        int ring, int smem) {
  const int round = kThreads * kXRegs / nb;
  const int cols = d < round ? d : round;
  const int rs = G < kRowsStep ? G : kRowsStep;
  return rf == (1 + kWarps) * 2 * nb && s1 % 16 == 0 && s1 >= 2 * cols * 4 &&
         s2 % 16 == 0 && s2 >= rs * (kTile + nb) * 4 && ring >= 2 * s1 &&
         ring >= 2 * s2 && cb >= 1 && smem >= ring + cb * rf * 4;
}

}  // namespace mlp

extern "C" {

// Blocks of the kernel for (x_dtype, nb) with smem bytes of dynamic shared
// memory that one SM holds at once (the occupancy calculator).
int fused_sparse_mlp_occupancy(int x_dtype, int nb, int smem, int* blocks) {
  const mlp::KernelFn fn = mlp::pick(x_dtype, nb);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = mlp::opt_in(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, mlp::kThreads, (size_t)smem);
}

// One cooperative launch.  x (B, d) float32 (x_dtype 0) or bfloat16 (1),
// 16-byte aligned, 1 <= B <= nb; wg/wu/wd (k, d) float32, 16-byte aligned
// (wu null: ungated); sel (C,) int32 group ids, count () int32; gm_tok (B,
// k/G) float32, tel (B, 3) int32 and tel_part (grid x 48 int32), or all
// three null; y (B, d) float32.  The layout and the scratch come from
// kernels/sparse_mlp_fused.py's decode_plan: nb in {4, 8, 16}, rf (a chain
// row's floats), s1 and s2 (the stages' bytes), cb (rows a chain batch),
// ring (its bytes), grid, smem (ring + cb rows of rf floats); hbuf (C*G x
// nb floats), part ((grid + ceil(d/512)) x nb x 512 floats); bar: one
// uint32, zero before the first launch that uses it, which every launch
// leaves at zero (launches that share it must not overlap: one stream);
// trace: null, or grid x kTracePoints uint64.  act_kind 0 = relu, 1 =
// fatrelu(thr).  Returns cudaGetLastError() after the launch.
int fused_sparse_mlp(const void* x, int x_dtype, const void* wg,
                     const void* wu, const void* wd, const void* sel,
                     const void* count, const void* gm_tok, void* y,
                     void* tel, void* tel_part, void* hbuf, void* part,
                     void* bar, void* trace, int B, int d, int k, int C, int G,
                     int act_kind, float thr, int nb, int rf, int s1, int s2,
                     int cb, int ring, int grid, int smem, void* stream) {
  using namespace mlp;
  const KernelFn fn = pick(x_dtype, nb);
  if (fn == nullptr || B < 1 || B > nb || d < 4 || d % 4 || G < 1 ||
      k % G || C < 1 ||
      !layout_fits(d, G, nb, rf, s1, s2, cb, ring, smem) || grid < 1 ||
      (gm_tok == nullptr) != (tel == nullptr) ||
      (tel == nullptr) != (tel_part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.wg = static_cast<const float*>(wg);
  a.wu = static_cast<const float*>(wu);
  a.wd = static_cast<const float*>(wd);
  a.sel = static_cast<const int32_t*>(sel);
  a.count = static_cast<const int32_t*>(count);
  a.gm_tok = static_cast<const float*>(gm_tok);
  a.y = static_cast<float*>(y);
  a.tel = static_cast<int32_t*>(tel);
  a.tel_part = static_cast<int32_t*>(tel_part);
  a.hbuf = static_cast<float*>(hbuf);
  a.part = static_cast<float*>(part);
  a.bar = static_cast<unsigned*>(bar);
  a.trace = static_cast<unsigned long long*>(trace);
  a.B = B;
  a.d = d;
  a.k = k;
  a.C = C;
  a.G = G;
  a.act_kind = act_kind;
  a.thr = thr;
  a.rf = rf;
  a.s1 = s1;
  a.s2 = s2;
  a.cb = cb;
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

const char* fused_sparse_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
