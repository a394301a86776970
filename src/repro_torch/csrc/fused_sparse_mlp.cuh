// Capacity-gathered fused sparse gated MLP for a decode batch of at most 16
// tokens, shared by the two decode kernels: float32 weights
// (fused_sparse_mlp.cu, replacing the reference's fused_sparse_mlp) and
// int8 weights (fused_sparse_mlp_q.cu, replacing fused_sparse_mlp_q).  The
// two chunk kernels run on the tensor cores instead
// (fused_sparse_mlp_chunk_tc.cuh).
//
// For the first `count` of the C selected row groups sel[0..C) it computes
//     g = act(x Wg[rows]^T),  h = g * (x Wu[rows]^T)
//     y = sum over the selected rows of h[:, row] * Wd[row, :]   (float32)
// and, when tel is given, per-token int32 counters (actual, false_neg,
// realized) = (rows with g > 0, of those the ones whose own group margin
// gm_tok[b, sel] said skip, G * groups the token itself kept).
//   float32 weights: h is rounded to x's dtype before the down projection,
//     as the reference kernel does (a no-op for float32 x).
//   int8 weights (wg_s/wu_s (k, d/qg) and wd_s (k/qg, d) float32 scales):
//     each weight is scaled by its group's scale as it is read, x is taken
//     as float32 and h is not rounded, as the reference's int8 kernel does.
//     The reference sums a partial dot per quant group and then scales it;
//     scaling each product instead rounds differently, within float32
//     rounding of the same sum.
//
// What bounds it on an H100.  The weight bytes: 3 * count*G rows of d, 4
// bytes each for float32 (113 MB per layer at C=288 groups of 8 rows,
// d=4096: ~34 us at 3.35 TB/s) and 1 byte for int8 (28 MB plus ~1-2 MB of
// scales: ~9 us).  The operations, 6 * B * count*G * d flops on the CUDA
// cores (67 TFLOP/s for float32), pass the bytes at about B=48 for float32
// weights and B=12 for int8, so a decode batch (B <= 16) is bound by
// bytes, or close to it.
//
// Design: one cooperative launch in three phases separated by grid-wide
// barriers, so that the sum over groups is split across the whole card and
// still taken in one fixed order (y is identical from run to run; no float
// atomics).  The batch is one row block of up to 16 tokens (the template
// takes more row blocks; the grid is a multiple of their number and block
// i serves row block i % n_rb in every phase, so its token counters stay
// in registers).
//   1. gate/up: one warp per (row block, selected weight row), coalesced
//      4-element loads of Wg/Wu; the row block's x is staged in shared
//      memory in column chunks; the warp's dot products are shuffle-reduced
//      and lane b writes h[row, b] to a scratch buffer.  The blocks of the
//      row blocks walk the selected rows in step, so each weight row is
//      read from device memory about once and from L2 by the other row
//      blocks.  Telemetry counters stay in registers, then go to shared
//      memory and one global integer atomicAdd per block and column.
//   2. down: the selected rows are cut into slices; a block takes (slice,
//      128-column tile) items of its row block, its warps stream Wd rows of
//      the slice (32 lanes x 4 columns) and the 8 warp partials are summed
//      in a fixed tree; the slice partial goes to scratch.
//   3. y = sum of the slice partials in slice order.
// Only count*G rows of each matrix are read: a selection shorter than C
// leaves the remaining work items empty, which is where the bytes are saved.
// Launching cooperatively guarantees every block is resident, so the
// barriers cannot deadlock.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mlp {

constexpr int kMaxB = 16;                      // tokens of one row block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColTile = 128;                  // 32 lanes x 4 columns
// dynamic shared budget: with the static telemetry tile it stays under the
// 48 KB a block gets without opting in
constexpr int kSmemFloats = 46 * 1024 / 4;
constexpr int kMaxBlocksPerSM = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive weights as float32 (p 4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// scales of columns col..col+3 of one row of a (rows, d/qg) scale matrix
__device__ __forceinline__ float4 row_scales(const float* s, int col,
                                             int qg) {
  if (qg >= 4) {  // at most one group boundary among 4 columns
    const int q0 = col / qg, r = col - q0 * qg;
    const float a = __ldg(s + q0);
    const float b = r + 3 >= qg ? __ldg(s + q0 + 1) : a;
    return make_float4(a, r + 1 >= qg ? b : a, r + 2 >= qg ? b : a, b);
  }
  return make_float4(__ldg(s + col / qg), __ldg(s + (col + 1) / qg),
                     __ldg(s + (col + 2) / qg), __ldg(s + (col + 3) / qg));
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const XT* __restrict__ x,
             const WT* __restrict__ wg,
             const WT* __restrict__ wu,        // null: ungated
             const WT* __restrict__ wd,
             const float* __restrict__ wg_s,   // int8 only: (k, d/qg)
             const float* __restrict__ wu_s,
             const float* __restrict__ wd_s,   // int8 only: (k/qg, d)
             const int32_t* __restrict__ sel,
             const int32_t* __restrict__ count_ptr,
             const float* __restrict__ gm_tok,  // null: no stats
             float* __restrict__ y,
             int32_t* __restrict__ tel,         // null: no stats
             float* __restrict__ hbuf,          // (C*G, B)
             float* __restrict__ part,          // (S, B, d)
             unsigned* __restrict__ bar,        // zeroed
             int B, int d, int k, int C, int G, int qg, int act_kind,
             float thr, int dc, int rows_per_slice) {
  constexpr bool kQuant = std::is_same<WT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  __shared__ int tel_s[kMaxB * 3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int count = min(max(*count_ptr, 0), C);
  const int nrows = count * G;
  const int n_groups = k / G;
  const int nq = kQuant ? d / qg : 1;
  const bool gated = wu != nullptr;
  const bool stats = tel != nullptr;
  // this block's row block: tokens tok0 .. tok0 + Bt
  const int n_rb = (B + kMaxB - 1) / kMaxB;
  const int rb = blockIdx.x % n_rb;
  const int blk = blockIdx.x / n_rb, nblk = gridDim.x / n_rb;
  const int tok0 = rb * kMaxB;
  const int Bt = min(kMaxB, B - tok0);
  for (int t = threadIdx.x; t < kMaxB * 3; t += kThreads) tel_s[t] = 0;
  int my_act = 0, my_fn = 0, my_real = 0;  // lane b < Bt: token b's counters

  // ---- phase 1: h[n, b] for every selected row n, one warp per row -------
  for (int base = blk * kWarps; base < nrows; base += nblk * kWarps) {
    const int n = base + warp;
    const bool has = n < nrows;
    int gsel = 0, row = 0;
    if (has) {
      gsel = sel[n / G];
      row = gsel * G + n % G;
    }
    float ag[kMaxB], au[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) ag[b] = au[b] = 0.f;
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int len = min(dc, d - c0);
      __syncthreads();
      for (int t = threadIdx.x; t < Bt * len; t += kThreads) {
        const int b = t / len, i = t - b * len;
        sm[b * dc + i] = to_f(x[(size_t)(tok0 + b) * d + c0 + i]);
      }
      __syncthreads();
      if (!has) continue;
      const WT* grow = wg + (size_t)row * d + c0;
      const WT* urow = gated ? wu + (size_t)row * d + c0 : nullptr;
      for (int i4 = lane; i4 < len / 4; i4 += 32) {
        float4 gv = load4(grow + i4 * 4);
        float4 uv = gated ? load4(urow + i4 * 4) : make_float4(0, 0, 0, 0);
        if (kQuant) {
          const int col = c0 + i4 * 4;
          gv = mul4(gv, row_scales(wg_s + (size_t)row * nq, col, qg));
          if (gated)
            uv = mul4(uv, row_scales(wu_s + (size_t)row * nq, col, qg));
        }
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < Bt) {
            const float4 xv = reinterpret_cast<const float4*>(sm + b * dc)[i4];
            ag[b] = dot4(gv, xv, ag[b]);
            if (gated) au[b] = dot4(uv, xv, au[b]);
          }
        }
      }
    }
    if (has) {  // warp-uniform
      float gv = 0.f, uv = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < Bt) {
          float sg = ag[b], su = au[b];
          for (int o = 16; o > 0; o >>= 1) {
            sg += __shfl_xor_sync(0xffffffffu, sg, o);
            su += __shfl_xor_sync(0xffffffffu, su, o);
          }
          if (lane == b) {
            gv = sg;
            uv = su;
          }
        }
      }
      if (lane < Bt) {
        const float ga = act_kind == 0 ? fmaxf(gv, 0.f) : (gv > thr ? gv : 0.f);
        const float h = gated ? ga * uv : ga;
        hbuf[(size_t)n * B + tok0 + lane] =
            kQuant ? h : round_to(h, (XT*)nullptr);
        if (stats) {
          const bool live = ga > 0.f;
          const bool keep =
              gm_tok[(size_t)(tok0 + lane) * n_groups + gsel] <= 0.f;
          my_act += live;
          my_fn += live && !keep;
          my_real += keep;
        }
      }
    }
  }
  if (stats) {
    __syncthreads();
    if (lane < Bt) {
      atomicAdd(&tel_s[lane * 3 + 0], my_act);
      atomicAdd(&tel_s[lane * 3 + 1], my_fn);
      atomicAdd(&tel_s[lane * 3 + 2], my_real);
    }
    __syncthreads();
    if (threadIdx.x < Bt * 3 && tel_s[threadIdx.x])
      atomicAdd(tel + tok0 * 3 + threadIdx.x, tel_s[threadIdx.x]);
  }
  grid_barrier(bar, 1);

  // ---- phase 2: slice partials of h @ Wd, per 128-column tile ------------
  const int n_ct = (d + kColTile - 1) / kColTile;
  const int active_slices = (nrows + rows_per_slice - 1) / rows_per_slice;
  float* hs = sm;                              // (rows_per_slice, Bt)
  float* red = sm + ((rows_per_slice * Bt + 3) & ~3);  // (4, Bt, kColTile)
  for (int item = blk; item < active_slices * n_ct; item += nblk) {
    const int s = item / n_ct, ct = item - s * n_ct;
    const int n0 = s * rows_per_slice;
    const int n1 = min(nrows, n0 + rows_per_slice);
    __syncthreads();
    for (int t = threadIdx.x; t < (n1 - n0) * Bt; t += kThreads) {
      const int nn = t / Bt, b = t - nn * Bt;
      hs[t] = __ldcg(hbuf + (size_t)(n0 + nn) * B + tok0 + b);
    }
    __syncthreads();
    const int col = ct * kColTile + lane * 4;
    const bool colok = col < d;
    float acc[kMaxB][4];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
    if (colok) {
      for (int n = n0 + warp; n < n1; n += kWarps) {
        const int row = sel[n / G] * G + n % G;
        float4 wv = load4(wd + (size_t)row * d + col);
        if (kQuant)
          wv = mul4(wv, __ldg(reinterpret_cast<const float4*>(
                            wd_s + (size_t)(row / qg) * d + col)));
        const float* hr = hs + (n - n0) * Bt;
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < Bt) {
            const float hb = hr[b];
            acc[b][0] = fmaf(hb, wv.x, acc[b][0]);
            acc[b][1] = fmaf(hb, wv.y, acc[b][1]);
            acc[b][2] = fmaf(hb, wv.z, acc[b][2]);
            acc[b][3] = fmaf(hb, wv.w, acc[b][3]);
          }
        }
      }
    }
    // fixed-order tree over the 8 warps: 4..7 -> 0..3, 2..3 -> 0..1, 1 -> 0
    for (int half = kWarps / 2; half >= 1; half >>= 1) {
      __syncthreads();
      if (colok && warp >= half && warp < 2 * half) {
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < Bt)
            reinterpret_cast<float4*>(
                red + ((warp - half) * Bt + b) * kColTile)[lane] =
                make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      }
      __syncthreads();
      if (colok && warp < half) {
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < Bt) {
            const float4 o = reinterpret_cast<const float4*>(
                red + (warp * Bt + b) * kColTile)[lane];
            acc[b][0] += o.x;
            acc[b][1] += o.y;
            acc[b][2] += o.z;
            acc[b][3] += o.w;
          }
        }
      }
    }
    if (colok && warp == 0) {
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < Bt)
          *reinterpret_cast<float4*>(
              part + ((size_t)s * B + tok0 + b) * d + col) =
              make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
  }
  grid_barrier(bar, 2);

  // ---- phase 3: y = sum of the slice partials, in slice order -------------
  const size_t total = (size_t)B * d;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    float v = 0.f;
    for (int s = 0; s < active_slices; ++s)
      v += __ldcg(part + (size_t)s * total + e);
    y[e] = v;
  }
}

struct Plan {
  int grid, dc, n_slices, rows_per_slice, smem;
};

template <typename XT, typename WT>
cudaError_t make_plan(int B, int d, int cap_rows, Plan* p) {
  // phase 1 stages Bt x dc floats of x; phase 2 holds rows_per_slice x Bt
  // floats of h plus the 4 x Bt x 128 reduction tile
  const int bt = min(B, kMaxB);
  const int n_rb = (B + kMaxB - 1) / kMaxB;
  p->dc = min(d, (kSmemFloats / bt) / 4 * 4);
  const int rps_max = (kSmemFloats - 4 * kColTile * bt - 3) / bt;
  int occ = 0;
  p->smem = kSmemFloats * 4;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, fused_kernel<XT, WT>, kThreads, p->smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int resident = min(occ, kMaxBlocksPerSM) * sms;
  if (n_rb > resident) return cudaErrorInvalidConfiguration;
  p->grid = resident / n_rb * n_rb;            // a multiple of n_rb
  const int per_rb = p->grid / n_rb;
  const int n_ct = (d + kColTile - 1) / kColTile;
  int slices = max((per_rb + n_ct - 1) / n_ct,
                   (cap_rows + rps_max - 1) / rps_max);
  slices = max(1, min(slices, cap_rows));
  p->rows_per_slice = max(1, (cap_rows + slices - 1) / slices);
  p->n_slices = (cap_rows + p->rows_per_slice - 1) / p->rows_per_slice;
  return cudaSuccess;
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const void* wg_s, const void* wu_s,
                   const void* wd_s, const void* sel, const void* count,
                   const void* gm_tok, void* y, void* tel, void* hbuf,
                   void* part, void* bar, int B, int d, int k, int C, int G,
                   int qg, int act_kind, float thr, const Plan& p,
                   cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const WT* wgp = static_cast<const WT*>(wg);
  const WT* wup = static_cast<const WT*>(wu);
  const WT* wdp = static_cast<const WT*>(wd);
  const float* wgsp = static_cast<const float*>(wg_s);
  const float* wusp = static_cast<const float*>(wu_s);
  const float* wdsp = static_cast<const float*>(wd_s);
  const int32_t* selp = static_cast<const int32_t*>(sel);
  const int32_t* cntp = static_cast<const int32_t*>(count);
  const float* gmp = static_cast<const float*>(gm_tok);
  float* yp = static_cast<float*>(y);
  int32_t* telp = static_cast<int32_t*>(tel);
  float* hp = static_cast<float*>(hbuf);
  float* pp = static_cast<float*>(part);
  unsigned* bp = static_cast<unsigned*>(bar);
  int dc = p.dc, rps = p.rows_per_slice;
  void* args[] = {&xp,  &wgp, &wup, &wdp, &wgsp, &wusp, &wdsp, &selp,
                  &cntp, &gmp, &yp,  &telp, &hp,  &pp,   &bp,   &B,
                  &d,   &k,   &C,   &G,   &qg,  &act_kind, &thr, &dc,
                  &rps};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fused_kernel<XT, WT>, dim3(p.grid), dim3(kThreads), args,
      (size_t)p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The C entry points of one kernel (weight type WT, at most max_b rows; 0 =
// any): launch geometry for (B, d, C*G), out = {grid, dc, n_slices,
// rows_per_slice, smem} (the caller sizes hbuf, C*G*B floats, and part,
// n_slices*B*d floats, from it); and the launch.  x_dtype: 0 = float32,
// 1 = bfloat16.  act_kind: 0 = relu, 1 = fatrelu(thr).  wu null = ungated;
// gm_tok and tel null = no telemetry; the scales are given for int8 weights
// only (qg = quant group width).  tel and bar must be zeroed by the caller.
// The launch returns cudaGetLastError() after it (0 = launched).
template <typename WT>
int plan_entry(int max_b, int x_dtype, int B, int d, int cap_rows,
               int* out) {
  if (B < 1 || (max_b && B > max_b) || d % 4 || cap_rows < 1)
    return (int)cudaErrorInvalidValue;
  Plan p{};
  cudaError_t e =
      x_dtype == 0   ? make_plan<float, WT>(B, d, cap_rows, &p)
      : x_dtype == 1 ? make_plan<__nv_bfloat16, WT>(B, d, cap_rows, &p)
                     : cudaErrorInvalidValue;
  out[0] = p.grid;
  out[1] = p.dc;
  out[2] = p.n_slices;
  out[3] = p.rows_per_slice;
  out[4] = p.smem;
  return (int)e;
}

template <typename WT>
int launch_entry(int max_b, const void* x, int x_dtype, const void* wg,
                 const void* wu, const void* wd, const void* wg_s,
                 const void* wu_s, const void* wd_s, const void* sel,
                 const void* count, const void* gm_tok, void* y, void* tel,
                 void* hbuf, void* part, void* bar, int B, int d, int k,
                 int C, int G, int qg, int act_kind, float thr, int grid,
                 int dc, int n_slices, int rows_per_slice, int smem,
                 void* stream) {
  constexpr bool kQuant = std::is_same<WT, int8_t>::value;
  if (B < 1 || (max_b && B > max_b) || d % 4 || G < 1 || k % G ||
      grid % ((B + kMaxB - 1) / kMaxB))
    return (int)cudaErrorInvalidValue;
  if (kQuant != (wg_s != nullptr && wd_s != nullptr) ||
      (kQuant && (qg < 1 || d % qg || k % qg || qg % G ||
                  (wu != nullptr) != (wu_s != nullptr))))
    return (int)cudaErrorInvalidValue;
  Plan p{grid, dc, n_slices, rows_per_slice, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)launch<float, WT>(x, wg, wu, wd, wg_s, wu_s, wd_s, sel,
                                  count, gm_tok, y, tel, hbuf, part, bar, B,
                                  d, k, C, G, qg, act_kind, thr, p, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16, WT>(x, wg, wu, wd, wg_s, wu_s, wd_s,
                                          sel, count, gm_tok, y, tel, hbuf,
                                          part, bar, B, d, k, C, G, qg,
                                          act_kind, thr, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mlp

// The exported functions of one source: NAME_plan, NAME and
// NAME_error_string, for weight type WT and at most MAX_B rows (0 = any).
#define MLP_EXPORTS(NAME, WT, MAX_B)                                          \
  extern "C" {                                                                \
  int NAME##_plan(int x_dtype, int B, int d, int cap_rows, int* out) {        \
    return mlp::plan_entry<WT>(MAX_B, x_dtype, B, d, cap_rows, out);          \
  }                                                                           \
  int NAME(const void* x, int x_dtype, const void* wg, const void* wu,        \
           const void* wd, const void* wg_s, const void* wu_s,                \
           const void* wd_s, const void* sel, const void* count,              \
           const void* gm_tok, void* y, void* tel, void* hbuf, void* part,    \
           void* bar, int B, int d, int k, int C, int G, int qg,              \
           int act_kind, float thr, int grid, int dc, int n_slices,           \
           int rows_per_slice, int smem, void* stream) {                      \
    return mlp::launch_entry<WT>(MAX_B, x, x_dtype, wg, wu, wd, wg_s, wu_s,   \
                                 wd_s, sel, count, gm_tok, y, tel, hbuf,      \
                                 part, bar, B, d, k, C, G, qg, act_kind, thr, \
                                 grid, dc, n_slices, rows_per_slice, smem,    \
                                 stream);                                     \
  }                                                                           \
  const char* NAME##_error_string(int code) {                                 \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }                                                                           \
  }
