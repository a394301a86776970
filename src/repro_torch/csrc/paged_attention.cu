// Paged decode attention over the KV pool's pages.
//
// Replaces: repro/kernels/paged_attn.py:paged_attention (the Pallas TPU
// kernel: one grid step per slot gathers the slot's pages by its block
// table into VMEM and runs one full-width masked softmax).
//
// What it computes, per slot b and query head h (kv head kh = h / rep):
//   s[t] = dot(round_T(q[b, h]), k[t]) * c, or tanh(dot * c) * softcap
//          with softcap > 0; c is folded by the wrapper in double
//          precision (hd^-0.5, or hd^-0.5 / softcap) and passed as one float
//   for the live lanes t <= length[b] (and length[b] - t < window), where
//   k[t] = k_pages[table[b, t / block], t % block, kh]
//   m = max_t s;  p = exp(s - m);  l = sum_t p
//   o[b, h] = sum_t round_T(p[t]) * v[t] / max(l, 1e-30)   (float32 out)
// round_T rounds to the pool dtype T, as the reference does before each
// product (q.astype(k.dtype), p.astype(v.dtype)).  The reference masks
// every other lane to -1e30, whose softmax weight is exactly +0.0, so
// skipping those lanes changes no value: the bytes read follow the live
// length, not max_len.  With no live lane at all (a window past the end)
// the reference's softmax is uniform over all s_max lanes; that case runs
// every lane with the masked score.
//
// What bounds it on an H100: bytes.  It reads the live K and V rows,
// 2 * live * K * hd * sizeof(T) per slot, and does ~4 * H * live * hd
// flops, far below any compute bound.  A decode batch is small, so the
// kernel is short and what holds it back is latency: a block that walks
// its rows one load at a time waits one memory round trip per row, and a
// grid that does not fit on the card at once pays a second wave.
//
// Design: a thread-block cluster of P CTAs of 4 warps (P <= 8, the
// portable limit) per (kv head, slot, group of up to 8 query heads); grid
// (K * P, B, groups).  The host plan (kernels/paged_attn.py:plan) doubles
// P while the whole grid still fits on the card at once (the occupancy
// calculator's count of clusters) and a CTA would hold more than 64 of
// max_len's rows; past one wave only while it would hold more than 512.
// The cluster splits the slot's live span [t_lo, t_hi] into P even
// segments, one per CTA, so a long slot is read by P SMs at once.
//   0. each CTA stages its segment's block ids (clamped into the pool, so
//      a dead slot's garbage table never faults) and q rounded to T;
//   1. its K rows stream through a ring of kStages shared-memory tiles of
//      ~8 KB, filled by 16-byte cp.async copies (several per thread, the
//      next kStages - 1 tiles always in flight); eight lanes share a row's
//      dot product, read from shared memory; float32 scores stay in the
//      CTA's shared memory (rep x ceil(s_max / P) floats);
//   2. every CTA publishes its segment maxima; after cluster.sync() each
//      reads all P of them over distributed shared memory, so every CTA
//      holds the same global m and p = exp(s - m) is rounded to T at
//      exactly the reference's values (a flash-decoding combine, with a
//      maximum per segment, would round p elsewhere); the V tiles' copies
//      were issued before this step, behind the K tiles, in the same ring;
//   3. rounded p times the V rows, accumulated in registers per (row
//      group, 16-byte column chunk), summed over row groups in a fixed
//      order in shared memory;
//   4. after a second cluster.sync() the CTAs sum the P partial outputs
//      and segment sums over distributed shared memory in rank order
//      0..P-1, each CTA a 1/P share of the columns, and divide.  A last
//      cluster.sync() keeps every CTA's shared memory alive until all
//      reads of it are done.
// A CTA whose segment is empty still reaches every cluster.sync(): it
// publishes m = -inf, l = 0 and o = 0.  No float atomics: the result is
// the same from run to run.  One launch per call.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace paged {

// the host plan in kernels/paged_attn.py mirrors these constants
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // tiles in the shared-memory ring
constexpr int kStageBytes = 8192;   // a tile's target size
constexpr int kMinTileRows = 8;
constexpr int kMaxTileRows = 64;
constexpr int kRowLanes = 8;        // lanes that share one row's dot product
constexpr int kMaxRepGroup = 8;     // query heads per CTA
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxHeadDim = 256;
constexpr size_t kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;   // layers/attention.py NEG_INF

// byte offsets into dynamic shared memory
struct Layout {
  size_t q, o, s, m, l, blk, total;
};

inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

inline int tile_rows(int row_bytes) {
  const int r = kStageBytes / row_bytes / 8 * 8;
  return r < kMinTileRows ? kMinTileRows
                          : (r > kMaxTileRows ? kMaxTileRows : r);
}

inline int rep_group(int rep) {
  int g = 1;
  while (g < rep && g < kMaxRepGroup) g *= 2;
  return g;
}

// ring (K/V tiles; reused for step 3's row-group sums), q, o, scores,
// segment maxima, segment sums, the segment's block ids
inline Layout layout(int rg, int hd, int elem, int bs, int seg_rows,
                     int tr) {
  const int nchunk = hd * elem / 16;
  const size_t ring = (size_t)kStages * tr * hd * elem;
  const size_t red = (size_t)(kThreads / nchunk) * hd * sizeof(float);
  Layout L;
  L.q = align16(ring > red ? ring : red);
  L.o = L.q + align16((size_t)rg * hd * sizeof(float));
  L.s = L.o + align16((size_t)rg * hd * sizeof(float));
  L.m = L.s + align16((size_t)rg * seg_rows * sizeof(float));
  L.l = L.m + align16((size_t)rg * sizeof(float));
  L.blk = L.l + align16((size_t)rg * sizeof(float));
  L.total = L.blk + align16(((size_t)(seg_rows + bs - 1) / bs + 1) * 4);
  return L;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));   // round to nearest even
}

// 16 bytes of T as floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the live span [t_lo, t_hi] of a slot: t <= len and len - t < window;
// with no live lane, every lane (the reference's uniform softmax)
__device__ __forceinline__ bool live_span(int len, int window, int s_max,
                                          int& t_lo, int& t_hi) {
  t_lo = window > 0 ? max(0, len - window + 1) : 0;
  t_hi = min(len, s_max - 1);
  if (t_hi >= t_lo) return true;
  t_lo = 0;
  t_hi = s_max - 1;
  return false;
}

template <typename T, typename QT, int RG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ out, int H, int K, int hd, int N,
                       int bs, int nbps, float scale, float softcap,
                       int window, int tr, int seg_rows, Layout lay) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kh = blockIdx.x / P, b = blockIdx.y;
  const int rep = H / K;
  const int h0 = kh * rep + blockIdx.z * RG;          // first query head
  const int nr = min(RG, rep - (int)blockIdx.z * RG);  // heads of this CTA
  const int s_max = nbps * bs;
  const int nchunk = hd / VEC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + lay.q);   // (RG, hd)
  float* o_s = reinterpret_cast<float*>(smem_raw + lay.o);   // (RG, hd)
  float* s_s = reinterpret_cast<float*>(smem_raw + lay.s);   // (RG, seg)
  float* m_s = reinterpret_cast<float*>(smem_raw + lay.m);   // (RG)
  float* l_s = reinterpret_cast<float*>(smem_raw + lay.l);   // (RG)
  int* blk_s = reinterpret_cast<int*>(smem_raw + lay.blk);

  // this CTA's segment [a, a + n) of the live span
  int t_lo, t_hi;
  const bool none_live = !live_span(lengths[b], window, s_max, t_lo, t_hi);
  const int span = t_hi - t_lo + 1;
  const int chunk = (span + P - 1) / P;
  const int a = t_lo + rank * chunk;
  const int n = max(0, min(chunk, t_hi + 1 - a));
  const int first_blk = a / bs;
  const int nblk = n > 0 ? (a + n - 1) / bs - first_blk + 1 : 0;

  // 0. block ids of the segment, q rounded to T
  const int32_t* trow = table + (size_t)b * nbps;
  for (int i = tid; i < nblk; i += kThreads)
    blk_s[i] = min(max(trow[first_blk + i], 0), N - 1);
  for (int i = tid; i < nr * hd; i += kThreads) {
    const int r = i / hd, e = i - r * hd;
    q_s[i] = round_to<T>(to_f(q[((size_t)b * H + h0 + r) * hd + e]));
  }
  __syncthreads();

  const size_t head_off = (size_t)kh * hd;
  const size_t row_stride = (size_t)K * hd;
  const int nt = (n + tr - 1) / tr;     // tiles of K, then as many of V
  // tile i of the stream: K tiles 0..nt-1, then V tiles; ring slot i % S
  auto issue = [&](int i) {
    if (i < 2 * nt && !(none_live && i < nt)) {
      const bool is_v = i >= nt;
      const T* base = is_v ? vp : kp;
      const int r0 = (is_v ? i - nt : i) * tr;
      const int rows = min(tr, n - r0);
      T* dst = ring + (size_t)(i % kStages) * tr * hd;
      for (int idx = tid; idx < rows * nchunk; idx += kThreads) {
        const int j = idx / nchunk, c = idx - j * nchunk;
        const int t = a + r0 + j;
        const int blk = blk_s[t / bs - first_blk];
        cp_async16(dst + j * hd + c * VEC,
                   base + ((size_t)blk * bs + t % bs) * row_stride +
                       head_off + c * VEC);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // 1. scores of the segment's rows: 8 lanes per row, 4 rows per warp
  const int g = lane & (kRowLanes - 1);
  for (int i = 0; i < nt; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int r0 = i * tr, rows = min(tr, n - r0);
    if (none_live) {
      for (int idx = tid; idx < nr * rows; idx += kThreads) {
        const int r = idx / rows, j = idx - r * rows;
        s_s[r * seg_rows + r0 + j] = kNegInf;
      }
    } else {
      const T* kt = ring + (size_t)(i % kStages) * tr * hd;
      for (int j0 = warp * (32 / kRowLanes); j0 < rows;
           j0 += kWarps * (32 / kRowLanes)) {
        const int j = j0 + lane / kRowLanes;
        const bool valid = j < rows;
        float acc[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) acc[r] = 0.f;
        if (valid) {
          for (int c = g; c < nchunk; c += kRowLanes) {
            float kv[VEC];
            load16(kt + j * hd + c * VEC, kv);
#pragma unroll
            for (int r = 0; r < RG; ++r) {
              if (r < nr) {
                const float4* qr =
                    reinterpret_cast<const float4*>(q_s + r * hd + c * VEC);
#pragma unroll
                for (int e4 = 0; e4 < VEC / 4; ++e4) {
                  const float4 qv = qr[e4];
                  acc[r] = fmaf(qv.x, kv[4 * e4], acc[r]);
                  acc[r] = fmaf(qv.y, kv[4 * e4 + 1], acc[r]);
                  acc[r] = fmaf(qv.z, kv[4 * e4 + 2], acc[r]);
                  acc[r] = fmaf(qv.w, kv[4 * e4 + 3], acc[r]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
#pragma unroll
          for (int o = kRowLanes / 2; o > 0; o >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
        if (valid && g == 0) {
#pragma unroll
          for (int r = 0; r < RG; ++r)
            if (r < nr)
              s_s[r * seg_rows + r0 + j] =
                  softcap > 0.f ? tanhf(acc[r] * scale) * softcap
                                : acc[r] * scale;
        }
      }
    }
    __syncthreads();
  }

  // 2. the cluster's global max per head, then p = exp(s - m) in place and
  //    the segment sums; a warp per query head
  for (int r = warp; r < nr; r += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[r * seg_rows + j]);
    mx = warp_max(mx);
    if (lane == 0) m_s[r] = mx;
  }
  cluster.sync();
  for (int r = warp; r < nr; r += kWarps) {
    float mp[kMaxCluster];   // all P loads in flight before the max
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      mp[p] = p < P ? *cluster.map_shared_rank(m_s + r, p) : -INFINITY;
    float m = mp[0];
#pragma unroll
    for (int p = 1; p < kMaxCluster; ++p) m = fmaxf(m, mp[p]);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      float* sp = s_s + r * seg_rows + j;
      const float e = expf(*sp - m);
      *sp = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) l_s[r] = l;
  }
  __syncthreads();

  // 3. o = sum_t round_T(p) * v: thread (row group, 16-byte chunk)
  const int nrg = kThreads / nchunk;
  const int rgi = tid / nchunk, c = tid - rgi * nchunk;
  float acc[RG][VEC];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  for (int i = nt; i < 2 * nt; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int r0 = (i - nt) * tr, rows = min(tr, n - r0);
    const T* vt = ring + (size_t)(i % kStages) * tr * hd;
    if (rgi < nrg) {
      for (int j = rgi; j < rows; j += nrg) {
        float vv[VEC];
        load16(vt + j * hd + c * VEC, vv);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          if (r < nr) {
            const float p = round_to<T>(s_s[r * seg_rows + r0 + j]);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  // the row groups' partials, summed in a fixed order (the ring is free)
  float* red = reinterpret_cast<float*>(smem_raw);   // (nrg, hd)
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (r < nr) {
      if (rgi < nrg) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[rgi * hd + c * VEC + e] = acc[r][e];
      }
      __syncthreads();
      for (int e = tid; e < hd; e += kThreads) {
        float o = 0.f;
        for (int w = 0; w < nrg; ++w) o += red[w * hd + e];
        o_s[r * hd + e] = o;
      }
      __syncthreads();
    }
  }

  // 4. sum the P partials in rank order and divide; CTA `rank` writes
  //    the elements rank, rank + P, ...
  cluster.sync();
  for (int idx = tid * P + rank; idx < nr * hd; idx += kThreads * P) {
    const int r = idx / hd;
    float op[kMaxCluster], lp[kMaxCluster];   // all loads in flight first
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) {
      if (p < P) {
        op[p] = *cluster.map_shared_rank(o_s + idx, p);
        lp[p] = *cluster.map_shared_rank(l_s + r, p);
      }
    }
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) {
      if (p < P) {
        o += op[p];
        l += lp[p];
      }
    }
    out[((size_t)b * H + h0) * hd + idx] = o / fmaxf(l, 1e-30f);
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// the launch configuration of one call; check_only asks the occupancy
// calculator how many such clusters fit on the card at once
template <typename T, typename QT, int RG>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* out, int B, int H, int K, int hd,
           int N, int bs, int nbps, float scale, float softcap, int window,
           int P, int tr, int seg_rows, const Layout& lay,
           cudaStream_t stream, int* max_clusters) {
  auto kern = paged_attention_kernel<T, QT, RG>;
  if (lay.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (H / K + RG - 1) / RG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * P, B, groups);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(
        max_clusters, reinterpret_cast<const void*>(kern), &cfg);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const QT*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), H, K,
      hd, N, bs, nbps, scale, softcap, window, tr, seg_rows, lay);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// validates a call against the host plan and dispatches on the dtypes and
// the query-head group; max_clusters != nullptr asks occupancy only
inline int dispatch(const void* q, int q_dtype, const void* kp,
                    const void* vp, int kv_dtype, const void* table,
                    const void* lengths, void* out, int B, int H, int K,
                    int hd, int N, int bs, int nbps, float scale,
                    float softcap, int window, int P, int tr, int smem,
                    cudaStream_t stream, int* max_clusters) {
  const int elem = kv_dtype ? 2 : 4;
  const int vec = 16 / elem;
  if (B < 1 || K < 1 || H < K || H % K || N < 1 || bs < 1 || nbps < 1 ||
      hd < vec || hd % vec || hd > kMaxHeadDim || B > 65535 || P < 1 ||
      P > kMaxCluster || tr != tile_rows(hd * elem))
    return (int)cudaErrorInvalidValue;
  const int rg = rep_group(H / K);
  if ((H / K + rg - 1) / rg > 65535) return (int)cudaErrorInvalidValue;
  const int seg_rows = (nbps * bs + P - 1) / P;
  const Layout lay = layout(rg, hd, elem, bs, seg_rows, tr);
  if (lay.total != (size_t)smem || lay.total > kSmemLimit)
    return (int)cudaErrorInvalidValue;
#define PAGED_LAUNCH(T, QT, G)                                               \
  return launch<T, QT, G>(q, kp, vp, table, lengths, out, B, H, K, hd, N,    \
                          bs, nbps, scale, softcap, window, P, tr, seg_rows, \
                          lay, stream, max_clusters)
#define PAGED_GROUPS(T, QT)            \
  switch (rg) {                        \
    case 1: PAGED_LAUNCH(T, QT, 1);    \
    case 2: PAGED_LAUNCH(T, QT, 2);    \
    case 4: PAGED_LAUNCH(T, QT, 4);    \
    default: PAGED_LAUNCH(T, QT, 8);   \
  }
  if (kv_dtype) {
    if (q_dtype) PAGED_GROUPS(__nv_bfloat16, __nv_bfloat16);
    PAGED_GROUPS(__nv_bfloat16, float);
  }
  if (q_dtype) PAGED_GROUPS(float, __nv_bfloat16);
  PAGED_GROUPS(float, float);
#undef PAGED_GROUPS
#undef PAGED_LAUNCH
}

}  // namespace paged

extern "C" {

// q (B, H, hd) float32 (q_dtype 0) or bfloat16 (1); k/v pages (N, bs, K,
// hd) float32 (kv_dtype 0) or bfloat16 (1), 16-byte aligned; table
// (B, nbps) and lengths (B,) int32 -> out (B, H, hd) float32.  P (cluster
// size), tile_rows and smem (bytes) come from the host plan
// (kernels/paged_attn.py:plan) and are checked against this file's layout.
// Returns cudaGetLastError() after the launch (0 = launched).
int paged_attention(const void* q, int q_dtype, const void* k_pages,
                    const void* v_pages, int kv_dtype, const void* table,
                    const void* lengths, void* out, int B, int H, int K,
                    int hd, int N, int bs, int nbps, float scale,
                    float softcap, int window, int P, int tile_rows,
                    int smem, void* stream) {
  return paged::dispatch(q, q_dtype, k_pages, v_pages, kv_dtype, table,
                         lengths, out, B, H, K, hd, N, bs, nbps, scale,
                         softcap, window, P, tile_rows, smem,
                         static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the planned launch fit on the card at once
// (cudaOccupancyMaxActiveClusters); a negative value is minus a CUDA
// error code.  0 means the cluster cannot be scheduled.
int paged_attention_max_clusters(int q_dtype, int kv_dtype, int B, int H,
                                 int K, int hd, int bs, int nbps, int P,
                                 int tile_rows, int smem) {
  int n = 0;
  const int rc = paged::dispatch(nullptr, q_dtype, nullptr, nullptr,
                                 kv_dtype, nullptr, nullptr, nullptr, B, H,
                                 K, hd, 1, bs, nbps, 1.f, 0.f, 0, P,
                                 tile_rows, smem, nullptr, &n);
  return rc ? -rc : n;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
