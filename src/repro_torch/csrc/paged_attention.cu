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
// 2 * live * K * hd * sizeof(T) per slot (8.4 MB at B=4, 128 live tokens,
// K=32, hd=128, bf16: ~2.5 us at 3.35 TB/s), and does ~4 * H * live * hd
// flops, far below any compute bound.
//
// Design: one 128-thread block per (kv head, slot), serving the kv head's
// rep query heads, so K and V rows are read once for all of them.  The
// block loads its own table row and length (the TPU's scalar prefetch).
// The reference's two-pass order is kept, with no online softmax (a
// running max would round p at other values):
//   1. one warp per live lane: 16-byte loads of the K row, dot products
//      with q (float32 in shared memory) reduced by shuffles, float32
//      scores into shared memory (rep * s_max * 4 bytes);
//   2. per query head: block max, then p = expf(s - m) in place and the
//      block sum l, each reduced in a fixed order;
//   3. one warp per live lane again: 16-byte loads of the V row, rounded p
//      times v accumulated in registers for up to 4 query heads at once;
//      the four warps' partials are summed in a fixed order in shared
//      memory and divided by max(l, 1e-30).
// No float atomics: the result is the same from run to run.  Block ids are
// clamped into the pool, so a garbage table row (a dead slot's) reads
// garbage but never faults.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRepGroup = 4;       // query heads accumulated together in 3.
constexpr int kMaxChunksPerLane = 2;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;  // layers/attention.py NEG_INF

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

// block-wide reductions in a fixed order; `red` holds kWarps floats
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

inline size_t smem_bytes(int rep, int hd, int s_max) {
  return sizeof(float) * ((size_t)rep * hd + (size_t)kWarps * kRepGroup * hd
                          + kWarps + rep + (size_t)rep * s_max);
}

template <typename T, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ out, int H, int K, int hd, int N,
                       int bs, int nbps, float scale, float softcap,
                       int window) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int rep = H / K;
  const int s_max = nbps * bs;
  const int nchunk = hd / VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = reinterpret_cast<float*>(smem_raw);     // (rep, hd)
  float* o_s = q_s + rep * hd;                          // (warps, group, hd)
  float* red = o_s + kWarps * kRepGroup * hd;           // (warps)
  float* l_s = red + kWarps;                            // (rep)
  float* s_s = l_s + rep;                               // (rep, s_max)

  const int len = lengths[b];
  int t_lo = window > 0 ? max(0, len - window + 1) : 0;
  int t_hi = min(len, s_max - 1);
  const bool none_live = t_hi < t_lo;
  if (none_live) {          // every lane masked: uniform over all of them
    t_lo = 0;
    t_hi = s_max - 1;
  }
  const int span = t_hi - t_lo + 1;
  const int32_t* trow = table + (size_t)b * nbps;
  const size_t head_off = (size_t)kh * hd;
  const size_t row_stride = (size_t)K * hd;

  for (int i = threadIdx.x; i < rep * hd; i += kThreads) {
    const int r = i / hd, e = i - r * hd;
    q_s[i] = round_to<T>(to_f(q[((size_t)b * H + kh * rep + r) * hd + e]));
  }
  __syncthreads();

  auto row = [&](const T* base, int t) {
    const int blk = min(max(trow[t / bs], 0), N - 1);
    return base + ((size_t)blk * bs + (t % bs)) * row_stride + head_off;
  };

  // 1. scores of the live lanes, one warp per lane
  for (int t = t_lo + warp; t <= t_hi; t += kWarps) {
    if (none_live) {
      if (lane == 0)
        for (int r = 0; r < rep; ++r) s_s[r * s_max + t] = kNegInf;
      continue;
    }
    const T* kr = row(kp, t);
    float kv[kMaxChunksPerLane][VEC];
#pragma unroll
    for (int i = 0; i < kMaxChunksPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunk) {
        load16(kr + c * VEC, kv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[i][j] = 0.f;
      }
    }
    for (int r = 0; r < rep; ++r) {
      const float* qr = q_s + r * hd;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunksPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < nchunk) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc = fmaf(qr[c * VEC + j], kv[i][j], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0)
        s_s[r * s_max + (t - t_lo)] =
            softcap > 0.f ? tanhf(acc * scale) * softcap : acc * scale;
    }
  }
  __syncthreads();

  // 2. per query head: max, p = exp(s - m) in place, l = sum p
  for (int r = 0; r < rep; ++r) {
    float* sr = s_s + r * s_max;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < span; i += kThreads) m = fmaxf(m, sr[i]);
    m = block_max(m, red);
    float l = 0.f;
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const float p = expf(sr[i] - m);
      sr[i] = p;
      l += p;
    }
    l = block_sum(l, red);
    if (threadIdx.x == 0) l_s[r] = l;
  }
  __syncthreads();

  // 3. o = sum_t round_T(p) * v, up to kRepGroup query heads per pass
  for (int r0 = 0; r0 < rep; r0 += kRepGroup) {
    const int nr = min(kRepGroup, rep - r0);
    float acc[kRepGroup][kMaxChunksPerLane][VEC];
#pragma unroll
    for (int rr = 0; rr < kRepGroup; ++rr)
#pragma unroll
      for (int i = 0; i < kMaxChunksPerLane; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[rr][i][j] = 0.f;
    for (int t = t_lo + warp; t <= t_hi; t += kWarps) {
      const T* vr = row(vp, t);
      float vv[kMaxChunksPerLane][VEC];
#pragma unroll
      for (int i = 0; i < kMaxChunksPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < nchunk) {
          load16(vr + c * VEC, vv[i]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) vv[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRepGroup; ++rr) {
        if (rr < nr) {
          const float p = round_to<T>(s_s[(r0 + rr) * s_max + (t - t_lo)]);
#pragma unroll
          for (int i = 0; i < kMaxChunksPerLane; ++i)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[rr][i][j] = fmaf(p, vv[i][j], acc[rr][i][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRepGroup; ++rr) {
      if (rr < nr) {
#pragma unroll
        for (int i = 0; i < kMaxChunksPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < nchunk) {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              o_s[(warp * kRepGroup + rr) * hd + c * VEC + j] = acc[rr][i][j];
          }
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * hd; idx += kThreads) {
      const int rr = idx / hd, e = idx - rr * hd;
      float o = o_s[rr * hd + e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) o += o_s[(w * kRepGroup + rr) * hd + e];
      out[((size_t)b * H + kh * rep + r0 + rr) * hd + e] =
          o / fmaxf(l_s[r0 + rr], 1e-30f);
    }
    __syncthreads();
  }
}

template <typename T, typename QT>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* out, int B, int H, int K, int hd,
           int N, int bs, int nbps, float scale, float softcap, int window,
           size_t smem, cudaStream_t stream) {
  auto kern = paged_attention_kernel<T, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(K, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), H, K,
      hd, N, bs, nbps, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace paged

extern "C" {

// q (B, H, hd) float32 (q_dtype 0) or bfloat16 (1); k/v pages (N, bs, K,
// hd) float32 (kv_dtype 0) or bfloat16 (1), 16-byte aligned; table
// (B, nbps) and lengths (B,) int32 -> out (B, H, hd) float32.  Returns
// cudaGetLastError() after the launch (0 = launched).
int paged_attention(const void* q, int q_dtype, const void* k_pages,
                    const void* v_pages, int kv_dtype, const void* table,
                    const void* lengths, void* out, int B, int H, int K,
                    int hd, int N, int bs, int nbps, float scale,
                    float softcap, int window, void* stream) {
  const int vec = kv_dtype ? 8 : 4;
  if (B < 1 || K < 1 || H % K || N < 1 || bs < 1 || nbps < 1 ||
      hd % vec || hd > paged::kMaxHeadDim || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = paged::smem_bytes(H / K, hd, nbps * bs);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, QT)                                               \
  return paged::launch<T, QT>(q, k_pages, v_pages, table, lengths, out, B, \
                              H, K, hd, N, bs, nbps, scale, softcap,       \
                              window, smem, s)
  if (kv_dtype) {
    if (q_dtype) PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    PAGED_LAUNCH(__nv_bfloat16, float);
  }
  if (q_dtype) PAGED_LAUNCH(float, __nv_bfloat16);
  PAGED_LAUNCH(float, float);
#undef PAGED_LAUNCH
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
