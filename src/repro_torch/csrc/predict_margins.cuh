// Fused sign-bit predictor, shared by the decode kernel
// (predict_group_margins.cu) and the prefill-chunk kernel
// (predict_chunk_group_margins.cu).
//
// For every token b and every row group of G gate-weight rows it computes
//     n_neg[b, r] = popcount(sign(x[b]) XOR signs(Wg[r]))
//     m[b, r]     = n_neg - alpha[b] * (d_valid - n_neg)     (paper eq. 2)
//     gm[b, g]    = min over the G rows of group g
//     cnt[b]      = number of groups with gm <= 0
// The margin is one fmaf, a single rounding, as the jitted reference
// computes it, so gm and cnt are bitwise equal to the plain version, and a
// row's outputs do not depend on which launch or token tile computed it.
//
// What bounds it on an H100: bytes.  It reads the packed gate signs,
// k * d/32 * 4 bytes (5.6 MB at k=11008, d=4096), plus the activations, and
// does ~B*k*d/32 popcounts (about 2 GOP at B=16), far below the integer
// rate.  At 3.35 TB/s the sign read alone takes ~1.7 us.
//
// Design: grid (row blocks, token tiles of kMaxB tokens).  A block owns
// `gpb` consecutive groups (~64 rows) and one token tile.  Its 8 warps
// first pack the tile's signs into shared memory with __ballot_sync (lane i
// lands in bit i: the LSB-first layout).  Then one warp walks one weight
// row at a time with coalesced 4-byte loads, keeps the tile's popcount sums
// in registers, reduces them with shuffles and writes the row margin to
// shared memory.  The block then takes the group minima and adds gm <= 0
// into cnt[b] with an integer atomicAdd into a zeroed output.  A decode
// batch is one token tile; a chunk of S rows is ceil(S/16) tiles, which
// read the packed signs again from L2 (5.6 MB fits in its 50 MB).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace predict {

constexpr int kMaxB = 16;           // tokens of one tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
group_margins_kernel(const XT* __restrict__ x, const int32_t* __restrict__ pw,
                     const float* __restrict__ alpha, float* __restrict__ gm,
                     int32_t* __restrict__ cnt, int B_total, int w, int k,
                     int G, int gpb, float d_valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tok0 = blockIdx.y * kMaxB;
  const int B = min(kMaxB, B_total - tok0);   // tokens of this tile
  x += (size_t)tok0 * w * 32;
  alpha += tok0;
  cnt += tok0;
  uint32_t* px = reinterpret_cast<uint32_t*>(smem_raw);  // (B, w)
  float* rm = reinterpret_cast<float*>(px + B * w);       // (rows, B)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_groups = k / G;
  gm += (size_t)tok0 * n_groups;
  const int g0 = blockIdx.x * gpb;
  const int rows = min(gpb, n_groups - g0) * G;
  const int r0 = g0 * G;

  // 1. pack x's sign bits: word i of token b is ballot(x[b, 32 i + lane] < 0)
  //    (x is zero-padded to w*32 columns; zero and -0.0 pack as positive)
  for (int t = warp; t < B * w; t += kWarps) {
    const int b = t / w, i = t - b * w;
    const float v = to_f(x[(size_t)b * w * 32 + (size_t)i * 32 + lane]);
    const unsigned bits = __ballot_sync(0xffffffffu, v < 0.f);
    if (lane == 0) px[t] = bits;
  }
  __syncthreads();

  // 2. one warp per weight row: B popcount sums, shuffle-reduced
  for (int r = warp; r < rows; r += kWarps) {
    int acc[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
    const int32_t* row = pw + (size_t)(r0 + r) * w;
    for (int i = lane; i < w; i += 32) {
      const uint32_t wv = (uint32_t)__ldg(row + i);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < B) acc[b] += __popc(wv ^ px[b * w + i]);
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {  // B is block-uniform: every lane reaches the shuffles
        int v = acc[b];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) {
          const float nn = (float)v;
          rm[r * B + b] = fmaf(-alpha[b], d_valid - nn, nn);
        }
      }
    }
  }
  __syncthreads();

  // 3. group minima and the per-token count of kept groups
  for (int t = threadIdx.x; t < (rows / G) * B; t += kThreads) {
    const int gl = t / B, b = t - gl * B;
    float m = rm[(gl * G) * B + b];
    for (int j = 1; j < G; ++j) m = fminf(m, rm[(gl * G + j) * B + b]);
    gm[(size_t)b * n_groups + g0 + gl] = m;
    if (m <= 0.f) atomicAdd(cnt + b, 1);
  }
}

template <typename XT>
cudaError_t launch(const void* x, const void* pw, const void* alpha, void* gm,
                   void* cnt, int B, int w, int k, int G, float d_valid,
                   cudaStream_t stream) {
  const int n_groups = k / G;
  const int gpb = max(1, kRowsPerBlock / G);
  const dim3 grid((n_groups + gpb - 1) / gpb, (B + kMaxB - 1) / kMaxB);
  const int bt = min(B, kMaxB);
  const size_t smem = (size_t)bt * w * 4 + (size_t)gpb * G * bt * 4;
  auto kern = group_margins_kernel<XT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int32_t*>(pw),
      static_cast<const float*>(alpha), static_cast<float*>(gm),
      static_cast<int32_t*>(cnt), B, w, k, G, gpb, d_valid);
  return cudaGetLastError();
}

// x_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  cnt must be zeroed by the caller.
inline int dispatch(const void* x, int x_dtype, const void* pw,
                    const void* alpha, void* gm, void* cnt, int B, int w,
                    int k, int G, float d_valid, void* stream) {
  if (B < 1 || G < 1 || k % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)launch<float>(x, pw, alpha, gm, cnt, B, w, k, G, d_valid, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(x, pw, alpha, gm, cnt, B, w, k, G,
                                      d_valid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace predict
