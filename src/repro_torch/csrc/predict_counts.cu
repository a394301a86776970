// Negative-product counts of the sign-bit predictor (the paper's Listing 1).
//
// Replaces: repro/kernels/predict.py:predict_counts (the Pallas TPU kernel
// _predict_kernel).  For every token b and gate-weight row r:
//     out[b, r] = popcount(px[b] XOR pw[r])  summed over the w words
// i.e. the number of products x[i] * Wg[r, i] whose signs differ.  Integer
// exact; the margin n_neg - alpha * (d - n_neg) is the caller's epilogue.
//
// What bounds it on an H100: bytes.  It reads the packed gate signs once,
// k * w * 4 bytes (5.6 MB at k=11008, d=4096), plus B * w * 4 of packed x,
// and writes B * k * 4; the B * k * w XOR/popcount/add triples (18 M at
// B=4) are far below the integer rate.  At 3.35 TB/s: ~1.7 us.
//
// Design (the decode predictor's inner loop, predict_margins.cuh): grid
// (row blocks of 64 rows, token tiles of 16 tokens).  The block copies its
// tile's packed x into shared memory; each of its 8 warps then walks one
// weight row at a time with coalesced 4-byte loads, keeps the tile's 16
// popcount sums in registers (each weight word read once for all tokens),
// reduces them with shuffles and parks the counts in shared memory, from
// where the block writes them out token-major and coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace counts {

constexpr int kMaxB = 16;           // tokens of one tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ pw, const int32_t* __restrict__ px,
             int32_t* __restrict__ out, int B_total, int w, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tok0 = blockIdx.y * kMaxB;
  const int B = min(kMaxB, B_total - tok0);    // tokens of this tile
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, k - r0);
  uint32_t* sx = reinterpret_cast<uint32_t*>(smem_raw);   // (B, w)
  int32_t* sc = reinterpret_cast<int32_t*>(sx + B * w);   // (rows, B)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int t = threadIdx.x; t < B * w; t += kThreads)
    sx[t] = (uint32_t)px[(size_t)tok0 * w + t];
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    int acc[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
    const int32_t* row = pw + (size_t)(r0 + r) * w;
    for (int i = lane; i < w; i += 32) {
      const uint32_t wv = (uint32_t)__ldg(row + i);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < B) acc[b] += __popc(wv ^ sx[b * w + i]);
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {  // B is block-uniform: every lane reaches the shuffles
        int v = acc[b];
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) sc[r * B + b] = v;
      }
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < B * rows; t += kThreads) {
    const int b = t / rows, rr = t - b * rows;
    out[(size_t)(tok0 + b) * k + r0 + rr] = sc[rr * B + b];
  }
}

}  // namespace counts

extern "C" {

// pw (k, w) int32, px (B, w) int32, both contiguous -> out (B, k) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int predict_counts(const void* pw, const void* px, void* out, int B, int w,
                   int k, void* stream) {
  if (B < 1 || w < 1 || k < 1) return (int)cudaErrorInvalidValue;
  using namespace counts;
  const dim3 grid((k + kRowsPerBlock - 1) / kRowsPerBlock,
                  (B + kMaxB - 1) / kMaxB);
  const int bt = B < kMaxB ? B : kMaxB;
  const size_t smem = (size_t)bt * w * 4 + (size_t)kRowsPerBlock * bt * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  count_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pw), static_cast<const int32_t*>(px),
      static_cast<int32_t*>(out), B, w, k);
  return (int)cudaGetLastError();
}

const char* predict_counts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
