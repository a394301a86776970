// Sign-bit packing of a matrix's rows into int32 words.
//
// Replaces: repro/kernels/sign_pack.py:sign_pack (the Pallas TPU kernel).
// Paper §IV-B1: done once for the gate weights at load and once per MLP
// call for the input x.
//
// out[r, i] bit b = (v[r, 32 i + b] < 0), LSB-first, for i < w = ceil(d/32).
// Zero and -0.0 pack as positive (bit 0), and so do the lanes past d of the
// last word, which the kernel reads as zero: no padded copy of v is needed.
//
// What bounds it on an H100: bytes.  It reads every element once and
// writes 1/32 (float32) or 1/16 (bfloat16) of that; the ballot is one
// instruction per 32 elements.  At load (11008 x 4096 float32) the read is
// 180 MB, ~54 us at 3.35 TB/s; a decode batch of 4 tokens reads 64 KB and
// is launch-bound.
//
// Design: one warp per output word.  Lane j loads element 32 i + j (a
// coalesced 128-byte read for float32) and __ballot_sync packs the warp's
// 32 predicates with lane j in bit j, which is the LSB-first layout.  The
// loop over words is warp-uniform, so every lane reaches the ballot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sign {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const T* __restrict__ v, int32_t* __restrict__ out,
                 long long rows, int d, int w) {
  const int lane = threadIdx.x & 31;
  const long long n_words = rows * w;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long word = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       word < n_words; word += stride) {
    const long long r = word / w;
    const int col = (int)(word - r * w) * 32 + lane;
    const float x = col < d ? to_f(v[r * d + col]) : 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, x < 0.f);
    if (lane == 0) out[word] = (int32_t)bits;
  }
}

template <typename T>
cudaError_t launch(const void* v, void* out, int rows, int d,
                   cudaStream_t stream) {
  const int w = (d + 31) / 32;
  const long long n_words = (long long)rows * w;
  long long blocks = (n_words + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sign_pack_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<int32_t*>(out), rows, d, w);
  return cudaGetLastError();
}

}  // namespace sign

extern "C" {

// v (rows, d) float32 (v_dtype 0) or bfloat16 (1), row-major and
// contiguous -> out (rows, ceil(d/32)) int32.  Returns cudaGetLastError()
// after the launch (0 = launched).
int sign_pack(const void* v, int v_dtype, void* out, int rows, int d,
              void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_dtype == 0) return (int)sign::launch<float>(v, out, rows, d, s);
  if (v_dtype == 1)
    return (int)sign::launch<__nv_bfloat16>(v, out, rows, d, s);
  return (int)cudaErrorInvalidValue;
}

const char* sign_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
