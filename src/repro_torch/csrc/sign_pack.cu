// Sign-bit packing of a matrix's rows into int32 words.
//
// Replaces: repro/kernels/sign_pack.py:sign_pack (the Pallas TPU kernel).
// Paper §IV-B1: done once for the gate weights at load and once per MLP
// call for the input x.
//
// out[r, i] bit b = (v[r, 32 i + b] < 0), LSB-first, for i < w = ceil(d/32).
// Zero and -0.0 pack as positive (bit 0), and so do NaN and the lanes past
// d of the last word, which the kernel reads as zero: no padded copy of v
// is needed.
//
// What bounds it on an H100: bytes.  It reads every element once and
// writes 1/32 (float32) or 1/16 (bfloat16) of that.  At load (11008 x
// 4096 float32) the read is 180 MB, ~54 us at 3.35 TB/s; a decode batch
// of 4 tokens reads 32 KB and is launch-bound.
//
// Design.  The vector route (every row start 16-byte aligned: d * elem %
// 16 == 0 and an aligned base): each lane loads 16 bytes, 4 float32 or 8
// bf16 elements, and makes a nibble or a byte of their comparisons `< 0.f`
// (a comparison, not the sign bit, so -0.0 and NaN pack as 0); the 8 or 4
// lanes of one word OR their parts, shifted to the lane's place, by warp
// shuffles, and the first of them stores the word.  A warp's loads are 32
// neighbouring 16-byte vectors; each thread keeps up to kUnroll of them in
// flight before it packs, one a sweep of the whole grid over the rows.
// The host plan (kernels/sign_pack.py:plan) gives a small input a load a
// thread, spread over as many SMs as that takes, and a large one the
// card's resident blocks, which loop.
// The scalar route, a branch of the same kernel: one warp a word, lane j
// reads element 32 i + j and __ballot_sync packs the 32 comparisons with
// lane j in bit j.  It makes the last word of each row when d % 32 != 0 on
// the vector route, and every word of a launch whose rows are not all
// 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sign {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;    // 16-byte loads in flight per thread
constexpr int kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The comparisons v < 0 of one 16-byte load, element e (e-th from the
// lowest address) in bit e.
__device__ __forceinline__ unsigned neg_bits(uint4 q, float) {
  return (unsigned)(__uint_as_float(q.x) < 0.f)
       | (unsigned)(__uint_as_float(q.y) < 0.f) << 1
       | (unsigned)(__uint_as_float(q.z) < 0.f) << 2
       | (unsigned)(__uint_as_float(q.w) < 0.f) << 3;
}
__device__ __forceinline__ unsigned neg_bits(uint4 q, __nv_bfloat16) {
  const unsigned h[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {   // a bf16 is the high half of its float
    bits |= (unsigned)(__uint_as_float(h[k] << 16) < 0.f) << (2 * k);
    bits |= (unsigned)(__uint_as_float(h[k] & 0xffff0000u) < 0.f)
            << (2 * k + 1);
  }
  return bits;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const T* __restrict__ v, int32_t* __restrict__ out,
                 long long rows, int d, int w, int wv) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  if constexpr (kVec) {
    // words 0 .. wv-1 of every row (wv = d / 32): V lanes a word
    constexpr int E = 16 / (int)sizeof(T), V = 32 / E;
    const long long nv = rows * wv * V;        // 16-byte loads in all
    const bool dense = wv == w;                // d % 32 == 0
    const int sub = lane % V;
    const long long span = n_warps * 32;       // loads of one grid sweep
    for (long long c = warp * 32; c < nv; c += span * kUnroll) {
      uint4 q[kUnroll];                        // c is warp-uniform
      long long word[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * span >= nv) break;         // no load left this sweep
        const long long i = c + u * span + lane;
        long long el;
        if (dense) {
          el = i * E;
          word[u] = i / V;
        } else {
          const long long g = i / V, r = g / wv, k = g - r * wv;
          el = r * d + k * 32 + sub * E;
          word[u] = r * w + k;
        }
        q[u] = i < nv ? __ldcs(reinterpret_cast<const uint4*>(v + el))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * span >= nv) break;
        unsigned part = neg_bits(q[u], T()) << (E * sub);
#pragma unroll
        for (int o = 1; o < V; o <<= 1)
          part |= __shfl_xor_sync(0xffffffffu, part, o);
        if (sub == 0 && c + u * span + lane < nv)
          out[word[u]] = (int32_t)part;
      }
    }
  }
  // the scalar route: words wv .. w-1 of every row, one warp a word
  const int ns = w - wv;
  const long long n_words = rows * ns;
  for (long long s = warp; s < n_words; s += n_warps) {   // warp-uniform
    const long long r = s / ns;
    const int col = (wv + (int)(s - r * ns)) * 32 + lane;
    const float x = col < d ? to_f(v[r * d + col]) : 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, x < 0.f);
    if (lane == 0) out[r * w + col / 32] = (int32_t)bits;
  }
}

template <typename T>
cudaError_t launch(const void* v, void* out, int rows, int d, int wv,
                   int blocks, cudaStream_t stream) {
  const int w = (d + 31) / 32;
  if (wv < 0 || wv > d / 32 || blocks < 1 || blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  if (wv > 0 && ((long long)d * sizeof(T) % 16 || (uintptr_t)v % 16))
    return cudaErrorInvalidValue;   // the vector route needs aligned rows
  if (wv > 0)
    sign_pack_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<int32_t*>(out), rows, d, w,
        wv);
  else
    sign_pack_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<int32_t*>(out), rows, d, w,
        0);
  return cudaGetLastError();
}

}  // namespace sign

extern "C" {

// v (rows, d) float32 (v_dtype 0) or bfloat16 (1), row-major and
// contiguous -> out (rows, ceil(d/32)) int32.  vec_words: words a row the
// vector route makes (d / 32 when every row start is 16-byte aligned, else
// 0: the scalar route alone); blocks: the grid.  Both from the host plan.
// Returns cudaGetLastError() after the launch (0 = launched).
int sign_pack(const void* v, int v_dtype, void* out, int rows, int d,
              int vec_words, int blocks, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_dtype == 0)
    return (int)sign::launch<float>(v, out, rows, d, vec_words, blocks, s);
  if (v_dtype == 1)
    return (int)sign::launch<__nv_bfloat16>(v, out, rows, d, vec_words,
                                            blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* sign_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
