// Microbenchmarks behind the sign-bit predictor's design
// (csrc/predict_margins.cuh), run by tools/predict_step0.py: the CUDA-core
// popcount rate, the binary (.and.popc, .xor.popc) and int8 mma.sync
// rates, and the b1 m16n8k256 fragment layout the kernel assumes.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// clk[0..1]: clock64 and globaltimer at start and end of block 0, thread 0
__global__ void popc_rate(const uint32_t* in, uint32_t* out, int iters,
                          long long* clk) {
  long long c0 = clock64();
  unsigned long long t0 = gtime();
  uint32_t a[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = in[(threadIdx.x + i) & 255] ^ blockIdx.x;
    s[i] = 0;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] += __popc(a[i] ^ (uint32_t)it);
  }
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r += s[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    clk[0] = clock64() - c0;
    clk[1] = (long long)(gtime() - t0);
  }
}

__global__ void mma_b1_rate(const uint32_t* in, int* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a0 = in[lane], a1 = in[lane + 32], a2 = in[lane + 64],
           a3 = in[lane + 96], b0 = in[lane + 128], b1 = in[lane + 160];
  int c[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

__global__ void mma_xor_rate(const uint32_t* in, int* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a0 = in[lane], a1 = in[lane + 32], a2 = in[lane + 64],
           a3 = in[lane + 96], b0 = in[lane + 128], b1 = in[lane + 160];
  int c[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

__global__ void mma_s8_rate(const uint32_t* in, int* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a0 = in[lane], a1 = in[lane + 32], a2 = in[lane + 64],
           a3 = in[lane + 96], b0 = in[lane + 128], b1 = in[lane + 160];
  int c[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp.  A (16 rows x 8 words), B (8 columns x 8 words) -> D (16 x 8)
// under the assumed layout: A reg0 = (row g, word t), reg1 = (g+8, t),
// reg2 = (g, 4+t), reg3 = (g+8, 4+t); B reg0 = (col g, word t), reg1 =
// (g, 4+t); C c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1).  Then the
// probes: a single set bit 0 in (lane L, register R) of A with B all ones
// (pa: 128 x 16 x 8), and of B with A all ones (pb: 64 x 16 x 8).
__global__ void mma_b1_layout(const uint32_t* A, const uint32_t* B, int* D,
                              int* pa, int* pb) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  int c[4];
  mma_b1(c, A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + 4 + t],
         A[(g + 8) * 8 + 4 + t], B[g * 8 + t], B[g * 8 + 4 + t]);
  auto put = [&](int* o) {
    o[g * 8 + 2 * t] = c[0];
    o[g * 8 + 2 * t + 1] = c[1];
    o[(g + 8) * 8 + 2 * t] = c[2];
    o[(g + 8) * 8 + 2 * t + 1] = c[3];
  };
  put(D);
  for (int p = 0; p < 128; ++p) {
    const int L = p >> 2, R = p & 3;
    uint32_t a[4];
    for (int r = 0; r < 4; ++r) a[r] = (lane == L && r == R) ? 1u : 0u;
    mma_b1(c, a[0], a[1], a[2], a[3], ~0u, ~0u);
    put(pa + p * 128);
  }
  for (int p = 0; p < 64; ++p) {
    const int L = p >> 1, R = p & 1;
    mma_b1(c, ~0u, ~0u, ~0u, ~0u, (lane == L && R == 0) ? 1u : 0u,
           (lane == L && R == 1) ? 1u : 0u);
    put(pb + p * 128);
  }
}

extern "C" {
int run_popc(const void* in, void* out, int grid, int block, int iters,
             void* clk, void* stream) {
  popc_rate<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, iters, (long long*)clk);
  return (int)cudaGetLastError();
}
int run_mma_b1(const void* in, void* out, int grid, int block, int iters,
               void* stream) {
  mma_b1_rate<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int*)out, iters);
  return (int)cudaGetLastError();
}
int run_mma_xor(const void* in, void* out, int grid, int block, int iters,
                void* stream) {
  mma_xor_rate<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int*)out, iters);
  return (int)cudaGetLastError();
}
int run_mma_s8(const void* in, void* out, int grid, int block, int iters,
               void* stream) {
  mma_s8_rate<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int*)out, iters);
  return (int)cudaGetLastError();
}
int run_layout(const void* A, const void* B, void* D, void* pa, void* pb,
               void* stream) {
  mma_b1_layout<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, (const uint32_t*)B, (int*)D, (int*)pa, (int*)pb);
  return (int)cudaGetLastError();
}
}
