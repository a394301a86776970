// Paged KV write: one K or V row per slot into the pool's pages, in place.
//
// Replaces: repro/kernels/paged_attn.py:paged_kv_write (the Pallas TPU
// kernel: pages[blocks[b], offsets[b]] = vals[b] on a sequential grid over
// the slots, the pages aliased in and out).
//
// What bounds it on an H100: launch latency.  It moves B * K * hd elements
// (64 KB read and 64 KB written at B=4, K=32, hd=128, bf16: ~0.04 us at
// 3.35 TB/s), far less than a launch costs.
//
// Design: one 128-thread block per slot copies its row with 16-byte loads
// and stores (4-byte or 2-byte ones when the row's bytes are not a
// multiple of 16).  Collisions: dead and pending slots all aim at the
// shared write-off block, where the TPU's sequential grid lets the last
// slot win; CUDA blocks run in no order.  So a slot skips its write when a
// later slot has the same (block, offset), an O(B) scan that is nothing at
// decode batch sizes, and the result is the plain version's, collisions
// included.  The kernel moves bytes and is dtype-agnostic; a row whose
// block or offset lies outside the pool is not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_write {

constexpr int kThreads = 128;

template <typename W>
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const unsigned char* src,
                                         int row_bytes) {
  W* d = reinterpret_cast<W*>(dst);
  const W* s = reinterpret_cast<const W*>(src);
  const int n = row_bytes / (int)sizeof(W);
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
paged_kv_write_kernel(unsigned char* __restrict__ pages,
                      const unsigned char* __restrict__ vals,
                      const int32_t* __restrict__ blocks,
                      const int32_t* __restrict__ offsets, int B, int N,
                      int bs, int row_bytes) {
  const int b = blockIdx.x;
  const int blk = blocks[b], off = offsets[b];
  for (int later = b + 1; later < B; ++later)
    if (blocks[later] == blk && offsets[later] == off) return;  // it wins
  if (blk < 0 || blk >= N || off < 0 || off >= bs) return;
  unsigned char* dst = pages + ((size_t)blk * bs + off) * row_bytes;
  const unsigned char* src = vals + (size_t)b * row_bytes;
  if (row_bytes % 16 == 0)
    copy_row<uint4>(dst, src, row_bytes);
  else if (row_bytes % 4 == 0)
    copy_row<uint32_t>(dst, src, row_bytes);
  else
    copy_row<uint16_t>(dst, src, row_bytes);
}

}  // namespace paged_write

extern "C" {

// pages (N, bs, row) with row_bytes bytes per row, vals (B, row) of the
// same dtype, both 16-byte aligned; blocks and offsets (B,) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int paged_kv_write(void* pages, const void* vals, const void* blocks,
                   const void* offsets, int B, int N, int bs, int row_bytes,
                   void* stream) {
  if (B < 1 || N < 1 || bs < 1 || row_bytes < 2 || row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  paged_write::paged_kv_write_kernel<<<B, paged_write::kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(pages),
      static_cast<const unsigned char*>(vals),
      static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(offsets), B, N, bs, row_bytes);
  return (int)cudaGetLastError();
}

const char* paged_kv_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
