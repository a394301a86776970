// Paged KV write: a decode step's K and V rows into the pool's pages, in
// place, in one launch.
//
// Replaces: repro/kernels/paged_attn.py:paged_kv_write (the Pallas TPU
// kernel: pages[blocks[b], offsets[b]] = vals[b] on a sequential grid over
// the slots, the pages aliased in and out; the decode step calls it for K
// and then for V, after computing the targets from the block table).
//
// What bounds it on an H100: launch latency.  It moves B * K * hd elements
// for K and as many for V (128 KB read and 128 KB written at B=4, K=32,
// hd=128, bf16: ~0.08 us at 3.35 TB/s), far less than a launch costs.  So
// the design spends launches, not bytes: one launch a layer where the
// first port made two writes and four small torch ops for the targets.
//
// Design.  `paged_kv_write_pair` takes both pools, both rows and the
// block table (B, nbps) int32 with cache_len (B,) int32 or int64 as the
// caller holds them; each slot computes its own target, blk =
// table[b, pos / bs] and off = pos % bs at pos = cache_len[b], where the
// host used to.  `paged_kv_write` takes the targets given (blocks and
// offsets (B,) int32, one pool): the reference's signature, the same
// kernel.  One 128-thread block copies one (slot, pool) row; the grid
// holds K and V of all B slots at once up to the card's resident blocks,
// and loops past that.  Copies use 16-byte loads and stores when the row
// bytes and both row addresses are multiples of 16, else 4-byte or 2-byte
// ones.  Collisions: dead and pending slots all aim at the shared
// write-off block, where the TPU's sequential grid lets the last slot win;
// CUDA blocks run in no order.  So a slot skips its write when a later
// slot has the same target, and the result is the plain version's,
// collisions included.  The block's threads find the later slots'
// targets in parallel, a slot a thread, and __syncthreads_or joins them:
// two dependent loads (cache_len, then the table) deep up to B = 129,
// where a loop over the later slots would chain two a slot.  The kernel
// moves bytes and is dtype-agnostic; a slot whose position lies outside
// its table row, or whose block or offset lies outside the pool, is not
// written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_write {

constexpr int kThreads = 128;
constexpr int kMaxBlocks = 132 * 16;   // 128-thread blocks resident at once

// Targets: given (blocks, offsets int32), or computed from the table and
// a cache_len of int32 or int64.
enum Mode { kGiven = 0, kLen32 = 1, kLen64 = 2 };

struct Args {
  unsigned char* pages[2];        // (N, bs, row) each: K, V
  const unsigned char* vals[2];   // (B, row) each
  const int32_t* idx;             // blocks (B,), or the table (B, nbps)
  const void* pos;                // offsets (B,) int32, or cache_len (B,)
  int pools, B, N, bs, nbps, row_bytes;
};

template <int kMode>
__device__ __forceinline__ void target(const Args& a, int b, int& blk,
                                       int& off) {
  if constexpr (kMode == kGiven) {
    blk = a.idx[b];
    off = static_cast<const int32_t*>(a.pos)[b];
  } else {
    const long long p =
        kMode == kLen32 ? (long long)static_cast<const int32_t*>(a.pos)[b]
                        : static_cast<const long long*>(a.pos)[b];
    if (p < 0 || p >= (long long)a.nbps * a.bs) {
      blk = off = -1;
      return;
    }
    const int q = (int)p;   // in range: 32-bit division, not 64-bit
    blk = a.idx[(long long)b * a.nbps + q / a.bs];
    off = q % a.bs;
  }
}

// A row copy: each thread's loads of a batch all in flight before its
// stores (the pointers come out of a struct, so the compiler cannot tell
// that they do not alias, and would wait for each load before the next).
template <typename W>
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const unsigned char* src,
                                         int row_bytes) {
  constexpr int kBatch = 4;
  W* d = reinterpret_cast<W*>(dst);
  const W* s = reinterpret_cast<const W*>(src);
  const int n = row_bytes / (int)sizeof(W);
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    W r[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k * kThreads < n) r[k] = s[i0 + k * kThreads];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k * kThreads < n) d[i0 + k * kThreads] = r[k];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) paged_kv_write_kernel(Args a) {
  for (int item = blockIdx.x; item < a.B * a.pools; item += gridDim.x) {
    const int b = item / a.pools, p = item - b * a.pools;
    int blk, off;
    target<kMode>(a, b, blk, off);       // the same loads in every thread
    // the later slots' targets, a slot a thread, in parallel
    bool later_same = false;
    for (int later = b + 1 + threadIdx.x; later < a.B; later += kThreads) {
      int lb, lo;
      target<kMode>(a, later, lb, lo);
      later_same |= lb == blk && lo == off;
    }
    if (__syncthreads_or(later_same)) continue;   // a later slot wins
    if (blk < 0 || blk >= a.N || off < 0 || off >= a.bs) continue;
    // p selects by value: an indexed parameter array would go to the stack
    unsigned char* dst = (p ? a.pages[1] : a.pages[0])
                         + ((size_t)blk * a.bs + off) * (size_t)a.row_bytes;
    const unsigned char* src =
        (p ? a.vals[1] : a.vals[0]) + (size_t)b * (size_t)a.row_bytes;
    const uintptr_t bits =
        (uintptr_t)dst | (uintptr_t)src | (uintptr_t)a.row_bytes;
    if (bits % 16 == 0)
      copy_row<uint4>(dst, src, a.row_bytes);
    else if (bits % 4 == 0)
      copy_row<uint32_t>(dst, src, a.row_bytes);
    else
      copy_row<uint16_t>(dst, src, a.row_bytes);
  }
}

int launch(const Args& a, int mode, cudaStream_t stream) {
  if (a.B < 1 || a.N < 1 || a.bs < 1 || a.row_bytes < 2 || a.row_bytes % 2
      || a.pools < 1 || a.pools > 2
      || (mode != kGiven
          && (a.nbps < 1 || (long long)a.nbps * a.bs > 0x7fffffffLL)))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.pools; ++p)
    if ((uintptr_t)a.pages[p] % 2 || (uintptr_t)a.vals[p] % 2)
      return (int)cudaErrorInvalidValue;
  const int items = a.B * a.pools;
  const int grid = items < kMaxBlocks ? items : kMaxBlocks;
  if (mode == kGiven)
    paged_kv_write_kernel<kGiven><<<grid, kThreads, 0, stream>>>(a);
  else if (mode == kLen32)
    paged_kv_write_kernel<kLen32><<<grid, kThreads, 0, stream>>>(a);
  else if (mode == kLen64)
    paged_kv_write_kernel<kLen64><<<grid, kThreads, 0, stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace paged_write

extern "C" {

// One pool, targets given: pages (N, bs, row) with row_bytes bytes per
// row, vals (B, row) of the same dtype; blocks and offsets (B,) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int paged_kv_write(void* pages, const void* vals, const void* blocks,
                   const void* offsets, int B, int N, int bs, int row_bytes,
                   void* stream) {
  paged_write::Args a{};
  a.pages[0] = static_cast<unsigned char*>(pages);
  a.vals[0] = static_cast<const unsigned char*>(vals);
  a.idx = static_cast<const int32_t*>(blocks);
  a.pos = offsets;
  a.pools = 1, a.B = B, a.N = N, a.bs = bs, a.nbps = 0;
  a.row_bytes = row_bytes;
  return paged_write::launch(a, paged_write::kGiven,
                             static_cast<cudaStream_t>(stream));
}

// The decode step's K and V in one launch: k_pages and v_pages
// (N, bs, row), k_vals and v_vals (B, row); table (B, nbps) int32,
// cache_len (B,) int32 (len_dtype 0) or int64 (1).  Slot b writes both
// rows at block table[b, cache_len[b] / bs], row cache_len[b] % bs.
int paged_kv_write_pair(void* k_pages, void* v_pages, const void* k_vals,
                        const void* v_vals, const void* table,
                        const void* cache_len, int len_dtype, int B, int N,
                        int bs, int nbps, int row_bytes, void* stream) {
  paged_write::Args a{};
  a.pages[0] = static_cast<unsigned char*>(k_pages);
  a.pages[1] = static_cast<unsigned char*>(v_pages);
  a.vals[0] = static_cast<const unsigned char*>(k_vals);
  a.vals[1] = static_cast<const unsigned char*>(v_vals);
  a.idx = static_cast<const int32_t*>(table);
  a.pos = cache_len;
  a.pools = 2, a.B = B, a.N = N, a.bs = bs, a.nbps = nbps;
  a.row_bytes = row_bytes;
  const int mode = len_dtype == 0   ? paged_write::kLen32
                   : len_dtype == 1 ? paged_write::kLen64
                                    : -1;
  return paged_write::launch(a, mode, static_cast<cudaStream_t>(stream));
}

const char* paged_kv_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
