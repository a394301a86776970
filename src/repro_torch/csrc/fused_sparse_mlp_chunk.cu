// Fused sparse gated MLP for a prefill chunk of S rows (or a decode batch
// larger than the decode kernel takes), float32 weights, on Hopper's
// tensor cores.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_chunk (the
// Pallas TPU kernel with a (row blocks, selection) grid).  The kernel is
// fused_sparse_mlp_chunk_tc.cuh; this source gives it its C interface.
//
// What bounds it on an H100: the bytes.  At S=64 and C=288 groups of 8
// rows it reads 113 MB of float32 weights (3 x 2304 rows x 4096 x 4
// bytes), once per chunk: 0.034 ms at 3.35 TB/s.  Its products run as TF32
// MMAs on split operands that keep float32 precision, 2 passes with bf16 x
// (7.2 GFLOP, 0.015 ms at 495 TFLOP/s) and 3 with float32 x.  The kernel
// it replaced ran the 3.6 GFLOP on the CUDA cores (0.054 ms at 67 TFLOP/s)
// and re-read every weight for each 16-token row block: 0.56 ms.  This one
// takes ~0.098 ms at S=64 (PERF.md): gate/up's ring reads the
// weights at about the rate a plain PyTorch reduction reads the same bytes
// contiguously on this card (~2 TB/s); the rest is the MMAs' share of the
// ring's time, the combine of the splits, three grid barriers and launch.
//
// What the design does about it: every selected weight is read from device
// memory once per chunk, by one item of a grid that fills the card (d is
// split for gate/up and the rows are sliced for down, as far as the grid
// has room), through a 4-stage ring in shared memory that keeps loads in
// flight across items; the chunk's tokens are the MMA's N, so one weight
// tile serves a whole token tile of 64.  y is the same from run to run:
// fixed split and slice orders, no float atomics.
#include "fused_sparse_mlp_chunk_tc.cuh"

extern "C" {

// Blocks of the kernel for (x_dtype, nt) with smem bytes of dynamic shared
// memory that one SM holds at once (the occupancy calculator).
int fused_sparse_mlp_chunk_occupancy(int x_dtype, int nt, int smem,
                                     int* blocks) {
  return (int)mlp::tc::dispatch<float, mlp::tc::Occupancy>(x_dtype, nt, smem,
                                                            blocks);
}

// One cooperative launch.  x (S, d) float32 (x_dtype 0) or bfloat16 (1);
// wg/wu/wd (k, d) float32 (wu null: ungated); sel (C,) int32 group ids,
// count () int32; gm_tok (S, k/G) float32 and tel (S, 3) int32 zeroed, or
// both null; y (S, d) float32.  Scratch from kernels/sparse_mlp_fused.py's
// plan: gu (g partials, then u partials at u_off), ht (s_pad x h_stride),
// part (slices x S x d), bar (one zeroed uint32).  act_kind 0 = relu, 1 =
// fatrelu(thr).  trace: null, or grid x 8 uint64 that take the phase trace
// (fused_sparse_mlp_chunk_tc.cuh: kTracePoints).  Returns
// cudaGetLastError() after the launch.
int fused_sparse_mlp_chunk(const void* x, int x_dtype, const void* wg,
                           const void* wu, const void* wd, const void* sel,
                           const void* count, const void* gm_tok, void* y,
                           void* tel, void* gu, void* ht, void* part,
                           void* bar, void* trace, long long u_off, int S,
                           int d, int k, int C, int G, int act_kind,
                           float thr, int nt, int s_pad, int max_splits,
                           int h_stride, int grid, int smem, void* stream) {
  using namespace mlp::tc;
  const bool bf16 = x_dtype == 1;
  if (S < 1 || d < 4 || d % 4 || G < 1 || k % G || C < 1 ||
      (x_dtype != 0 && x_dtype != 1) ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || s_pad < S ||
      s_pad % (8 * nt) || max_splits < 1 || max_splits > kMaxSplits ||
      h_stride < C * G || h_stride % 4 || grid < 1 ||
      smem < kStages * stage_bytes(nt, bf16) ||
      (gm_tok == nullptr) != (tel == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.wg = wg;
  a.wu = wu;
  a.wd = wd;
  a.sel = static_cast<const int32_t*>(sel);
  a.count = static_cast<const int32_t*>(count);
  a.gm_tok = static_cast<const float*>(gm_tok);
  a.y = static_cast<float*>(y);
  a.tel = static_cast<int32_t*>(tel);
  a.gu = static_cast<float*>(gu);
  a.ht = static_cast<float*>(ht);
  a.part = static_cast<float*>(part);
  a.bar = static_cast<unsigned*>(bar);
  a.trace = static_cast<unsigned long long*>(trace);
  a.u_off = u_off;
  a.S = S;
  a.d = d;
  a.k = k;
  a.C = C;
  a.G = G;
  a.act_kind = act_kind;
  a.thr = thr;
  a.s_pad = s_pad;
  a.max_splits = max_splits;
  a.h_stride = h_stride;
  a.slice_unit = kSliceUnit;
  return (int)dispatch<float, Launch>(x_dtype, nt, (const Args*)&a, grid,
                                      smem, static_cast<cudaStream_t>(stream));
}

const char* fused_sparse_mlp_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
