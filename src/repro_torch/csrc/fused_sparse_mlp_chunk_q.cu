// Fused sparse gated MLP for a prefill chunk of S rows (or a decode batch
// larger than the decode kernel takes), int8 weights with float32 scales,
// on Hopper's tensor cores.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_chunk_q (the
// row-tiled Pallas TPU kernel built by _make_kernel_q).  The kernel is
// fused_sparse_mlp_chunk_tc.cuh instantiated for int8_t weights; this
// source gives it its C interface.  It computes what the reference does:
// x taken as float32; gate and up through _qdot (per quant group of qg
// columns of d the dot with the int8 tile, times the row's scale
// wg_s[row, q], added in ascending q); h = act(g) * u, NOT rounded; per
// selected group (h_g Wd_q[g rows]) * wd_s[q(g), :], added in selection
// order.
//
// Numerics.  An int8 value is exact in bf16 and in TF32, and so is bf16 x:
// with bf16 x the gate/up products take one bf16 m16n8k16 MMA, with float32
// x two TF32 m16n8k8 MMAs (x split into big = rna_tf32(v) and small =
// rna_tf32(v - big)).  h stays float32; the combine splits it the same way,
// so down takes two TF32 MMAs, h's two parts against the exact int8 Wd.
// Each product is then a sum of exact products, within 2^-22 |a b| of the
// float32 product (the split's remainder).  The scales go where the
// reference puts them:
//   gate/up: the MMAs of one quant slab's columns (at most the 128 of a
//     stage) go into a zeroed fragment; each fragment row is multiplied by
//     its weight row's scale and added to the float32 sum in one fmaf (the
//     reference rounds the product, then the sum; fmaf keeps the product
//     exact).  A slab cut by the stage or by the split of d is scaled piece
//     by piece, in the split's chunk order, and the splits are added in
//     split order.
//   down: the MMAs of one selection group (G rows) go into a zeroed
//     fragment, which is multiplied per column by the group's scale row
//     and added (fmaf) in selection order.  With G % 8 == 0 an 8-deep K
//     step lies inside one group; otherwise a K step is cut into its
//     groups' rows, the other rows of h masked to 0.
// The MMA truncates when it adds into its accumulator: a slab's or group's
// partial (at most 16 K steps) may lose up to an ulp of its running value
// per step, toward zero, before its scale and round-to-nearest add.
//
// What bounds it on an H100.  At S=64, bf16 x, C=288 groups of 8 rows,
// d=4096, qg=128: 28.3 MB of int8 weights plus ~2 MB of scales and 1.6 MB
// of x and y (0.0095 ms at 3.35 TB/s); the products, 2.4 GFLOP of bf16
// (gate, up) and 2 TF32 passes of 1.2 GFLOP (down), take 0.0073 ms at the
// tensor cores' peaks.  The kernel it replaced ran the 3.6 GFLOP on the
// CUDA cores (0.054 ms at 67 TFLOP/s) and re-read every weight for each
// 16-token row block: 0.60 ms.  This one takes ~0.094 ms (PERF.md): its
// phases are bound by the instruction rate and latency of their mma.sync
// streams on 2 warps a scheduler (255 registers a thread), not by bytes
// or by the MMA pipe; wgmma is the step beyond.
//
// What the design does about it: the tile loop of the float32 chunk
// kernel.  Every selected weight is read from device memory once per chunk
// by one item of a grid that fills the card; gate/up stages of 64 rows x
// 128 int8 columns (the same 8 KB a matrix as the float32 kernel's 32
// columns) stream through a 3-stage cp.async ring, so two blocks fit an
// SM; the chunk's tokens are the MMA's N, so one weight tile serves a
// whole token tile of 64.  The int8 values become MMA operands in
// registers (a byte permute and a subtract, then a pack to bf16 for
// gate/up); bf16 x goes to the MMA as it lies in shared memory; the
// selection and each stage's first-slab scales are in shared memory, so
// no stage waits on a global load.  y is the same from run to run: fixed
// split, slice and group orders, no float atomics.
#include "fused_sparse_mlp_chunk_tc.cuh"

extern "C" {

// Blocks of the kernel for (x_dtype, nt) with smem bytes of dynamic shared
// memory that one SM holds at once (the occupancy calculator).
int fused_sparse_mlp_chunk_q_occupancy(int x_dtype, int nt, int smem,
                                       int* blocks) {
  return (int)mlp::tc::dispatch<int8_t, mlp::tc::Occupancy>(x_dtype, nt,
                                                             smem, blocks);
}

// One cooperative launch.  x (S, d) float32 (x_dtype 0) or bfloat16 (1);
// wg/wu/wd (k, d) int8 (wu null: ungated), wg_s/wu_s (k, d/qg) and wd_s
// (k/qg, d) float32; sel (C,) int32 group ids, count () int32; gm_tok
// (S, k/G) float32 and tel (S, 3) int32 zeroed, or both null; y (S, d)
// float32.  Scratch from kernels/sparse_mlp_fused.py's plan: gu (g
// partials, then u partials at u_off), ht (s_pad x h_stride (big, small)
// pairs), part (slices x S x d), bar (one zeroed uint32).  smem: the ring
// and the selection (fused_sparse_mlp_chunk_tc.cuh: sel_bytes).  act_kind 0 =
// relu, 1 = fatrelu(thr).  slice_unit: a multiple of 8 and of G.  trace:
// null, or grid x 8 uint64 (fused_sparse_mlp_chunk_tc.cuh: kTracePoints).
// Returns cudaGetLastError() after the launch.
int fused_sparse_mlp_chunk_q(const void* x, int x_dtype, const void* wg,
                             const void* wg_s, const void* wu,
                             const void* wu_s, const void* wd,
                             const void* wd_s, const void* sel,
                             const void* count, const void* gm_tok, void* y,
                             void* tel, void* gu, void* ht, void* part,
                             void* bar, void* trace, long long u_off, int S,
                             int d, int k, int C, int G, int qg, int act_kind,
                             float thr, int nt, int s_pad, int max_splits,
                             int h_stride, int slice_unit, int grid,
                             int smem, void* stream) {
  using namespace mlp::tc;
  const bool bf16 = x_dtype == 1;
  if (S < 1 || d < 4 || d % 4 || G < 1 || k % G || C < 1 || qg < 1 ||
      d % qg || k % qg || qg % G || (x_dtype != 0 && x_dtype != 1) ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || s_pad < S ||
      s_pad % (8 * nt) || max_splits < 1 || max_splits > kMaxSplits ||
      h_stride < C * G || h_stride % 8 || slice_unit < 8 ||
      slice_unit % 8 || slice_unit % G || grid < 1 ||
      smem < kStagesQ * stage_bytes_q(nt, bf16) + sel_bytes(C) ||
      (gm_tok == nullptr) != (tel == nullptr) || wg_s == nullptr ||
      wd_s == nullptr || (wu == nullptr) != (wu_s == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.wg = wg;
  a.wu = wu;
  a.wd = wd;
  a.wg_s = static_cast<const float*>(wg_s);
  a.wu_s = static_cast<const float*>(wu_s);
  a.wd_s = static_cast<const float*>(wd_s);
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
  a.qg = qg;
  a.nq = d / qg;
  a.slice_unit = slice_unit;
  return (int)dispatch<int8_t, Launch>(x_dtype, nt, (const Args*)&a, grid,
                                       smem,
                                       static_cast<cudaStream_t>(stream));
}

const char* fused_sparse_mlp_chunk_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
