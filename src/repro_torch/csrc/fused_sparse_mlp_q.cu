// Fused sparse gated MLP for one decode step, int8 weights.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_q (the
// Pallas TPU kernel built by _make_kernel_q: int8 tiles with per-group
// float32 scales, gate and up through _qdot, the down projection scaled by
// the selection group's scale row).  A decode batch of at most 16 tokens is
// one row block of the shared kernel in fused_sparse_mlp.cuh instantiated
// for int8 weights: each weight is scaled as it is read, x is taken as
// float32 and h is not rounded, as in the reference.
//
// What bounds it on an H100: bytes.  A full selection reads 288 * 8 rows x
// 4096 x 3 int8 weights (28 MB) plus their scales: ~9 us at 3.35 TB/s, a
// quarter of the float32 kernel's.
#include "fused_sparse_mlp.cuh"

MLP_EXPORTS(fused_sparse_mlp_q, int8_t, 16)
