// Fused sparse gated MLP for a prefill chunk of S rows, float32 weights.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_chunk (the
// Pallas TPU kernel with a (row blocks, selection) grid).  One chunk-union
// selection drives every row block of 16 tokens of the shared kernel in
// fused_sparse_mlp.cuh; the row blocks walk the selected rows together, so
// each weight row streams from device memory about once per launch and is
// read again from L2 by the other row blocks.  Per row it computes what the
// decode kernel computes.
//
// What bounds it on an H100: operations at S=64 (6 * 64 * 2304 * 4096 flops
// = 3.6 GFLOP on the CUDA cores, ~54 us at 67 TFLOP/s, against ~34 us for
// the 113 MB of float32 weights).
#include "fused_sparse_mlp.cuh"

MLP_EXPORTS(fused_sparse_mlp_chunk, float, 0)
