// Fused sparse gated MLP for a prefill chunk of S rows, int8 weights.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp_chunk_q (the
// row-tiled twin of fused_sparse_mlp_q).  The shared kernel of
// fused_sparse_mlp.cuh for int8 weights over row blocks of 16 tokens, all
// driven by one chunk-union selection; per row it computes what
// fused_sparse_mlp_q computes.
//
// What bounds it on an H100: operations at S=64 (3.6 GFLOP on the CUDA
// cores, ~54 us), well above the ~9 us for its 28 MB of int8 weights.
#include "fused_sparse_mlp.cuh"

MLP_EXPORTS(fused_sparse_mlp_chunk_q, int8_t, 0)
