// Fused sparse gated MLP for one decode step, float32 weights.
//
// Replaces: repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp (the Pallas
// TPU kernel built by _make_kernel, telemetry by _telemetry_delta).  A
// decode batch of at most 16 tokens is one row block of the kernel in
// fused_sparse_mlp.cuh, which says what it computes, what bounds it (bytes:
// ~34 us for a full 288-group selection at d=4096) and its design.
#include "fused_sparse_mlp.cuh"

MLP_EXPORTS(fused_sparse_mlp, 16)
