// Fused sign-bit predictor for a prefill chunk of S rows.
//
// Replaces: repro/kernels/predict.py:predict_chunk_group_margins (the
// Pallas TPU kernel built by _make_chunk_group_margins_kernel, a grid of
// token blocks x k blocks).  Here the chunk is token tiles of at most 64
// rows of the shared kernel in predict_margins.cuh, one launch; each row's
// margins and count come from the same integer products and the same fmaf
// as in the decode kernel, so they are bitwise equal to it row by row, and
// the chunk-union selection equals the reference's.
#include "predict_margins.cuh"

extern "C" {

// x (S, w*32) float32 (x_dtype 0) or bfloat16 (1), zero-padded; pw (k, w)
// int32; alpha (S,) float32 -> gm (S, k/G) float32 and cnt (S,) int32,
// which the caller zeroes.  tile, cluster, unit_rows, ctas, rstride and
// smem come from the host plan (kernels/predict.py:margins_plan).  Returns
// cudaGetLastError() after the launch.
int predict_chunk_group_margins(const void* x, int x_dtype, const void* pw,
                                const void* alpha, void* gm, void* cnt,
                                int S, int w, int k, int G, float d_valid,
                                int tile, int cluster, int unit_rows,
                                int ctas, int rstride, int smem,
                                void* stream) {
  const predict::Plan p = predict::make_plan(
      S, w, k, G, d_valid, tile, cluster, unit_rows, ctas, rstride, smem,
      false);
  return predict::dispatch(x, x_dtype, pw, alpha, gm, cnt, p, stream);
}

// How many clusters of `cluster` CTAs (1 or 8) with smem bytes of shared
// memory each fit on the card at once; a negative value is minus a CUDA
// error code.
int predict_chunk_group_margins_max_clusters(int x_dtype, int w,
                                             int cluster, int smem) {
  return predict::max_clusters(x_dtype, w, cluster, smem);
}

const char* predict_chunk_group_margins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
