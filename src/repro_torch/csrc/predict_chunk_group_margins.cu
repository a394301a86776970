// Fused sign-bit predictor for a prefill chunk of S rows.
//
// Replaces: repro/kernels/predict.py:predict_chunk_group_margins (the
// Pallas TPU kernel built by _make_chunk_group_margins_kernel, a grid of
// token blocks x k blocks).  Here the chunk is ceil(S/16) token tiles of the
// shared kernel in predict_margins.cuh, one launch; each row's margins and
// count are computed by the same integer arithmetic and the same fmaf as in
// the decode kernel, so they are bitwise equal to it row by row, and the
// chunk-union selection equals the reference's.
//
// What bounds it on an H100: bytes, ~1.7 us for the 5.6 MB sign read at
// k=11008, d=4096 (plus S*d activations); the token tiles re-read the signs
// from L2, not from device memory.
#include "predict_margins.cuh"

extern "C" {

// x (S, w*32) float32 (x_dtype 0) or bfloat16 (1), zero-padded; pw (k, w)
// int32; alpha (S,) float32 -> gm (S, k/G) float32 and cnt (S,) int32,
// which the caller zeroes.  Returns cudaGetLastError() after the launch.
int predict_chunk_group_margins(const void* x, int x_dtype, const void* pw,
                                const void* alpha, void* gm, void* cnt,
                                int S, int w, int k, int G, float d_valid,
                                void* stream) {
  return predict::dispatch(x, x_dtype, pw, alpha, gm, cnt, S, w, k, G,
                           d_valid, stream);
}

const char* predict_chunk_group_margins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
