// Fused sign-bit predictor for one decode step of the sparse MLP.
//
// Replaces: repro/kernels/predict.py:predict_group_margins (the Pallas TPU
// kernel built by _make_group_margins_kernel).  A decode batch of at most
// 16 tokens is one token tile of the shared kernel in predict_margins.cuh,
// which says what it computes, what bounds it and how it is laid out.
#include "predict_margins.cuh"

extern "C" {

// x (B <= 16, w*32) float32 (x_dtype 0) or bfloat16 (1), zero-padded;
// pw (k, w) int32; alpha (B,) float32 -> gm (B, k/G) float32 and cnt (B,)
// int32, which the caller zeroes.  Returns cudaGetLastError() after the
// launch (0 = launched).
int predict_group_margins(const void* x, int x_dtype, const void* pw,
                          const void* alpha, void* gm, void* cnt, int B,
                          int w, int k, int G, float d_valid, void* stream) {
  if (B > predict::kMaxB) return (int)cudaErrorInvalidValue;
  return predict::dispatch(x, x_dtype, pw, alpha, gm, cnt, B, w, k, G,
                           d_valid, stream);
}

const char* predict_group_margins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
