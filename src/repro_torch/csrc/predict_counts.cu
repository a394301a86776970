// Negative-product counts of the sign-bit predictor (the paper's Listing 1).
//
// Replaces: repro/kernels/predict.py:predict_counts (the Pallas TPU kernel
// _predict_kernel).  For every token b and gate-weight row r:
//     out[b, r] = popcount(px[b] XOR pw[r])  summed over the w words
// i.e. the number of products x[i] * Wg[r, i] whose signs differ.  Integer
// exact; the margin n_neg - alpha * (d - n_neg) is the caller's epilogue.
//
// The shared kernel of predict_margins.cuh, which says what bounds it and
// how it is laid out, with x's packed words as its source of x (bulk-copied
// like the gate-sign rows, so no cluster packs anything) and the counts
// epilogue: each output written once, nothing to zero.
#include "predict_margins.cuh"

extern "C" {

// pw (k, w) int32 and px (B, w) int32, both contiguous -> out (B, k) int32.
// tile, cluster (1), unit_rows (16), ctas, rstride and smem come from the
// host plan (kernels/predict.py:margins_plan with counts=True) and are
// checked against the header's layout.  Returns cudaGetLastError() after
// the launch (0 = launched).
int predict_counts(const void* pw, const void* px, void* out, int B, int w,
                   int k, int tile, int cluster, int unit_rows, int ctas,
                   int rstride, int smem, void* stream) {
  const predict::Plan p = predict::make_plan(
      B, w, k, 1, 0.f, tile, cluster, unit_rows, ctas, rstride, smem, true);
  return predict::dispatch_counts(px, pw, out, p, stream);
}

// How many CTAs with smem bytes of shared memory each fit on the card at
// once (clusters of 1); a negative value is minus a CUDA error code.
int predict_counts_max_clusters(int w, int smem) {
  return predict::max_clusters(predict::kPackedWords, w, 1, smem);
}

const char* predict_counts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
