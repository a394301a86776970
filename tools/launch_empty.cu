// An empty kernel: the floor under which no launch of the port's kernels
// can go when timed the way chip_smoke.py times them (CUDA events behind a
// GPU sleep).  Built with nvcc into a library with a plain C interface by
// chip_smoke.py:empty_kernel and timed by tools/launch_step0.py and
// chip_smoke.py's write and sign-pack lines.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
