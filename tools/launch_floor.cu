// The launch floor: an empty kernel, the least device time a launch takes.
// chip_smoke.py builds it (open3d_slam_private_tpu_torch/kernels/_build.py,
// the same flags as the package's kernels) and times it alone and inside a
// captured CUDA graph, beside the raw pair sums of the moments kernel. No
// path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_empty() {}

}  // namespace

// `count` launches of the empty kernel, `blocks` blocks of 32 threads each,
// on `stream`. Returns cudaGetLastError() after the launches.
extern "C" int launch_floor_launch(int count, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count; ++i) launch_floor_empty<<<blocks, 32, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* launch_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
