// Toolchain and launch probe: o = 2 x on float32.
//
// Replaces: src/repro/kernels/pa_elasticity/ops.py::_compile_probe (its
// inner Pallas kernel k), the capability probe behind the reference's lane
// resolution.  Here a failure raises; there is no other lane to select.
// It moves 8 bytes per element and does one multiply, so the bytes bound
// it; at its (8, 128) shape its time is the launch itself.

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ o,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

}  // namespace

extern "C" int probe_f32(const void* x, void* o, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
