// probe: o = x + 1 over a float32 tensor, one launch.
//
// Replaces the TPU kernel heat_tpu/core/pallas_kernels.py:85
// _mosaic_available._probe (pallas_call :93), the trivial (8, 128) kernel
// heat_tpu compiles once before its first flash-attention call to learn
// whether the TPU runtime can run Mosaic kernels at all. Here it is the
// first launch of the port's kernel library on a card: the library runs it
// once after loading (heat_tpu_torch/core/_build.py), and a serving engine
// runs it once on its own card, so a build that cannot launch on that card
// fails at first use with the CUDA error. It gates nothing and falls back
// to nothing.
//
// What bounds it: nothing measurable; (8, 128) float32 is 4 KB each way,
// so its time is the launch itself. One thread per element.
#include "common.cuh"

namespace {

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

}  // namespace

// x and o: n contiguous float32 values on card `device`. Returns the
// launch's cudaError_t.
extern "C" int heat_probe(const void* x, void* o, int64_t n, int device, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return cudaGetLastError();
}
