// Toolchain probe: y = 2x + 1 on float32.
//
// Replaces the TPU kernel tools/pallas_smoke.py::f, the JAX package's check
// that its toolchain compiles and launches a kernel at all. It lies on no
// data path; chip_smoke.py builds and launches it right after the build, on
// pallas_smoke.py's (8, 128) arange input. Its plain twin is
// ops/cuda/probe.py's `x * 2 + 1`.
//
// Exactness: 2x is exact, so __fmul_rn then __fadd_rn rounds once, as the
// plain version does; the two are equal bit for bit.
//
// What bounds it on an H100: bytes (one 4-byte read and one 4-byte write
// per element, one add and one exact product); at the probe's 4 KiB the
// launch itself takes longer. One thread per element, grid-stride.

#include <cuda_runtime.h>

namespace {

__global__ void probe_affine_kernel(const float* __restrict__ x,
                                    float* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = __fadd_rn(__fmul_rn(2.f, x[i]), 1.f);
  }
}

}  // namespace

extern "C" int probe_affine_launch(const void* x, void* y, long long n,
                                   void* stream) {
  constexpr int kThreads = 256;
  constexpr long long kMaxBlocks = 1 << 20;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  probe_affine_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
