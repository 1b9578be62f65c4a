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
// launch itself takes longer. So it does the least a launch can: each
// thread moves 4 elements as one float4 load and store when both pointers
// are 16-byte aligned (one CTA of 256 threads for (8, 128)), with scalar
// accesses for the last n % 4 elements and for unaligned views. Indices are
// 32-bit below 2^31 elements. One pass of CTAs covers n where that takes
// at most 1024 CTAs; above, the grid is capped at 8 CTAs an SM and
// strides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2048 threads: a full SM
constexpr long long kOnePassBlocks = 1024;

__device__ __forceinline__ float affine(float v) {
  return __fadd_rn(__fmul_rn(2.f, v), 1.f);
}

__device__ __forceinline__ float4 affine(float4 v) {
  return make_float4(affine(v.x), affine(v.y), affine(v.z), affine(v.w));
}

// y[i] = f(x[i]) for i < n: thread g of the grid takes g, and with kStride
// g + stride, g + 2 stride, ...
template <bool kStride, typename Index, typename T>
__device__ __forceinline__ void map(const T* __restrict__ x,
                                    T* __restrict__ y, Index n, Index g) {
  if (kStride) {
    const Index stride = static_cast<Index>(gridDim.x) * kThreads;
    for (Index i = g; i < n; i += stride) y[i] = affine(x[i]);
  } else if (g < n) {
    y[g] = affine(x[g]);
  }
}

// Index is unsigned int below 2^31 elements: g + stride cannot wrap there
template <bool kStride, typename Index>
__global__ void __launch_bounds__(kThreads) probe_affine_kernel(
    const float* __restrict__ x, float* __restrict__ y, Index n, bool vec) {
  const Index g = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (!vec) {
    map<kStride>(x, y, n, g);
    return;
  }
  const Index nv = n / 4;
  map<kStride>(reinterpret_cast<const float4*>(x),
               reinterpret_cast<float4*>(y), nv, g);
  if (g < n % 4) y[4 * nv + g] = affine(x[4 * nv + g]);
}

template <typename Index>
int launch(const float* x, float* y, Index n, cudaStream_t stream) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  // threads needed: one a float4 (and one a tail element) or one an element
  const Index items = vec ? (n / 4 > n % 4 ? n / 4 : n % 4) : n;
  const long long blocks = (static_cast<long long>(items) + kThreads - 1) /
                           kThreads;
  if (blocks <= kOnePassBlocks) {
    probe_affine_kernel<false, Index><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, stream>>>(x, y, n, vec);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  probe_affine_kernel<true, Index><<<
      static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0,
      stream>>>(x, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_affine_launch(const void* x, void* y, long long n,
                                   void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < (1ll << 31)) return launch<unsigned>(xf, yf, n, s);
  return launch<long long>(xf, yf, n, s);
}

extern "C" const char* probe_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
