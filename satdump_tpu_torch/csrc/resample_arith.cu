// K2: polyphase interpolation on an arithmetic symbol grid.
//
// Replaces the TPU kernel satdump_tpu/ops/pallas/resample.py::
// resample_arith_grid. Its plain twin is ops/cuda/resample.py::
// resample_arith_grid_plain (the unmasked core of ops/ffsync.py::
// ff_resample_at).
//
// What it computes: for k < out_cap, p = (start + k*omega) + NTAPS/2 (the
// bank's group-delay shift); branch = clip(rint(frac(p) * 128), 0, 127);
// out[k] = sum_j ext[src + j] * bank[branch, j], j < 8, with
// src = clip(floor(p), 0, n_ext - NTAPS). The caller masks validity.
//
// Design: one thread per symbol; the 4 KB bank sits in shared memory.
// start and omega are read through device pointers, so the host never
// synchronizes to fetch them. The TPU kernel's DMA window, one-hot matmul
// and banded matmul existed only to avoid the TPU's slow gather; here the
// eight taps are direct loads, neighbouring threads reading neighbouring
// (overlapping) samples.
//
// Exactness: the position is formed with __fmul_rn / __fadd_rn in the
// reference's order, so nvcc cannot contract it into an FMA; rintf rounds
// half to even like torch.round, floorf floors. Branch picks therefore equal
// the plain version's; only the order of the 8-term sum differs.
//
// What bounds it on an H100: memory. Per symbol it reads ~sps complex
// samples (8 bytes each) once from DRAM and writes 8 bytes; the ~40 flops
// per symbol are far below the card's float32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int kNFilt = 128;
constexpr int kNTaps = 8;

__global__ void resample_arith_kernel(const float2* __restrict__ ext,
                                      int n_ext,
                                      const float* __restrict__ start_p,
                                      const float* __restrict__ omega_p,
                                      const float* __restrict__ bank,
                                      float2* __restrict__ out, int out_cap) {
  __shared__ float sbank[kNFilt * kNTaps];
  for (int i = threadIdx.x; i < kNFilt * kNTaps; i += blockDim.x) {
    sbank[i] = bank[i];
  }
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= out_cap) return;

  const float start = *start_p;
  const float omega = *omega_p;
  const float pos = __fadd_rn(start, __fmul_rn(static_cast<float>(k), omega));
  const float p = __fadd_rn(pos, 0.5f * kNTaps);
  const float ip = floorf(p);
  const float frac = __fsub_rn(p, ip);
  const int n_in = n_ext - (kNTaps - 1);
  int src = static_cast<int>(ip);
  src = min(max(src, 0), n_in - 1);
  int branch = static_cast<int>(rintf(__fmul_rn(frac, static_cast<float>(kNFilt))));
  branch = min(max(branch, 0), kNFilt - 1);

  const float* taps = sbank + branch * kNTaps;
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int j = 0; j < kNTaps; ++j) {
    const float2 v = ext[src + j];
    re = fmaf(v.x, taps[j], re);
    im = fmaf(v.y, taps[j], im);
  }
  out[k] = make_float2(re, im);
}

}  // namespace

extern "C" int resample_arith_launch(const void* ext, int n_ext,
                                     const void* start, const void* omega,
                                     const void* bank, void* out, int out_cap,
                                     void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (out_cap + kThreads - 1) / kThreads;
  resample_arith_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), n_ext,
      static_cast<const float*>(start), static_cast<const float*>(omega),
      static_cast<const float*>(bank), static_cast<float2*>(out), out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resample_arith_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
