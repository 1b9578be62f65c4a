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
// What bounds it on an H100: bytes. At the main path's 2^18-sample block
// (out_cap 102,977) it reads ext (2.1 MB) and writes the symbols (0.8 MB):
// ~2.9 MB at 3.35 TB/s is 0.87 us, below the 0.93 us an empty kernel takes
// on this grid. What the card spends beyond that goes to a chain each
// thread waits through (the loads of start and omega, then the taps, then
// the store) and to the L1 wavefronts of the taps' gathers: a warp's 32
// symbols read overlapping 8-sample windows, ~90 samples in all. So:
//  * One symbol a thread, 256 threads a CTA, no shared memory and no
//    barrier: each warp goes from its positions to its loads to its store
//    on its own, 24 warps an SM hiding each other's waits. (Staging each
//    tile's window into shared memory by cp.async, with 128-512 threads a
//    CTA and 1-4 symbols a thread, measured 0.3-0.7 us slower: L1 already
//    serves the overlapping windows, and the copy adds a barrier.)
//  * The 8 samples are read as five 16-byte loads from the 16-byte-aligned
//    pair at or before src, then shifted by a select: a warp touches about
//    30 L1 wavefronts for them instead of 48. A thread whose ten samples
//    would leave ext reads its eight one by one.
//  * The taps (one 32-byte bank row) come through the read-only path as two
//    16-byte loads; a warp's symbols use only a handful of rows.
//  * start and omega are read through device pointers, so the host never
//    synchronizes to fetch them.
//
// Exactness: the position is formed with __fmul_rn / __fadd_rn in the
// reference's order, so nvcc cannot contract it into an FMA; rintf rounds
// half to even like torch.round, floorf floors. Branch picks therefore equal
// the plain version's; only the order of the 8-term sum differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFilt = 128;
constexpr int kNTaps = 8;
constexpr int kThreads = 256;

// bank: 16-byte aligned (the wrapper checks)
__global__ void __launch_bounds__(kThreads) resample_arith_kernel(
    const float2* __restrict__ ext, int n_ext,
    const float* __restrict__ start_p, const float* __restrict__ omega_p,
    const float* __restrict__ bank, float2* __restrict__ out, int out_cap) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= out_cap) return;

  const float start = __ldg(start_p);
  const float omega = __ldg(omega_p);
  const float pos = __fadd_rn(start, __fmul_rn(static_cast<float>(k), omega));
  const float p = __fadd_rn(pos, 0.5f * kNTaps);
  const float ip = floorf(p);
  const int src = min(max(static_cast<int>(ip), 0), n_ext - kNTaps);
  int branch = static_cast<int>(
      rintf(__fmul_rn(__fsub_rn(p, ip), static_cast<float>(kNFilt))));
  branch = min(max(branch, 0), kNFilt - 1);

  const float4* row = reinterpret_cast<const float4*>(bank) + 2 * branch;
  const float4 ta = __ldg(row);
  const float4 tb = __ldg(row + 1);
  const float tap[kNTaps] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};

  // ext + e is 16-byte aligned: e is src, or src - 1 where src is odd in
  // ext's pair layout (ext itself is 8-byte aligned)
  const int a0 = static_cast<int>((reinterpret_cast<uintptr_t>(ext) >> 3) & 1);
  const int e = src - ((src + a0) & 1);
  float2 v[kNTaps];
  if (e >= 0 && e + 10 <= n_ext) {
    const float4* q4 = reinterpret_cast<const float4*>(ext + e);
    float2 w[10];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float4 q = __ldg(q4 + i);
      w[2 * i] = make_float2(q.x, q.y);
      w[2 * i + 1] = make_float2(q.z, q.w);
    }
    const bool shifted = e != src;
#pragma unroll
    for (int j = 0; j < kNTaps; ++j) v[j] = shifted ? w[j + 1] : w[j];
  } else {
#pragma unroll
    for (int j = 0; j < kNTaps; ++j) v[j] = __ldg(ext + src + j);
  }

  float re = 0.f, im = 0.f;
#pragma unroll
  for (int j = 0; j < kNTaps; ++j) {
    re = fmaf(v[j].x, tap[j], re);
    im = fmaf(v[j].y, tap[j], im);
  }
  out[k] = make_float2(re, im);
}

}  // namespace

extern "C" int resample_arith_launch(const void* ext, int n_ext,
                                     const void* start, const void* omega,
                                     const void* bank, void* out, int out_cap,
                                     void* stream) {
  resample_arith_kernel<<<(out_cap + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), n_ext,
      static_cast<const float*>(start), static_cast<const float*>(omega),
      static_cast<const float*>(bank), static_cast<float2*>(out), out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resample_arith_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
