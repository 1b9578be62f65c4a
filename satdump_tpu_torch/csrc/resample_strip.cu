// K4: the strip symbol pick, polyphase interpolation on an arithmetic
// symbol grid where the samples per symbol lie near an integer s0.
//
// Replaces no Pallas kernel. The JAX package's satdump_tpu/ops/ffsync.py::
// resample_strip is plain jnp that XLA fuses on the TPU into one pass; on
// the card its formulation (a Horner loop of 10 steps, then 32 strips of 8
// compare-selects and adds) dispatches ~950 small kernels a psk_demod
// block. Its plain twin is satdump_tpu_torch/ops/ffsync.py::resample_strip,
// which this kernel equals bit for bit (the wrapper is
// ops/cuda/resample_strip.py).
//
// What it computes, for k < out_cap, with G, D, s0 from
// ops/ffsync.py::_strip_geometry and extp = FRONT zeros, ext, then zeros:
//   j = k / G, g = k - j*G;
//   c_s = clamp(floor(start + (j*G)*omega) + FRONT, 0, n_extp - Lw);
//   p = (start + k*omega) + NTAPS/2, ip = floor(p), frac = p - ip;
//   d = clamp(ip + FRONT - c_s - s0*g, 0, D - 1);
//   tap[t] = Horner over the (11, NTAPS) polynomial table at frac;
//   y = sum_t tap[t] * extp[c_s + s0*g + d + t], t increasing;
//   valid = (p - NTAPS/2 >= -NTAPS/2) & (ip < n_in)
//           & (p - NTAPS/2 < n_in - NTAPS/2);
//   out[k] = valid ? y : 0.
//
// Exactness: every product and sum is its own correctly rounded operation
// (__fmul_rn / __fadd_rn, which nvcc never contracts into an FMA), in the
// plain version's order: its Horner steps are a multiply then an add, and
// its strips add the 8 nonzero terms in increasing t. The strips' other
// terms add +-0, which changes no sum of finite samples, so they are left
// out.
//
// What bounds it on an H100: bytes. At FY-3D's 2^18-sample block (out_cap
// 88,266) it reads ext (2.1 MB) and writes the symbols and flags (0.8 MB):
// ~2.9 MB at 3.35 TB/s is 0.87 us, below what launching the grid costs.
// So: one symbol a thread, 256 threads a CTA, the polynomial table staged
// once a CTA into shared memory (88 floats, read as broadcasts); each
// thread reads its 8 samples through the read-only path, and a warp's 32
// overlapping windows (~100 samples) come from L1. start and omega are read
// through device pointers, so the host never synchronizes to fetch them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNTaps = 8;
constexpr int kNCoef = 11;       // degree-10 polynomials, highest power first
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) resample_strip_kernel(
    const float2* __restrict__ ext, int n_ext,
    const float* __restrict__ start_p, const float* __restrict__ omega_p,
    const float* __restrict__ coefs, float2* __restrict__ out,
    uint8_t* __restrict__ valid_out, int out_cap, int n_in,
    long long n_extp, int front, int G, int D, int s0) {
  __shared__ float co[kNCoef * kNTaps];
  if (threadIdx.x < kNCoef * kNTaps) co[threadIdx.x] = __ldg(coefs + threadIdx.x);
  __syncthreads();
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= out_cap) return;

  const float start = __ldg(start_p);
  const float omega = __ldg(omega_p);
  const float half = 0.5f * kNTaps;
  const int j = k / G;
  const int g = k - j * G;
  const long long lw = static_cast<long long>(s0) * G + D + kNTaps + 8;

  // the segment's window start, as the plain version forms it
  const float pj = __fadd_rn(start,
                             __fmul_rn(static_cast<float>(j * G), omega));
  long long cs = static_cast<long long>(floorf(pj)) + front;
  cs = min(max(cs, 0LL), n_extp - lw);

  const float p = __fadd_rn(
      __fadd_rn(start, __fmul_rn(static_cast<float>(k), omega)), half);
  const float ip = floorf(p);
  const float frac = __fsub_rn(p, ip);
  const long long src = static_cast<long long>(ip);
  long long d = src + front - cs - static_cast<long long>(s0) * g;
  d = min(max(d, 0LL), static_cast<long long>(D - 1));

  float tap[kNTaps];
#pragma unroll
  for (int t = 0; t < kNTaps; ++t) tap[t] = co[t];
#pragma unroll
  for (int r = 1; r < kNCoef; ++r) {
#pragma unroll
    for (int t = 0; t < kNTaps; ++t)
      tap[t] = __fadd_rn(__fmul_rn(tap[t], frac), co[r * kNTaps + t]);
  }

  // extp index cs + s0*g + d + t is ext index e0 + t; outside ext, zeros
  const long long e0 = cs + static_cast<long long>(s0) * g + d - front;
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int t = 0; t < kNTaps; ++t) {
    const long long e = e0 + t;
    const float2 v = (e >= 0 && e < n_ext) ? __ldg(ext + e)
                                           : make_float2(0.f, 0.f);
    if (t == 0) {
      re = __fmul_rn(v.x, tap[0]);
      im = __fmul_rn(v.y, tap[0]);
    } else {
      re = __fadd_rn(re, __fmul_rn(v.x, tap[t]));
      im = __fadd_rn(im, __fmul_rn(v.y, tap[t]));
    }
  }

  const float pos = __fsub_rn(p, half);
  const bool valid = pos >= -half && src < n_in &&
                     pos < static_cast<float>(n_in - kNTaps / 2);
  out[k] = valid ? make_float2(re, im) : make_float2(0.f, 0.f);
  valid_out[k] = valid ? 1 : 0;
}

}  // namespace

extern "C" int resample_strip_launch(const void* ext, int n_ext,
                                     const void* start, const void* omega,
                                     const void* coefs, void* out,
                                     void* valid, int out_cap, int n_in,
                                     long long n_extp, int front, int G,
                                     int D, int s0, void* stream) {
  resample_strip_kernel<<<(out_cap + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), n_ext,
      static_cast<const float*>(start), static_cast<const float*>(omega),
      static_cast<const float*>(coefs), static_cast<float2*>(out),
      static_cast<uint8_t*>(valid), out_cap, n_in, n_extp, front, G, D, s0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resample_strip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
