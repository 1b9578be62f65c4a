// Mueller & Mueller symbol-timing recovery over one block, walked by one
// thread: complex (psk_demod, pm_demod) and real (fsk_demod, sdpsk_demod)
// timing-error detectors.
//
// Replaces the lax.scan satdump_tpu/ops/clock_recovery.py::
// mm_clock_recovery (the scan at :132). The plain twin is
// ops/cuda/mm_clock.py::mm_walk_plain.
//
// What it computes: ext is the block behind ntaps - 1 samples of history
// (n + 7 samples). For each output slot k < out_cap, while inc < n:
//   imu = clip(rint(mu * 128), 0, 127); start = clip(inc, 0, n - 1);
//   sample = sum_j ext[start + j] * bank[imu, j]   (j = 0..7, in order);
//   complex TED: c0 = (re > 0) + j (im > 0) (values 0 / 1, as the reference
//     forms them); e = Re[(p0 - p_2T) conj(c_1T) - (c0 - c_2T) conj(p_1T)];
//   real TED: e = sign(last) re - sign(re) last;
//   e = clip(e, +-1); omega = omega_mid + clip(omega + g_omega e - omega_mid,
//   +-omega_limit); mu += omega + g_mu e; inc += floor(mu); mu -= floor(mu);
//   syms[k] = sample, valid[k] = 1.
// Once inc >= n every later slot is invalid and leaves the state as it is,
// so the walk stops there; the rest of syms is 0 and of valid 0. The state
// out carries max(inc - n, 0) into the next block.
//
// What bounds it on an H100: latency. Each symbol's window and branch come
// from the inc and mu that the previous symbol left: shared-memory loads,
// eight ordered adds, the detector and the loop update are one chain, on
// one thread (tools/sass_chain.py reads that chain off this kernel's
// SASS); the bytes (8 a sample in, 9 a symbol out) are far below it. So:
//  * one CTA of 128 threads; lane 0 of warp 0 walks, its state in
//    registers, and writes each symbol straight to device memory (stores do
//    not stall it);
//  * the whole CTA stages the interpolator bank (4 KB) and a tile of
//    kTile + 7 samples of ext in shared memory; when the window leaves the
//    tile, the CTA loads the next one from the window's start;
//  * the state lives in a small device tensor, read at the start and
//    written at the end: no host sync between blocks.
//
// Exactness: float32 with __fadd_rn / __fmul_rn (no FMA), rintf rounds half
// to even as jnp.round, floorf floors; the 8-term sums go in order, as XLA's
// CPU reduce sums them, the real part with each product rounded and the
// imaginary part with each product fused into its add (formed in float64,
// as XLA's fusion gives it). The plain version does the same operations, so
// the card and the CPU give the same symbols bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNFilt = 128;
constexpr int kNTaps = 8;
constexpr int kTile = 4096;   // window starts a tile; 32 KB with the overlap

// the state vector, float32[16] (inc as int32 bits)
enum Slot { kMu = 0, kOmega, kInc, kLast, kP = 4, kC = 10, kSlots = 16 };

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = lo > v ? lo : v;
  return hi < v ? hi : v;
}

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// the walker's state, in registers
struct Walker {
  float mu, omega, last;
  int inc;
  float pr[3][2], cr[3][2];   // p_regs, c_regs: [0] newest

  __device__ void load(const float* st) {
    mu = st[kMu];
    omega = st[kOmega];
    last = st[kLast];
    inc = __float_as_int(st[kInc]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      pr[r][0] = st[kP + 2 * r];
      pr[r][1] = st[kP + 2 * r + 1];
      cr[r][0] = st[kC + 2 * r];
      cr[r][1] = st[kC + 2 * r + 1];
    }
  }

  __device__ void store(float* st, int inc_out) const {
    st[kMu] = mu;
    st[kOmega] = omega;
    st[kInc] = __int_as_float(inc_out);
    st[kLast] = last;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      st[kP + 2 * r] = pr[r][0];
      st[kP + 2 * r + 1] = pr[r][1];
      st[kC + 2 * r] = cr[r][0];
      st[kC + 2 * r + 1] = cr[r][1];
    }
  }
};

struct Params {
  float omega_mid, gain_omega, gain_mu, omega_limit;
};

// one output slot: the sample at the window w (ext[start ..], in shared
// memory) through the branch that mu picks from the bank's taps (in shared
// memory), the detector (complex or real) and the loop update; returns the
// sample
template <bool Complex>
__device__ __forceinline__ float2 mm_step(Walker& s, const float2* w,
                                          const float* taps, const Params& p) {
  const int imu = min(max(__float2int_rn(__fmul_rn(s.mu, float(kNFilt))), 0),
                      kNFilt - 1);
  const float* t = taps + imu * kNTaps;
  float sr = 0.f, si = 0.f;
#pragma unroll
  for (int j = 0; j < kNTaps; ++j) {
    sr = __fadd_rn(sr, __fmul_rn(w[j].x, t[j]));
    // XLA fuses each imaginary product into its add: the product is exact
    // in float64, the sum rounds there, then once to float32
    si = __double2float_rn(__dadd_rn(
        static_cast<double>(si),
        __dmul_rn(static_cast<double>(w[j].y), static_cast<double>(t[j]))));
  }
  float e;
  if (Complex) {
    const float c0r = sr > 0.f ? 1.f : 0.f;
    const float c0i = si > 0.f ? 1.f : 0.f;
    // Re[(p0 - p_regs[1]) conj(c_regs[0])]: the c are 0 or 1, so each
    // product is exact and each sum rounds once
    const float first =
        __fadd_rn(__fmul_rn(__fsub_rn(sr, s.pr[1][0]), s.cr[0][0]),
                  __fmul_rn(__fsub_rn(si, s.pr[1][1]), s.cr[0][1]));
    const float second =
        __fadd_rn(__fmul_rn(__fsub_rn(c0r, s.cr[1][0]), s.pr[0][0]),
                  __fmul_rn(__fsub_rn(c0i, s.cr[1][1]), s.pr[0][1]));
    e = __fsub_rn(first, second);
#pragma unroll
    for (int r = 2; r > 0; --r) {
      s.pr[r][0] = s.pr[r - 1][0];
      s.pr[r][1] = s.pr[r - 1][1];
      s.cr[r][0] = s.cr[r - 1][0];
      s.cr[r][1] = s.cr[r - 1][1];
    }
    s.pr[0][0] = sr;
    s.pr[0][1] = si;
    s.cr[0][0] = c0r;
    s.cr[0][1] = c0i;
  } else {
    e = __fsub_rn(__fmul_rn(sgn(s.last), sr), __fmul_rn(sgn(sr), s.last));
    s.last = sr;
  }
  e = clip(e, -1.f, 1.f);
  float om = __fadd_rn(s.omega, __fmul_rn(p.gain_omega, e));
  om = __fadd_rn(p.omega_mid, clip(__fsub_rn(om, p.omega_mid), -p.omega_limit,
                                   p.omega_limit));
  const float mun = __fadd_rn(__fadd_rn(s.mu, om), __fmul_rn(p.gain_mu, e));
  const float fl = floorf(mun);
  s.inc = max(s.inc + static_cast<int>(fl), 0);
  s.mu = __fsub_rn(mun, fl);
  s.omega = om;
  return make_float2(sr, si);
}

// one kernel a detector, so the walk loop holds one of them
template <bool Complex>
__global__ void __launch_bounds__(kThreads) mm_clock_kernel(
    const float2* __restrict__ ext, int n, const float* __restrict__ bank,
    const float* __restrict__ st_in, float* __restrict__ st_out,
    float2* __restrict__ syms, uint8_t* __restrict__ valid, int out_cap,
    Params p) {
  __shared__ float2 win[kTile + kNTaps - 1];
  __shared__ float taps[kNFilt * kNTaps];
  __shared__ int s_base, s_k, s_done;
  const int tid = threadIdx.x;
  for (int i = tid; i < kNFilt * kNTaps; i += kThreads) taps[i] = bank[i];
  Walker s;   // read by every thread, walked by thread 0
  s.load(st_in);
  int k = 0;
  if (tid == 0) s_base = min(max(s.inc, 0), n - 1);
  __syncthreads();

  for (;;) {
    const int base = s_base;
    const int m = min(kTile + kNTaps - 1, n + kNTaps - 1 - base);
    for (int i = tid; i < m; i += kThreads) win[i] = ext[base + i];
    __syncthreads();
    if (tid == 0) {
      int done = 0;
      for (;;) {
        if (k >= out_cap || s.inc >= n) {
          done = 1;
          break;
        }
        const int start = min(max(s.inc, 0), n - 1);
        if (start < base || start >= base + kTile) break;   // next tile
        syms[k] = mm_step<Complex>(s, win + (start - base), taps, p);
        valid[k] = 1;
        ++k;
      }
      s_done = done;
      s_k = k;
      s_base = min(max(s.inc, 0), n - 1);
    }
    __syncthreads();
    if (s_done) break;
  }

  for (int i = s_k + tid; i < out_cap; i += kThreads) {
    syms[i] = make_float2(0.f, 0.f);
    valid[i] = 0;
  }
  if (tid == 0) s.store(st_out, max(s.inc - n, 0));
}

}  // namespace

// ext: n + 7 complex64; bank: (128, 8) float32; state: float32[16] in and
// out; syms: out_cap complex64; valid: out_cap bytes. n >= 1, out_cap >= 1.
extern "C" int mm_clock_launch(const void* ext, int n, const void* bank,
                               const void* st_in, void* st_out, void* syms,
                               void* valid, int out_cap, float omega_mid,
                               float gain_omega, float gain_mu,
                               float omega_limit, int complex_mode,
                               void* stream) {
  auto* kernel = complex_mode ? mm_clock_kernel<true>
                              : mm_clock_kernel<false>;
  kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), n, static_cast<const float*>(bank),
      static_cast<const float*>(st_in), static_cast<float*>(st_out),
      static_cast<float2*>(syms), static_cast<uint8_t*>(valid), out_cap,
      Params{omega_mid, gain_omega, gain_mu, omega_limit});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mm_clock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
