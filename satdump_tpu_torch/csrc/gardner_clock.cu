// Gardner symbol-timing recovery over one block, walked by one thread.
//
// Replaces the lax.scan satdump_tpu/ops/clock_recovery.py::
// gardner_clock_recovery (the scan at :225). The plain twin is
// ops/cuda/gardner.py::gardner_walk_plain.
//
// What it computes: ext is the block behind ntaps - 1 samples of history
// (n + 7 samples). For each output slot k < out_cap, while inc < n:
//   offzc = floor(omega / 2); mupos = mod(mu - omega / 2 + offzc, 1)
//     (jnp.mod: the remainder, plus 1 where it is negative);
//   imuz = clip(rint(mupos * 128), 0, 127); imu = clip(rint(mu * 128), ..);
//   zc = sum_j ext[clip(inc - offzc, 0, n - 1) + j] * bank[imuz, j];
//   sample = sum_j ext[clip(inc, 0, n - 1) + j] * bank[imu, j] (in order);
//   e = clip(Re zc (Re last - Re sample) + Im zc (Im last - Im sample), +-1);
//   omega = omega_mid + clip(omega + g_omega e - omega_mid, +-omega_limit);
//   mu += omega + g_mu e; inc = max(inc + floor(mu), 0); mu -= floor(mu);
//   last = sample; syms[k] = sample, valid[k] = 1.
// Once inc >= n every later slot is invalid and leaves the state as it is,
// so the walk stops there; the rest of syms is 0 and of valid 0. The state
// out carries max(inc - n, 0) into the next block.
//
// What bounds it on an H100: latency. Each symbol's two windows and
// branches come from the inc, mu and omega that the previous symbol left:
// shared-memory loads, two sets of eight ordered adds, the detector and the
// loop update are one chain, on one thread (tools/sass_chain.py reads that
// chain off this kernel's SASS); the bytes (8 a sample in, 9 a symbol out)
// are far below it. So, as the M&M walker (mm_clock.cu):
//  * one CTA of 128 threads; lane 0 of warp 0 walks, its state in
//    registers, and writes each symbol straight to device memory;
//  * the whole CTA stages the interpolator bank (4 KB) and two tiles of
//    kTile + 7 samples of ext in shared memory, one for each window: the
//    zero-crossing window starts up to omega / 2 samples before the on-time
//    one, so each window has its own tile and the two are reloaded (from
//    each window's start) as soon as either window leaves its tile;
//  * the state lives in a small device tensor, read at the start and
//    written at the end: no host sync between blocks.
//
// Exactness: float32 with __fadd_rn / __fmul_rn (no FMA), rintf rounds half
// to even as jnp.round, floorf floors, and the remainder is a - truncf(a)
// (exact) rather than fmodf. The 8-term sums go in order, as XLA's CPU
// reduce sums them, the real part with each product rounded and the
// imaginary part with each product fused into its add. XLA's fusion also
// contracts three of the loop's products into their adds: the detector's
// real term into the imaginary one, g_omega e into omega and g_mu e into
// mu + omega. Each fused product-add is formed in float64 (the product of
// two floats is exact there) and rounded once to float32, as the plain
// version does, so the card and the CPU give the same symbols bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNFilt = 128;
constexpr int kNTaps = 8;
constexpr int kTile = 2048;   // window starts a tile; 2 x 16 KB with overlaps

// the state vector, float32[8] (inc as int32 bits)
enum Slot { kMu = 0, kOmega = 1, kInc = 2, kLast = 4, kSlots = 8 };

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = lo > v ? lo : v;
  return hi < v ? hi : v;
}

// a * b + c with one rounding to float32, formed in float64
__device__ __forceinline__ float fused(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// the walker's state, in registers
struct Walker {
  float mu, omega, lr, li;
  int inc;

  __device__ void load(const float* st) {
    mu = st[kMu];
    omega = st[kOmega];
    inc = __float_as_int(st[kInc]);
    lr = st[kLast];
    li = st[kLast + 1];
  }

  __device__ void store(float* st, int inc_out) const {
    st[kMu] = mu;
    st[kOmega] = omega;
    st[kInc] = __int_as_float(inc_out);
    st[3] = 0.f;
    st[kLast] = lr;
    st[kLast + 1] = li;
    st[6] = 0.f;
    st[7] = 0.f;
  }
};

struct Params {
  float omega_mid, gain_omega, gain_mu, omega_limit;
};

__device__ __forceinline__ int branch(float mu) {
  return min(max(__float2int_rn(__fmul_rn(mu, float(kNFilt))), 0),
             kNFilt - 1);
}

// the window w (in shared memory) through the bank's branch t (in shared
// memory): the real part's products rounded, the imaginary part's fused
__device__ __forceinline__ float2 interp(const float2* w, const float* t) {
  float sr = 0.f, si = 0.f;
#pragma unroll
  for (int j = 0; j < kNTaps; ++j) {
    sr = __fadd_rn(sr, __fmul_rn(w[j].x, t[j]));
    si = __double2float_rn(__dadd_rn(
        static_cast<double>(si),
        __dmul_rn(static_cast<double>(w[j].y), static_cast<double>(t[j]))));
  }
  return make_float2(sr, si);
}

// the zero-crossing window's offset behind inc: floor(omega / 2)
__device__ __forceinline__ int zc_offset(const Walker& s) {
  return static_cast<int>(floorf(__fmul_rn(s.omega, 0.5f)));
}

// one output slot, its windows at wz (zero crossing) and wo (on time);
// returns the on-time sample
__device__ __forceinline__ float2 gardner_step(Walker& s, const float2* wz,
                                               const float2* wo,
                                               const float* taps, int offzc,
                                               const Params& p) {
  const float muz = __fsub_rn(s.mu, __fmul_rn(s.omega, 0.5f));
  const float a = __fadd_rn(muz, static_cast<float>(offzc));
  float mupos = __fsub_rn(a, truncf(a));          // fmod(a, 1), exact
  if (mupos < 0.f) mupos = __fadd_rn(mupos, 1.f);  // may round to 1
  const float2 zc = interp(wz, taps + branch(mupos) * kNTaps);
  const float2 x = interp(wo, taps + branch(s.mu) * kNTaps);
  float e = fused(zc.x, __fsub_rn(s.lr, x.x),
                  __fmul_rn(zc.y, __fsub_rn(s.li, x.y)));
  e = clip(e, -1.f, 1.f);
  float om = fused(p.gain_omega, e, s.omega);
  om = __fadd_rn(p.omega_mid, clip(__fsub_rn(om, p.omega_mid), -p.omega_limit,
                                   p.omega_limit));
  const float mun = fused(p.gain_mu, e, __fadd_rn(s.mu, om));
  const float fl = floorf(mun);
  s.inc = max(s.inc + static_cast<int>(fl), 0);
  s.mu = __fsub_rn(mun, fl);
  s.omega = om;
  s.lr = x.x;
  s.li = x.y;
  return x;
}

__global__ void __launch_bounds__(kThreads) gardner_clock_kernel(
    const float2* __restrict__ ext, int n, const float* __restrict__ bank,
    const float* __restrict__ st_in, float* __restrict__ st_out,
    float2* __restrict__ syms, uint8_t* __restrict__ valid, int out_cap,
    Params p) {
  __shared__ float2 win_z[kTile + kNTaps - 1];
  __shared__ float2 win_o[kTile + kNTaps - 1];
  __shared__ float taps[kNFilt * kNTaps];
  __shared__ int s_zb, s_ob, s_k, s_done;
  const int tid = threadIdx.x;
  for (int i = tid; i < kNFilt * kNTaps; i += kThreads) taps[i] = bank[i];
  Walker s;   // read by every thread, walked by thread 0
  s.load(st_in);
  int k = 0;
  if (tid == 0) {
    s_zb = min(max(s.inc - zc_offset(s), 0), n - 1);
    s_ob = min(max(s.inc, 0), n - 1);
  }
  __syncthreads();

  for (;;) {
    const int zb = s_zb, ob = s_ob;
    const int mz = min(kTile + kNTaps - 1, n + kNTaps - 1 - zb);
    const int mo = min(kTile + kNTaps - 1, n + kNTaps - 1 - ob);
    for (int i = tid; i < mz; i += kThreads) win_z[i] = ext[zb + i];
    for (int i = tid; i < mo; i += kThreads) win_o[i] = ext[ob + i];
    __syncthreads();
    if (tid == 0) {
      int done = 0, zs, os;
      for (;;) {
        const int offzc = zc_offset(s);
        zs = min(max(s.inc - offzc, 0), n - 1);
        os = min(max(s.inc, 0), n - 1);
        if (k >= out_cap || s.inc >= n) {
          done = 1;
          break;
        }
        if (zs < zb || zs >= zb + kTile || os < ob || os >= ob + kTile)
          break;   // next tiles
        syms[k] = gardner_step(s, win_z + (zs - zb), win_o + (os - ob), taps,
                               offzc, p);
        valid[k] = 1;
        ++k;
      }
      s_done = done;
      s_k = k;
      s_zb = zs;
      s_ob = os;
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

// ext: n + 7 complex64; bank: (128, 8) float32; state: float32[8] in and
// out; syms: out_cap complex64; valid: out_cap bytes. n >= 1, out_cap >= 1.
extern "C" int gardner_clock_launch(const void* ext, int n, const void* bank,
                                    const void* st_in, void* st_out,
                                    void* syms, void* valid, int out_cap,
                                    float omega_mid, float gain_omega,
                                    float gain_mu, float omega_limit,
                                    void* stream) {
  gardner_clock_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), n, static_cast<const float*>(bank),
      static_cast<const float*>(st_in), static_cast<float*>(st_out),
      static_cast<float2*>(syms), static_cast<uint8_t*>(valid), out_cap,
      Params{omega_mid, gain_omega, gain_mu, omega_limit});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gardner_clock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
