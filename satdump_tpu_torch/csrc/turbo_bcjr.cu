// Max-log BCJR of one terminated 16-state CCSDS turbo constituent code,
// batched over frames.
//
// Replaces the two lax.scan recursions of satdump_tpu/ops/fec/turbo.py::
// _bcjr_maxlog (turbo.py:205). The plain twin is ops/cuda/turbo_bcjr.py::
// turbo_bcjr_plain.
//
// What it computes, for each frame: Lch (S, C) channel LLRs, La (K) a-priori
// LLRs, S = K + 4 (La = 0 on the four tail steps).
//   g[t][s][b] = 0.5 * (sum over c, in c order, of +-Lch[t][c], + where the
//                component's output bit on branch (s, b) is 1)
//                + (0.5 * La[t]) * (b ? 1 : -1);
//   alpha_0 = beta_S = (0, -1e9, ..., -1e9);
//   alpha_{t+1}[s'] = max(-1e9, max over the two branches (s, b) into s' of
//                     alpha_t[s] + g[t][s][b]), minus its max over s';
//     (the reference takes the max of the two branches and of 30 masked
//     entries that hold -1e9, hence the floor)
//   beta_t[s] = max_b (g[t][s][b] + beta_{t+1}[ns(s, b)]), minus its max;
//   app[t] = max_s ((alpha_t[s] + g[t][s][1]) + beta_{t+1}[ns(s, 1)])
//            - max_s ((alpha_t[s] + g[t][s][0]) + beta_{t+1}[ns(s, 0)]),
//     for t < K.
//
// What bounds it on an H100: latency. Each step's 16 states wait for the
// step before: an add, two maxes, a four-level max tree over the states and
// a subtraction, times S steps (8,924 at base 1115), on one thread a frame.
// The frames (up to ~58 a batch) are the only parallelism; the bytes (the
// LLRs in, the APP out) are far below it. So:
//  * one CTA of 32 threads (one warp) per 32 frames and direction; lane i
//    walks frame i with its 16 state metrics in registers. blockIdx.y
//    picks the forward or the backward recursion, so the two run at once;
//  * the CTA stages the LLRs of 32 steps at a time in shared memory by
//    4-byte cp.async (zero-filled past K and S), double-buffered, one row a
//    frame padded to an odd stride so that the lanes' reads are free of
//    bank conflicts;
//  * each step writes its alpha_t (forward) or beta_{t+1} (backward) to a
//    workspace of 2 x S x 16 x B floats, frames innermost, so that the
//    warp's store of one state is one coalesced 128-byte line; a second
//    kernel forms the APP, one thread a (step, frame), frames innermost.
// The trellis is fixed at compile time (next state and output bits from the
// component polynomials), so the state metrics stay in registers; each rate's
// component list is a template instance.
//
// Exactness: every operation is an add, a max or an exact scaling by 0.5 or
// -1, each with __fadd_rn / __fmul_rn / __fsub_rn so that none is contracted
// into an FMA, in the plain version's order. So the kernel equals the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;
constexpr int kMemory = 4;
constexpr int kTile = 32;       // steps staged at a time
constexpr int kFrames = 32;     // frames a CTA: one warp, a frame a lane
constexpr float kNeg = -1e9f;

// forward polynomials of the components sys, p1, p2, p3 (turbo.py _FWD):
// bit i is fwd[i]
__host__ __device__ constexpr int fwd_poly(int comp) {
  return comp == 0 ? 0x19 : comp == 1 ? 0x1B : comp == 2 ? 0x15 : 0x1F;
}

// the register's feedback (backward taps 0, 0, 1, 1)
__host__ __device__ constexpr int feedback(int s) { return ((s >> 1) ^ s) & 1; }

__host__ __device__ constexpr int next_state(int s, int b) {
  return (s >> 1) | ((feedback(s) ^ b) << (kMemory - 1));
}

__host__ __device__ constexpr int out_bit(int comp, int s, int b) {
  const int f = fwd_poly(comp);
  int o = f & (next_state(s, b) >> (kMemory - 1)) & 1;
  for (int i = 0; i < kMemory; ++i)
    o ^= (f >> (i + 1)) & (s >> (kMemory - 1 - i)) & 1;
  return o;
}

// the output-bit pattern of branch (s, b) over the CODE's components (bit c
// for component c; CODE packs one component id in two bits, c-th lowest)
template <int C, int CODE>
__host__ __device__ constexpr int pattern(int s, int b) {
  int p = 0;
  for (int c = 0; c < C; ++c) p |= out_bit((CODE >> (2 * c)) & 3, s, b) << c;
  return p;
}

// the 32 branch metrics of one step
template <int C, int CODE>
struct Branch {
  float g[kStates][2];

  __device__ __forceinline__ void compute(const float (&L)[C], float la) {
    float half[1 << C];     // 0.5 * (sum over c of +-L[c]) per pattern
#pragma unroll
    for (int p = 0; p < (1 << C); ++p) {
      float acc = (p & 1) ? L[0] : -L[0];
#pragma unroll
      for (int c = 1; c < C; ++c)
        acc = __fadd_rn(acc, ((p >> c) & 1) ? L[c] : -L[c]);
      half[p] = __fmul_rn(0.5f, acc);
    }
    const float hla = __fmul_rn(0.5f, la);
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      g[s][0] = __fadd_rn(half[pattern<C, CODE>(s, 0)], -hla);
      g[s][1] = __fadd_rn(half[pattern<C, CODE>(s, 1)], hla);
    }
  }
};

__device__ __forceinline__ float max16(const float (&v)[kStates]) {
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = fmaxf(v[2 * i], v[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[2 * i], m[2 * i + 1]);
  return fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
}

// one forward step: alpha_t -> alpha_{t+1}
template <int C, int CODE>
__device__ __forceinline__ void forward_step(float (&a)[kStates],
                                             const Branch<C, CODE>& br) {
  float na[kStates];
#pragma unroll
  for (int sp = 0; sp < kStates; ++sp) {
    // the two branches into sp leave states 2 (sp & 7) and 2 (sp & 7) + 1
    const int s0 = 2 * (sp & 7), s1 = s0 + 1;
    const int b0 = (sp >> 3) ^ feedback(s0), b1 = (sp >> 3) ^ feedback(s1);
    const float m = fmaxf(__fadd_rn(a[s0], br.g[s0][b0]),
                          __fadd_rn(a[s1], br.g[s1][b1]));
    na[sp] = fmaxf(m, kNeg);
  }
  const float mx = max16(na);
#pragma unroll
  for (int s = 0; s < kStates; ++s) a[s] = __fsub_rn(na[s], mx);
}

// one backward step: beta_{t+1} -> beta_t
template <int C, int CODE>
__device__ __forceinline__ void backward_step(float (&be)[kStates],
                                              const Branch<C, CODE>& br) {
  float nb[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s)
    nb[s] = fmaxf(__fadd_rn(br.g[s][0], be[next_state(s, 0)]),
                  __fadd_rn(br.g[s][1], be[next_state(s, 1)]));
  const float mx = max16(nb);
#pragma unroll
  for (int s = 0; s < kStates; ++s) be[s] = __fsub_rn(nb[s], mx);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kTile steps of LLRs for the CTA's frames; rows padded to an odd stride
template <int C>
struct Stage {
  float L[2][kFrames][kTile * C + 1];
  float La[2][kFrames][kTile + 1];
};

// start the copy of steps [t0, t0 + kTile) into buffer `buf`
template <int C>
__device__ __forceinline__ void stage(Stage<C>& sm, int buf,
                                      const float* __restrict__ Lch,
                                      const float* __restrict__ La, int f0,
                                      int B, int S, int K, int t0) {
  constexpr int kRow = kTile * C;
  const int lane = threadIdx.x;
#pragma unroll 4
  for (int j = lane; j < kFrames * kRow; j += kFrames) {
    const int r = j / kRow, x = j - r * kRow;
    const int f = f0 + r;
    const long long idx = static_cast<long long>(t0) * C + x;
    const bool ok = f < B && idx < static_cast<long long>(S) * C;
    cp_async4(&sm.L[buf][r][x],
              ok ? Lch + static_cast<long long>(f) * S * C + idx : Lch,
              ok ? 4 : 0);
  }
#pragma unroll 4
  for (int j = lane; j < kFrames * kTile; j += kFrames) {
    const int r = j / kTile, x = j - r * kTile;
    const int f = f0 + r, t = t0 + x;
    const bool ok = f < B && t < K;
    cp_async4(&sm.La[buf][r][x],
              ok ? La + static_cast<long long>(f) * K + t : La, ok ? 4 : 0);
  }
  cp_async_commit();
}

template <int C, int CODE>
__device__ __forceinline__ Branch<C, CODE> staged_branch(const Stage<C>& sm,
                                                         int buf, int i) {
  const int lane = threadIdx.x;
  float L[C];
#pragma unroll
  for (int c = 0; c < C; ++c) L[c] = sm.L[buf][lane][i * C + c];
  Branch<C, CODE> br;
  br.compute(L, sm.La[buf][lane][i]);
  return br;
}

// the 16 state metrics of one step to p[s * B], s = 0..15
__device__ __forceinline__ void store16(float* p, int B,
                                        const float (&v)[kStates]) {
#pragma unroll
  for (int s = 0; s < kStates; ++s) p[static_cast<long long>(s) * B] = v[s];
}

// the forward and the backward recursion: blockIdx.y 0 writes alpha_t to
// ws[0][t][s][f], 1 writes beta_{t+1} to ws[1][t][s][f]
template <int C, int CODE>
__global__ void __launch_bounds__(kFrames)
bcjr_walk_kernel(const float* __restrict__ Lch, const float* __restrict__ La,
                 float* __restrict__ ws, int B, int S, int K) {
  __shared__ Stage<C> sm;
  const int f0 = blockIdx.x * kFrames;
  const int f = f0 + threadIdx.x;
  const bool live = f < B;
  const int ntiles = (S + kTile - 1) / kTile;
  float v[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) v[s] = s == 0 ? 0.f : kNeg;
  const long long step = static_cast<long long>(kStates) * B;
  if (blockIdx.y == 0) {
    float* out = ws + f;
    stage<C>(sm, 0, Lch, La, f0, B, S, K, 0);
    for (int k = 0; k < ntiles; ++k) {
      if (k + 1 < ntiles) {
        stage<C>(sm, (k + 1) & 1, Lch, La, f0, B, S, K, (k + 1) * kTile);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = k * kTile, n = min(kTile, S - t0);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        if (live) store16(out + (t0 + i) * step, B, v);
        forward_step<C, CODE>(v, staged_branch<C, CODE>(sm, k & 1, i));
      }
      __syncthreads();
    }
  } else {
    float* out = ws + S * step + f;
    stage<C>(sm, (ntiles - 1) & 1, Lch, La, f0, B, S, K,
             (ntiles - 1) * kTile);
    for (int k = ntiles - 1; k >= 0; --k) {
      if (k > 0) {
        stage<C>(sm, (k - 1) & 1, Lch, La, f0, B, S, K, (k - 1) * kTile);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = k * kTile, n = min(kTile, S - t0);
#pragma unroll 1
      for (int i = n - 1; i >= 0; --i) {
        if (live) store16(out + (t0 + i) * step, B, v);
        backward_step<C, CODE>(v, staged_branch<C, CODE>(sm, k & 1, i));
      }
      __syncthreads();
    }
  }
}

// app[f][t] for t < K, one thread a (step, frame), frames innermost
template <int C, int CODE>
__global__ void __launch_bounds__(256)
bcjr_app_kernel(const float* __restrict__ Lch, const float* __restrict__ La,
                const float* __restrict__ ws, float* __restrict__ app, int B,
                int S, int K) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= static_cast<long long>(B) * K) return;
  const int t = static_cast<int>(i / B), f = static_cast<int>(i - 1LL * t * B);
  const long long step = static_cast<long long>(kStates) * B;
  const float* pa = ws + t * step + f;
  const float* pb = ws + (S + t) * step + f;
  float a[kStates], be[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a[s] = pa[static_cast<long long>(s) * B];
    be[s] = pb[static_cast<long long>(s) * B];
  }
  const long long row = static_cast<long long>(f) * S + t;
  float L[C];
#pragma unroll
  for (int c = 0; c < C; ++c) L[c] = Lch[row * C + c];
  Branch<C, CODE> br;
  br.compute(L, La[static_cast<long long>(f) * K + t]);
  float m0 = __int_as_float(0xff800000), m1 = m0;      // -inf
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    m0 = fmaxf(m0, __fadd_rn(__fadd_rn(a[s], br.g[s][0]),
                             be[next_state(s, 0)]));
    m1 = fmaxf(m1, __fadd_rn(__fadd_rn(a[s], br.g[s][1]),
                             be[next_state(s, 1)]));
  }
  app[static_cast<long long>(f) * K + t] = __fsub_rn(m1, m0);
}

template <int C, int CODE>
int launch(const void* Lch, const void* La, void* app, void* ws, int B, int S,
           cudaStream_t st) {
  const int K = S - kMemory;
  const float* l = static_cast<const float*>(Lch);
  const float* la = static_cast<const float*>(La);
  float* w = static_cast<float*>(ws);
  bcjr_walk_kernel<C, CODE>
      <<<dim3((B + kFrames - 1) / kFrames, 2), kFrames, 0, st>>>(l, la, w, B,
                                                                  S, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * K;
  bcjr_app_kernel<C, CODE><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(l, la, w, static_cast<float*>(app), B, S,
                                   K);
  return static_cast<int>(cudaGetLastError());
}

// component ids: sys 0, p1 1, p2 2, p3 3; code = sum id_c << 2c
constexpr int code_of(int c0, int c1 = 0, int c2 = 0, int c3 = 0) {
  return c0 | (c1 << 2) | (c2 << 4) | (c3 << 6);
}

}  // namespace

// Lch (B, S, C) and La (B, S - 4) float32, app (B, S - 4) float32, ws
// 2 * S * 16 * B float32, all contiguous on the current device. `code`
// names the components (the five lists of the CCSDS rates).
extern "C" int turbo_bcjr_launch(const void* Lch, const void* La, void* app,
                                 void* ws, int B, int S, int C, int code,
                                 void* stream) {
  if (B < 1 || S <= kMemory) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kSysP1 = code_of(0, 1), kSysP2P3 = code_of(0, 2, 3);
  constexpr int kSysP1P2P3 = code_of(0, 1, 2, 3), kP1 = code_of(1);
  constexpr int kP1P3 = code_of(1, 3);
  if (C == 2 && code == kSysP1)
    return launch<2, kSysP1>(Lch, La, app, ws, B, S, st);
  if (C == 3 && code == kSysP2P3)
    return launch<3, kSysP2P3>(Lch, La, app, ws, B, S, st);
  if (C == 4 && code == kSysP1P2P3)
    return launch<4, kSysP1P2P3>(Lch, La, app, ws, B, S, st);
  if (C == 1 && code == kP1) return launch<1, kP1>(Lch, La, app, ws, B, S, st);
  if (C == 2 && code == kP1P3)
    return launch<2, kP1P3>(Lch, La, app, ws, B, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* turbo_bcjr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
