// K1: lane-parallel register-exchange Viterbi, k=7 r=1/2 (polys 79/109).
//
// Replaces the TPU kernel satdump_tpu/ops/pallas/viterbi.py::viterbi_re_pallas
// (and, on the CPU, its plain twin ops/fec/convolutional.py::
// viterbi_decode_tiled_re). Output is bit-identical to the plain version.
//
// What it computes: the soft pairs (T, 2) f32 in [0, 255] (128 = erasure) are
// cut into L = T / seg lanes. Lane l scans the window that starts `ovl`
// pairs before l*seg, reading 128 outside [0, T), and carries for each of
// the 64 states an f32 path metric (never renormalized) and a 64-bit
// survivor register. The bit at delay 63 is read from state 0's register
// for the window steps ovl+63 .. ovl+63+seg-1 and written to out[l*seg ..].
//
// Design: one warp per lane. Thread t holds the new states 2t and 2t+1; both
// read the old states t and t+32, which sit in threads t>>1 and 16+(t>>1),
// so the butterfly is four __shfl_sync per step for the metrics and four for
// the 64-bit survivors (each two 32-bit shuffles). Survivors are native
// uint64 registers (the TPU kernel splits them into hi/lo uint32). Steps
// after the last emitted bit change nothing that is emitted, so the scan
// stops there (ovl+63+seg steps instead of seg+2*ovl).
//
// Exactness: every float op is written with an explicit _rn intrinsic in the
// reference's order, bm = ((s0 + s1) + e0*(255 - 2 s0)) + e1*(255 - 2 s1),
// then pm + bm; e is 0 or 1 so the products are exact. The tie rule is the
// reference's strict `cand_b < cand_a`: on a tie the survivor comes from the
// s>>1 predecessor.
//
// What bounds it on an H100: neither memory (8 bytes in, 1 byte out per
// pair) nor peak arithmetic; each step is a serial chain of shuffles and
// dependent adds, so it is bound by latency and by how many warps (one per
// lane, 1025 at the main-path shape) the 132 SMs can interleave.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPolyA = 79;
constexpr int kPolyB = 109;
constexpr int kReDelay = 63;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float parity(int x) {
  return static_cast<float>(__popc(x) & 1);
}

__global__ void viterbi_re_kernel(const float2* __restrict__ soft, int T,
                                  int L, int seg, int ovl,
                                  uint8_t* __restrict__ out) {
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (lane >= L) return;  // uniform across the warp

  // expected output bits for the transitions into new state 2t+b from the
  // predecessors t (A) and t+32 (B): register (pred << 1) | b
  float eA0[2], eA1[2], eB0[2], eB1[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int ra = (t << 1) | b;
    const int rb = ((t + 32) << 1) | b;
    eA0[b] = parity(ra & kPolyA);
    eA1[b] = parity(ra & kPolyB);
    eB0[b] = parity(rb & kPolyA);
    eB1[b] = parity(rb & kPolyB);
  }
  const int srcA = t >> 1;
  const int srcB = 16 + (t >> 1);
  const bool odd = (t & 1) != 0;

  float pm0 = 0.f, pm1 = 0.f;                     // states 2t, 2t+1
  unsigned long long r0 = 0ull, r1 = 0ull;
  const int emit_from = ovl + kReDelay;
  const int steps = emit_from + seg;
  const long long base_idx = static_cast<long long>(lane) * seg - ovl;
  uint8_t* out_lane = out + static_cast<long long>(lane) * seg;

  for (int s = 0; s < steps; ++s) {
    const long long idx = base_idx + s;
    float s0 = 128.f, s1 = 128.f;
    if (idx >= 0 && idx < T) {
      const float2 v = soft[idx];
      s0 = v.x;
      s1 = v.y;
    }
    // old metrics / survivors of states t (A) and t+32 (B)
    const float a0 = __shfl_sync(kFull, pm0, srcA);
    const float a1 = __shfl_sync(kFull, pm1, srcA);
    const float b0 = __shfl_sync(kFull, pm0, srcB);
    const float b1 = __shfl_sync(kFull, pm1, srcB);
    const unsigned long long ra0 = __shfl_sync(kFull, r0, srcA);
    const unsigned long long ra1 = __shfl_sync(kFull, r1, srcA);
    const unsigned long long rb0 = __shfl_sync(kFull, r0, srcB);
    const unsigned long long rb1 = __shfl_sync(kFull, r1, srcB);
    const float pmA = odd ? a1 : a0;
    const float pmB = odd ? b1 : b0;
    const unsigned long long regA = odd ? ra1 : ra0;
    const unsigned long long regB = odd ? rb1 : rb0;

    const float base = __fadd_rn(s0, s1);
    const float u0 = __fsub_rn(255.f, __fmul_rn(2.f, s0));
    const float u1 = __fsub_rn(255.f, __fmul_rn(2.f, s1));
    float npm[2];
    unsigned long long nr[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float bmA = __fadd_rn(__fadd_rn(base, __fmul_rn(eA0[b], u0)),
                                  __fmul_rn(eA1[b], u1));
      const float bmB = __fadd_rn(__fadd_rn(base, __fmul_rn(eB0[b], u0)),
                                  __fmul_rn(eB1[b], u1));
      const float ca = __fadd_rn(pmA, bmA);
      const float cb = __fadd_rn(pmB, bmB);
      const bool dec = cb < ca;
      npm[b] = dec ? cb : ca;
      nr[b] = ((dec ? regB : regA) << 1) | static_cast<unsigned long long>(b);
    }
    pm0 = npm[0];
    pm1 = npm[1];
    r0 = nr[0];
    r1 = nr[1];
    if (t == 0 && s >= emit_from) {
      out_lane[s - emit_from] = static_cast<uint8_t>(r0 >> 63);
    }
  }
}

}  // namespace

extern "C" int viterbi_re_launch(const void* soft, int T, int L, int seg,
                                 int ovl, void* out, void* stream) {
  constexpr int kWarpsPerBlock = 4;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (L + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_re_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(soft), T, L, seg, ovl,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viterbi_re_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
