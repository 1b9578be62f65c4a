// K3: block Viterbi, k=7 r=1/2 (polys 79/109): the add-compare-select pass
// over a whole block and the traceback from its best end state.
//
// The port's own kernel: the JAX package runs this as two lax.scan loops
// (satdump_tpu/ops/fec/convolutional.py viterbi_acs, viterbi_traceback); on
// the CPU its plain twins are ops/fec/convolutional.py::_acs_plain and
// _traceback_plain, which this kernel equals bit for bit.
//
// What it computes, for each row b of B:
//  acs:       softs (B, T, 2) f32 in [0, 255] and path metrics pm (B, 64) ->
//             the final pm (B, 64) and one decision word a step (B, T) u64.
//             State ns = 2m + c has the predecessors m ("a") and m + 32
//             ("b"); bm = |s0 - 255 e0| + |s1 - 255 e1| (e the expected
//             coded bits of the transition), cand = pm[pred] + bm, decision
//             cand_b < cand_a, new pm = the smaller candidate, then, with
//             `renorm`, pm - min(pm). Decision bit of state 2m + c is bit
//             32 c + m of the word (the low word is the ballot of the even
//             states, the high word of the odd ones).
//  traceback: from argmin(pm) (the lowest state on ties), for t = T-1 .. 0:
//             bit[t] = s & 1, d = the decision of s at t, s = (s >> 1) |
//             (d << 5). Bits (B, T) u8.
//
// Design (a warp a row, four rows a block):
//  1. Lane l holds the metrics of states l and l + 32, the two predecessors
//     of states 2l and 2l + 1, so a step's compare-selects are all in its
//     registers. The new metrics of 2l, 2l + 1 go back to the lanes that
//     need them as predecessors with four __shfl_sync (lane l takes states l
//     and l + 32 from lanes l / 2 and 16 + l / 2).
//  2. The min of the renormalization is one __reduce_min_sync over the
//     metrics' bit patterns mapped to an unsigned order (a float's order is
//     its sign-magnitude order).
//  3. Decisions are two __ballot_sync a step; a lane writes the word to a
//     shared buffer of the chunk, which the warp copies out coalesced.
//  4. Softs are staged in shared memory, kChunk steps a chunk: the next
//     chunk's loads are issued into registers before the current chunk's
//     steps run, so no global load is waited on in the step loop.
//  5. Traceback: the warp copies kTbChunk decision words into shared memory,
//     lane 0 walks them (the loads do not depend on the state, only the
//     shift and select do), and the warp writes the chunk's bits coalesced.
//
// Exactness: only adds, subtracts, compares and selects, each correctly
// rounded (_rn intrinsics, no contraction); 255 e is 0 or 255. The minimum
// is exact whatever the order of the reduction. So pm, the decisions and
// the bits equal the plain version's.
//
// What bounds it: each row is one chain of dependent trellis steps (adds,
// the warp reduction, the shuffles); at B = 1 one warp of the card works.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPolyA = 79;
constexpr int kPolyB = 109;
constexpr int kWarps = 4;         // rows a block
constexpr int kChunk = 256;       // ACS steps staged a chunk
constexpr int kPerLane = kChunk * 2 / 32;   // soft floats a lane a chunk
constexpr int kTbChunk = 1024;    // traceback steps a chunk
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ float expected(int state, int bit, int poly) {
  return (__popc(((state << 1) | bit) & poly) & 1) ? 255.0f : 0.0f;
}

// monotone map of a float's bits to an unsigned order, and back
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_min(float v) {
  return from_key(__reduce_min_sync(kFull, order_key(v)));
}

__device__ __forceinline__ float branch(float s0, float s1, float c0,
                                        float c1) {
  return __fadd_rn(fabsf(__fsub_rn(s0, c0)), fabsf(__fsub_rn(s1, c1)));
}

struct AcsSmem {
  float soft[kChunk * 2];
  u64 dec[kChunk];
};

__global__ void __launch_bounds__(kWarps * 32)
viterbi_acs_kernel(const float* __restrict__ soft,
                   const float* __restrict__ pm_in, float* __restrict__ pm_out,
                   u64* __restrict__ dec, int B, int T, int renorm) {
  __shared__ AcsSmem smem_all[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;
  AcsSmem& sm = smem_all[warp];
  const float* srow = soft + static_cast<size_t>(row) * T * 2;
  u64* drow = dec + static_cast<size_t>(row) * T;

  // expected outputs of this lane's four transitions: (pred, input bit)
  const float ea00 = expected(lane, 0, kPolyA), ea10 = expected(lane, 0, kPolyB);
  const float ea01 = expected(lane, 1, kPolyA), ea11 = expected(lane, 1, kPolyB);
  const float eb00 = expected(lane + 32, 0, kPolyA);
  const float eb10 = expected(lane + 32, 0, kPolyB);
  const float eb01 = expected(lane + 32, 1, kPolyA);
  const float eb11 = expected(lane + 32, 1, kPolyB);
  const int src = lane >> 1;
  const bool odd = lane & 1;

  const size_t prow = static_cast<size_t>(row) * 64;
  float pa = pm_in[prow + lane];
  float pb = pm_in[prow + lane + 32];
  float n0 = 0.0f, n1 = 0.0f;

  const int nfloat = 2 * T;
  float pre[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = i * 32 + lane;
    pre[i] = j < nfloat ? srow[j] : 0.0f;
  }
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) sm.soft[i * 32 + lane] = pre[i];
    __syncwarp();
    if (t0 + kChunk < T) {
      const int base = 2 * (t0 + kChunk);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = base + i * 32 + lane;
        pre[i] = j < nfloat ? srow[j] : 0.0f;
      }
    }
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float s0 = sm.soft[2 * k], s1 = sm.soft[2 * k + 1];
      const float ca0 = __fadd_rn(pa, branch(s0, s1, ea00, ea10));
      const float ca1 = __fadd_rn(pa, branch(s0, s1, ea01, ea11));
      const float cb0 = __fadd_rn(pb, branch(s0, s1, eb00, eb10));
      const float cb1 = __fadd_rn(pb, branch(s0, s1, eb01, eb11));
      const bool d0 = cb0 < ca0, d1 = cb1 < ca1;
      n0 = d0 ? cb0 : ca0;
      n1 = d1 ? cb1 : ca1;
      const unsigned lo = __ballot_sync(kFull, d0);
      const unsigned hi = __ballot_sync(kFull, d1);
      if (renorm) {
        const float mn = warp_min(fminf(n0, n1));
        n0 = __fsub_rn(n0, mn);
        n1 = __fsub_rn(n1, mn);
      }
      if (lane == 0) sm.dec[k] = (static_cast<u64>(hi) << 32) | lo;
      const float x0 = __shfl_sync(kFull, n0, src);
      const float x1 = __shfl_sync(kFull, n1, src);
      const float y0 = __shfl_sync(kFull, n0, src + 16);
      const float y1 = __shfl_sync(kFull, n1, src + 16);
      pa = odd ? x1 : x0;
      pb = odd ? y1 : y0;
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) drow[t0 + i] = sm.dec[i];
    __syncwarp();
  }
  pm_out[prow + lane] = pa;
  pm_out[prow + lane + 32] = pb;
}

struct TbSmem {
  u64 dec[kTbChunk];
  unsigned char bits[kTbChunk];
};

__global__ void __launch_bounds__(kWarps * 32)
viterbi_traceback_kernel(const float* __restrict__ pm,
                         const u64* __restrict__ dec,
                         unsigned char* __restrict__ bits, int B, int T) {
  __shared__ TbSmem smem_all[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;
  TbSmem& sm = smem_all[warp];
  const u64* drow = dec + static_cast<size_t>(row) * T;
  unsigned char* brow = bits + static_cast<size_t>(row) * T;

  // argmin, the lowest state on ties
  const size_t prow = static_cast<size_t>(row) * 64;
  const float p0 = pm[prow + lane], p1 = pm[prow + lane + 32];
  const float mn = warp_min(fminf(p0, p1));
  const unsigned lo = __ballot_sync(kFull, p0 == mn);
  const unsigned hi = __ballot_sync(kFull, p1 == mn);
  unsigned s = lo ? __ffs(lo) - 1 : 32 + __ffs(hi) - 1;

  for (int t1 = T; t1 > 0; t1 -= kTbChunk) {
    const int t0 = max(0, t1 - kTbChunk);
    const int n = t1 - t0;
    for (int i = lane; i < n; i += 32) sm.dec[i] = drow[t0 + i];
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int k = n - 1; k >= 0; --k) {
        const u64 w = sm.dec[k];
        const unsigned half = (s & 1) ? static_cast<unsigned>(w >> 32)
                                      : static_cast<unsigned>(w);
        sm.bits[k] = static_cast<unsigned char>(s & 1);
        const unsigned d = (half >> (s >> 1)) & 1u;
        s = (s >> 1) | (d << 5);
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) brow[t0 + i] = sm.bits[i];
    __syncwarp();
  }
}

int blocks_for(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int viterbi_block_acs_launch(const void* soft, const void* pm_in,
                                        void* pm_out, void* dec, int B, int T,
                                        int renorm, void* stream) {
  if (B < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_acs_kernel<<<blocks_for(B), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soft), static_cast<const float*>(pm_in),
      static_cast<float*>(pm_out), static_cast<u64*>(dec), B, T, renorm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viterbi_block_traceback_launch(const void* pm, const void* dec,
                                              void* bits, int B, int T,
                                              void* stream) {
  if (B < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_traceback_kernel<<<blocks_for(B), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const u64*>(dec),
      static_cast<unsigned char*>(bits), B, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viterbi_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
