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
// Steps after the last emitted bit change nothing that is emitted, so a lane
// runs ovl+63+seg steps (rounded up to whole chunks) instead of seg+2*ovl.
//
// Design (16 threads a lane, two lanes a warp, eight a block):
//  1. Softs are staged in shared memory by cp.async, 32 steps a chunk,
//     double-buffered: the next chunk's copy is in flight while the current
//     one is decoded, and no global load is left inside the step loop. The
//     copies are 8 bytes (one pair), so any ovl and any 8-byte-aligned base
//     works. Pairs outside [0, T) are written as 128. The lane's threads
//     turn each staged pair into the step's four distinct branch metrics
//     once, stored in four orders (one per butterfly type), so a thread
//     reads its step's metrics with one 16-byte shared load.
//  2. Radix-4 grouping: thread j holds the old states {j, j+16, j+32, j+48};
//     one trellis step leads them to {2j, 2j+1, 2j+32, 2j+33} and a second
//     to {4j .. 4j+3}, so the group is closed over two steps and both are
//     done in registers, each with exactly the radix-2 reference's ACS and
//     rounding. The threads then re-form the layout once per two steps
//     through shared memory (double-buffered, one __syncwarp), laid out so
//     that neither the stores nor the loads clash on a bank.
//  3. 128 threads a block; L lanes are rounded up to whole blocks without
//     needing to divide: a warp whose lanes all lie past L returns, a lane
//     past L in a live warp decodes a copy of lane L-1 and stores nothing.
//     Shared memory stays under the 48 KB static limit.
//  4. Thread 0 of a lane (which always holds state 0) gathers a chunk's
//     emitted bits in one word; the lane's threads then store them as
//     neighbouring bytes.
//
// What bounds it on an H100 (measured, see PERF.md): not device memory
// (8 bytes in, 1 byte out per pair) and not the arithmetic peak. Each lane
// is a chain of dependent steps and there are only L lanes (1025 on the
// main path, one warp per scheduler), and each pair of steps moves every
// state's metric and survivor (12 bytes) through shared memory and back.
// The other layouts PERF.md lists (32 threads a lane, warp-specialised,
// fewer integer operations) share that exchange and were no faster.
//
// Exactness: the ACS is only adds and compares, bm = ((s0 + s1) + e0*u0) +
// e1*u1 with u = 255 - 2s, then pm + bm, written with explicit _rn
// intrinsics. e is 0 or 1, so each step has four distinct metrics, base,
// base+u1, base+u0 and (base+u0)+u1, which equal the reference's form bit
// for bit (adding e*u = +-0 changes nothing). The products 2*s are __fmul_rn,
// so the kernel holds no FFMA at all (chip_smoke.py checks its SASS). The
// tie rule is the reference's strict `cand_b < cand_a`: on a tie the
// survivor comes from the s>>1 predecessor.
//
// Tensor cores do not apply: the ACS is a min-plus recurrence, not a
// multiply-add.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPolyA = 79;
constexpr int kPolyB = 109;
constexpr int kReDelay = 63;
constexpr int kChunk = 32;        // steps staged per chunk
constexpr int kThreads = 128;     // threads a block
constexpr int kLaneThreads = 16;  // threads a lane
constexpr int kLanesPerBlock = kThreads / kLaneThreads;
constexpr int kRegHi = 40;        // survivor slot of states 4j+2, 4j+3
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

struct LaneSmem {
  // q[k][t]: chunk step k's metrics for a butterfly of type t,
  // (bm_t, bm_t^3, bm_t^1, bm_t^2)
  float4 q[kChunk][4];
  float2 raw[2][kChunk];          // staged soft pairs, double-buffered
  float xpm[2][64];               // exchange, double-buffered
  // state 4a+m's survivor at 2a+m (m < 2) or kRegHi+2a+m-2 (m >= 2): each
  // thread stores two neighbouring 16-byte pairs, and the 8-slot gap keeps
  // the loads of states j + 16i off each other's banks
  u64 xreg[2][kRegHi + 32];
  float pad[16];                  // the warp's two lanes' xpm 64 B apart
};

__device__ __forceinline__ int parity(int x) { return __popc(x) & 1; }

// butterfly type of m: the expected bits (e0, e1) of the transition from
// old state m into new state 2m, as t = 2*e0 + e1. The transitions m+32 ->
// 2m and m -> 2m+1 use t ^ 3, and m+32 -> 2m+1 uses t again.
__device__ __forceinline__ int bfly_type(int m) {
  return 2 * parity((2 * m) & kPolyA) + parity((2 * m) & kPolyB);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// stage window pairs [first, first + kChunk) into raw[buf]; 128 outside
// [0, T)
__device__ __forceinline__ void stage(LaneSmem& sm, int buf,
                                      const float2* __restrict__ soft,
                                      int T, long long first, int j) {
#pragma unroll
  for (int k = j; k < kChunk; k += kLaneThreads) {
    const long long idx = first + k;
    if (idx >= 0 && idx < T) {
      cp_async8(&sm.raw[buf][k], soft + idx);
    } else {
      sm.raw[buf][k] = make_float2(128.f, 128.f);
    }
  }
  cp_async_commit();
}

// the four distinct branch metrics of each staged step, in the four
// butterfly-type orders
__device__ __forceinline__ void make_metrics(LaneSmem& sm, int buf, int j) {
#pragma unroll
  for (int k = j; k < kChunk; k += kLaneThreads) {
    const float2 v = sm.raw[buf][k];
    const float base = __fadd_rn(v.x, v.y);
    const float u0 = __fsub_rn(255.f, __fmul_rn(2.f, v.x));
    const float u1 = __fsub_rn(255.f, __fmul_rn(2.f, v.y));
    float bm[4];
    bm[0] = base;                        // e0 = 0, e1 = 0
    bm[1] = __fadd_rn(base, u1);         // e0 = 0, e1 = 1
    bm[2] = __fadd_rn(base, u0);         // e0 = 1, e1 = 0
    bm[3] = __fadd_rn(bm[2], u1);        // e0 = 1, e1 = 1
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      sm.q[k][t] = make_float4(bm[t], bm[t ^ 3], bm[t ^ 1], bm[t ^ 2]);
    }
  }
}

// one butterfly: old states a = m, b = m+32 -> new 2m (bit 0), 2m+1 (bit 1);
// X is the metric of a -> 2m and b -> 2m+1, Y of b -> 2m and a -> 2m+1
__device__ __forceinline__ void bfly(float pa, u64 ra, float pb, u64 rb,
                                     float X, float Y, float& p0, u64& r0,
                                     float& p1, u64& r1) {
  const float c0a = __fadd_rn(pa, X);
  const float c0b = __fadd_rn(pb, Y);
  const bool d0 = c0b < c0a;
  p0 = d0 ? c0b : c0a;
  r0 = (d0 ? rb : ra) << 1;
  const float c1a = __fadd_rn(pa, Y);
  const float c1b = __fadd_rn(pb, X);
  const bool d1 = c1b < c1a;
  p1 = d1 ? c1b : c1a;
  r1 = ((d1 ? rb : ra) << 1) | 1ull;
}

__device__ __forceinline__ unsigned top_bit(u64 r) {
  return static_cast<unsigned>(r >> 63);
}

// a lane's 64 states over 16 threads, two trellis steps per exchange
struct Radix4 {
  float pm[4] = {0.f, 0.f, 0.f, 0.f};   // states j, j+16, j+32, j+48
  u64 rg[4] = {0ull, 0ull, 0ull, 0ull};
  int j, tau, sig, rd;
  // rd: xreg slot of state j (= 4a+m, a = j/4, m = j%4); state j + 16i
  // sits 8i further on
  __device__ explicit Radix4(int j_)
      : j(j_), tau(bfly_type(j_)), sig(bfly_type(2 * j_)),
        rd(((j_ & 2) ? kRegHi : 0) + 2 * (j_ >> 2) + (j_ & 1)) {}

  // one chunk of steps; returns the chunk's emitted bits (thread 0's)
  __device__ __forceinline__ unsigned chunk(LaneSmem& sm) {
    unsigned mask = 0;
#pragma unroll
    for (int k = 0; k < kChunk; k += 2) {
      // step 1: butterflies m = j (type tau) and m = j+16 (type tau^1)
      float ip0, ip1, ip2, ip3;
      u64 ir0, ir1, ir2, ir3;
      float4 q = sm.q[k][tau];
      bfly(pm[0], rg[0], pm[2], rg[2], q.x, q.y, ip0, ir0, ip1, ir1);
      bfly(pm[1], rg[1], pm[3], rg[3], q.z, q.w, ip2, ir2, ip3, ir3);
      mask |= top_bit(ir0) << k;
      // step 2: butterflies m = 2j (type sig) and m = 2j+1 (type sig^2)
      float n0, n1, n2, n3;
      u64 nr0, nr1, nr2, nr3;
      q = sm.q[k + 1][sig];
      bfly(ip0, ir0, ip2, ir2, q.x, q.y, n0, nr0, n1, nr1);
      bfly(ip1, ir1, ip3, ir3, q.w, q.z, n2, nr2, n3, nr3);
      mask |= top_bit(nr0) << (k + 1);
      // states 4j .. 4j+3 out, states j + 16i in
      const int xb = (k >> 1) & 1;
      reinterpret_cast<float4*>(sm.xpm[xb])[j] = make_float4(n0, n1, n2, n3);
      ulonglong2* xr = reinterpret_cast<ulonglong2*>(sm.xreg[xb]);
      xr[j] = make_ulonglong2(nr0, nr1);
      xr[kRegHi / 2 + j] = make_ulonglong2(nr2, nr3);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pm[i] = sm.xpm[xb][j + 16 * i];
        rg[i] = sm.xreg[xb][rd + 8 * i];
      }
    }
    return mask;
  }
};

__global__ void __launch_bounds__(kThreads)
    viterbi_re_kernel(const float2* __restrict__ soft, int T, int L,
                      int seg, int ovl, uint8_t* __restrict__ out) {
  __shared__ LaneSmem smem[kLanesPerBlock];

  const int slot = threadIdx.x / kLaneThreads;
  const int j = threadIdx.x % kLaneThreads;
  const int lane = blockIdx.x * kLanesPerBlock + slot;
  const int warp_first = blockIdx.x * kLanesPerBlock +
                         (threadIdx.x / 32) * (32 / kLaneThreads);
  if (warp_first >= L) return;    // uniform across the warp
  const bool live = lane < L;
  LaneSmem& sm = smem[slot];

  const int emit_from = ovl + kReDelay;
  const int steps = emit_from + seg;
  const int nch = (steps + kChunk - 1) / kChunk;
  const long long first =
      static_cast<long long>(live ? lane : L - 1) * seg - ovl;
  uint8_t* out_lane = out + static_cast<long long>(lane) * seg;
  // thread 0 of this lane, as a lane index within the warp
  const int leader = (threadIdx.x & 31) & ~(kLaneThreads - 1);

  Radix4 acs(j);
  stage(sm, 0, soft, T, first, j);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(sm, (c + 1) & 1, soft, T, first + (c + 1) * kChunk, j);
    } else {
      cp_async_commit();          // an empty group keeps the wait uniform
    }
    cp_async_wait_one();          // chunk c has landed
    __syncwarp();
    make_metrics(sm, c & 1, j);
    __syncwarp();
    const unsigned mask = __shfl_sync(kFull, acs.chunk(sm), leader);
    const int o0 = c * kChunk - emit_from;
    if (live) {
#pragma unroll
      for (int k = j; k < kChunk; k += kLaneThreads) {
        const int o = o0 + k;
        if (o >= 0 && o < seg) {
          out_lane[o] = static_cast<uint8_t>((mask >> k) & 1u);
        }
      }
    }
  }
}

}  // namespace

extern "C" int viterbi_re_launch(const void* soft, int T, int L, int seg,
                                 int ovl, void* out, void* stream) {
  const int blocks = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  viterbi_re_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(soft), T, L, seg, ovl,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* viterbi_re_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
