// Latency of the SASS instructions that wait on a scoreboard (conversions,
// MUFU, shared loads, warp shuffles and reductions), for tools/sass_chain.py, which reads the latency of
// every other instruction off the stall counts in the kernels' own SASS.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o op_latency op_latency.cu
//   ./op_latency          # one JSON object: {"F2F.F64.F32": cycles, ...}
//
// Each test is one thread taking kSteps dependent steps in a row between two
// clock64() reads; a step is one instruction, or one instruction and one
// whose latency another test measures (subtracted). Inline PTX keeps every
// step in the chain; the values stay finite and in range. Each test runs
// three times and keeps its fewest cycles (the first run fills the
// instruction cache). Built and run by chip_smoke.py, which keeps a test's
// figure only where its SASS holds the instruction it names at every step
// and little else (sass_chain.py::measured_latencies).

#include <cstdio>
#include <cuda_runtime.h>

constexpr int kSteps = 512;

#define TIMED(body)                                  \
  long long t0 = clock64();                          \
  _Pragma("unroll") for (int i = 0; i < kSteps; ++i) { body; } \
  long long t1 = clock64();                          \
  *cyc = t1 - t0;

// add.rn.f64 with a zero the compiler cannot see: DADD
extern "C" __global__ void lat_dadd(const double* in, double* sink,
                                    long long* cyc) {
  double v = in[0], z = in[1];
  TIMED(asm volatile("add.rn.f64 %0, %0, %1;" : "+d"(v) : "d"(z)))
  sink[0] = v;
}

// cvt.f64.f32, its high word read back as the next float: F2F.F64.F32
extern "C" __global__ void lat_f2f_f64_f32(const float* in, float* sink,
                                           long long* cyc) {
  float v = in[0];
  TIMED(asm volatile("{ .reg .f64 d; .reg .b32 lo, hi;\n\t"
                     "cvt.f64.f32 d, %0;\n\t"
                     "mov.b64 {lo, hi}, d;\n\t"
                     "mov.b32 %0, hi; }" : "+f"(v)))
  sink[0] = v;
}

// cvt.f64.f32, add.rn.f64 of zero, cvt.rn.f32.f64: F2F.F64.F32 + DADD +
// F2F.F32.F64
extern "C" __global__ void lat_f2f_round_trip(const float* in, float* sink,
                                              long long* cyc) {
  float v = in[0];
  const double z = static_cast<double>(in[1]);
  TIMED(asm volatile("{ .reg .f64 d;\n\t"
                     "cvt.f64.f32 d, %0;\n\t"
                     "add.rn.f64 d, d, %1;\n\t"
                     "cvt.rn.f32.f64 %0, d; }" : "+f"(v) : "d"(z)))
  sink[0] = v;
}

// cvt.rni.s32.f32, the integer's bits as the next float: F2I
extern "C" __global__ void lat_f2i(const float* in, float* sink,
                                   long long* cyc) {
  float v = in[0];
  TIMED(asm volatile("{ .reg .s32 i;\n\t"
                     "cvt.rni.s32.f32 i, %0;\n\t"
                     "mov.b32 %0, i; }" : "+f"(v)))
  sink[0] = v;
}

// cvt.rn.f32.s32, the float's bits as the next integer: I2F
extern "C" __global__ void lat_i2f(const int* in, int* sink, long long* cyc) {
  int v = in[0];
  TIMED(asm volatile("{ .reg .f32 f;\n\t"
                     "cvt.rn.f32.s32 f, %0;\n\t"
                     "mov.b32 %0, f; }" : "+r"(v)))
  sink[0] = v;
}

// cvt.rmi.f32.f32: FRND (floor)
extern "C" __global__ void lat_frnd(const float* in, float* sink,
                                    long long* cyc) {
  float v = in[0];
  TIMED(asm volatile("cvt.rmi.f32.f32 %0, %0;" : "+f"(v)))
  sink[0] = v;
}

// cvt.rni.s32.f64, then cvt.rn.f64.s32 back: F2I.F64 + I2F.F64
extern "C" __global__ void lat_f2i_f64(const double* in, double* sink,
                                       long long* cyc) {
  double v = in[0];
  TIMED(asm volatile("{ .reg .s32 i;\n\t"
                     "cvt.rni.s32.f64 i, %0;\n\t"
                     "cvt.rn.f64.s32 %0, i; }" : "+d"(v)))
  sink[0] = v;
}

// cvt.rn.f64.s32, the double's high word as the next integer: I2F.F64
extern "C" __global__ void lat_i2f_f64(const int* in, int* sink,
                                       long long* cyc) {
  int v = in[0];
  TIMED(asm volatile("{ .reg .f64 d; .reg .b32 lo;\n\t"
                     "cvt.rn.f64.s32 d, %0;\n\t"
                     "mov.b64 {lo, %0}, d; }" : "+r"(v)))
  sink[0] = v;
}

// add.rn.f32 with a zero the compiler cannot see: FADD
extern "C" __global__ void lat_fadd(const float* in, float* sink,
                                    long long* cyc) {
  float v = in[0], z = in[1];
  TIMED(asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(z)))
  sink[0] = v;
}

// rcp.approx.ftz.f32 and an FADD of zero (two reciprocals in a row would
// fold): MUFU.RCP (the seed of __fdiv_rn) + FADD
extern "C" __global__ void lat_rcp(const float* in, float* sink,
                                   long long* cyc) {
  float v = in[0], z = in[1];
  TIMED(asm volatile("rcp.approx.ftz.f32 %0, %0;\n\t"
                     "add.rn.f32 %0, %0, %1;" : "+f"(v) : "f"(z)))
  sink[0] = v;
}

// rsqrt.approx.ftz.f32: MUFU.RSQ (the seed of __fsqrt_rn)
extern "C" __global__ void lat_rsq(const float* in, float* sink,
                                   long long* cyc) {
  float v = in[0];
  TIMED(asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(v)))
  sink[0] = v;
}

// rcp.approx.ftz.f64: MUFU.RCP64H
extern "C" __global__ void lat_rcp64h(const double* in, double* sink,
                                      long long* cyc) {
  double v = in[0];
  TIMED(asm volatile("rcp.approx.ftz.f64 %0, %0;" : "+d"(v)))
  sink[0] = v;
}

// rsqrt.approx.ftz.f64: MUFU.RSQ64H
extern "C" __global__ void lat_rsq64h(const double* in, double* sink,
                                      long long* cyc) {
  double v = in[0];
  TIMED(asm volatile("rsqrt.approx.ftz.f64 %0, %0;" : "+d"(v)))
  sink[0] = v;
}

// ld.shared.u32 of the address it loaded (a pointer chase): LDS
extern "C" __global__ void lat_lds(const int* in, int* sink, long long* cyc) {
  __shared__ unsigned buf[64];
  const unsigned a0 =
      static_cast<unsigned>(__cvta_generic_to_shared(&buf[in[0]]));
  buf[in[0]] = a0;
  __syncwarp();
  unsigned v = a0;
  TIMED(asm volatile("ld.shared.u32 %0, [%0];" : "+r"(v)))
  sink[0] = static_cast<int>(v);
}

// ld.shared.u64 of the address it loaded (its low word): LDS.64
extern "C" __global__ void lat_lds64(const int* in, int* sink,
                                     long long* cyc) {
  __shared__ __align__(8) unsigned buf[64];
  const unsigned a0 =
      static_cast<unsigned>(__cvta_generic_to_shared(&buf[2 * in[0]]));
  buf[2 * in[0]] = a0;
  buf[2 * in[0] + 1] = 0;
  __syncwarp();
  unsigned v = a0;
  TIMED(asm volatile("{ .reg .u64 t;\n\t"
                     "ld.shared.u64 t, [%0];\n\t"
                     "cvt.u32.u64 %0, t; }" : "+r"(v)))
  sink[0] = static_cast<int>(v);
}

// shfl.sync.idx.b32 of the value it received, lane 0 alone: SHFL.IDX
extern "C" __global__ void lat_shfl(const int* in, int* sink,
                                    long long* cyc) {
  int v = in[0];
  TIMED(asm volatile("shfl.sync.idx.b32 %0, %0, 0, 0x1f, 1;" : "+r"(v)))
  sink[0] = v;
}

// redux.sync.min.u32 of the value it reduced, lane 0 alone: REDUX (its
// uniform result moved back to a register each step, a fixed latency)
extern "C" __global__ void lat_redux(const int* in, int* sink,
                                     long long* cyc) {
  unsigned v = in[0];
  TIMED(asm volatile("redux.sync.min.u32 %0, %0, 1;" : "+r"(v)))
  sink[0] = static_cast<int>(v);
}

template <class T>
static double run(void (*k)(const T*, T*, long long*), T a, T b) {
  T host[2] = {a, b};
  T *in, *sink;
  long long* cyc;
  cudaMalloc(&in, sizeof host);
  cudaMalloc(&sink, sizeof host);
  cudaMalloc(&cyc, sizeof(long long));
  cudaMemcpy(in, host, sizeof host, cudaMemcpyHostToDevice);
  long long best = -1;
  for (int r = 0; r < 3; ++r) {
    k<<<1, 1>>>(in, sink, cyc);
    long long c = 0;
    cudaMemcpy(&c, cyc, sizeof c, cudaMemcpyDeviceToHost);
    if (best < 0 || c < best) best = c;
  }
  const cudaError_t err = cudaDeviceSynchronize();
  cudaFree(in);
  cudaFree(sink);
  cudaFree(cyc);
  if (err != cudaSuccess) {
    fprintf(stderr, "CUDA error %s\n", cudaGetErrorString(err));
    return -1.0;
  }
  return static_cast<double>(best) / kSteps;
}

int main() {
  const double dadd = run(lat_dadd, 1.0, 0.0);
  const double up = run(lat_f2f_f64_f32, 1.0f, 0.0f);
  const double trip = run(lat_f2f_round_trip, 1.0f, 0.0f);
  const double i2f64 = run(lat_i2f_f64, 1, 0);
  const double fadd = run(lat_fadd, 1.0f, 0.0f);
  const double vals[] = {
      dadd, up, trip - up - dadd, run(lat_f2i, 1.0f, 0.0f),
      run(lat_i2f, 1, 0), run(lat_frnd, 1.5f, 0.0f),
      run(lat_f2i_f64, 1.0, 0.0) - i2f64, i2f64,
      run(lat_rcp64h, 1.5, 0.0), run(lat_rsq64h, 1.5, 0.0),
      run(lat_lds, 3, 0), run(lat_lds64, 3, 0),
      run(lat_rcp, 1.5f, 0.0f) - fadd, run(lat_rsq, 1.5f, 0.0f), fadd,
      run(lat_shfl, 1, 0), run(lat_redux, 1, 0)};
  const char* keys[] = {"DADD", "F2F.F64.F32", "F2F.F32.F64", "F2I", "I2F",
                        "FRND", "F2I.F64", "I2F.F64", "MUFU.RCP64H",
                        "MUFU.RSQ64H", "LDS", "LDS.64", "MUFU.RCP",
                        "MUFU.RSQ", "FADD", "SHFL", "REDUX"};
  constexpr int kTests = sizeof(keys) / sizeof(keys[0]);
  printf("{");
  for (int i = 0; i < kTests; ++i) {
    if (vals[i] <= 0) return 1;
    printf("%s\"%s\": %.3f", i ? ", " : "", keys[i], vals[i]);
  }
  printf("}\n");
  return 0;
}
