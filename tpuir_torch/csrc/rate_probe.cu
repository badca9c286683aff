// P1: the card's elementwise-throughput probe, in float32 on Hopper
// (sm_90a), hand-written.
//
// Replaces: benchmarks/micro_vpu.py:vpu_rate (its Pallas TPU kernel
// _probe_kernel). Same function: for x (8, n) float32,
//   out[i] = sum over the 8 streams s, in order, of op^rounds(x[s, i] * (1 + 1e-6 s))
// with op one of mul (v * 0.99), fma (0.5 v + 0.3) and exp2 (2^-v). With
// rounds = 32 and n = 512 * 128 it is what _probe_kernel computes (0.5 v is
// exact, so the one rounding of fmaf equals the two of 0.5 * v + 0.3).
//
// What bounds it on this card: the op's throughput, by design. Each thread
// loads its 8 values once, keeps the 8 independent chains in registers for
// all rounds (8 independent operations in flight a thread hide the
// pipeline's latency) and stores one value, so bytes are nothing beside
// 8 * rounds operations an element at a large rounds. The TPU kernel's grid
// of 256 repeats of one block would re-read the 2 MB input from L2 on
// every repeat here; one launch with a large rounds replaces them. mul and
// fma go through the 128 float32 lanes of each SM, exp2 through the 16
// special-function (MUFU) lanes, so exp2 should come out near 1/8 of mul.
//
// The chain cannot be folded or hoisted: float multiplication is not
// associative without fast-math, and each round depends on the last. The
// rounds loop is unrolled 16 times, so its counter and branch are about 2%
// of the instructions executed. One round (cuobjdump -sass of
// rate_probe_kernel<op>: 16 unrolled rounds and one remainder round)
// executes, for its 8 streams: mul 8 FMUL; fma 8 FFMA; exp2 8 MUFU.EX2,
// each with the range handling of exp2f around it (1 FSETP, 1 FSEL and
// 2 FMUL, which scale arguments below -126 into range and back).
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStreams = 8;
constexpr int kProbeThreads = 128;

enum ProbeOp { kMul = 0, kFma = 1, kExp2 = 2 };

template <int OP>
__device__ __forceinline__ float probe_op(float v) {
  if (OP == kMul) return v * 0.99f;
  if (OP == kFma) return fmaf(0.5f, v, 0.3f);
  return exp2f(-v);
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads) rate_probe_kernel(const float* __restrict__ x,
                                                                   float* __restrict__ out,
                                                                   long long n, int rounds) {
  const long long i = (long long)blockIdx.x * kProbeThreads + threadIdx.x;
  if (i >= n) return;
  float a[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) a[s] = x[s * n + i] * (float)(1.0 + 1e-6 * s);
#pragma unroll 16
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) a[s] = probe_op<OP>(a[s]);
  }
  float acc = a[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) acc += a[s];
  out[i] = acc;
}

}  // namespace

extern "C" {

// x (8, n) float32, out (n,); op 0 mul, 1 fma, 2 exp2; rounds >= 0.
int tpuir_rate_probe_f32(const float* x, float* out, long long n, int op, int rounds,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || rounds < 0 || op < kMul || op > kExp2) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (op == kMul)
    rate_probe_kernel<kMul><<<(unsigned)blocks, kProbeThreads, 0, st>>>(x, out, n, rounds);
  else if (op == kFma)
    rate_probe_kernel<kFma><<<(unsigned)blocks, kProbeThreads, 0, st>>>(x, out, n, rounds);
  else
    rate_probe_kernel<kExp2><<<(unsigned)blocks, kProbeThreads, 0, st>>>(x, out, n, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
