// K7: the MaIR mixer's epilogue in float32 on Hopper (sm_90a), hand-written.
//
// Replaces: tpuir/ops/nss_epilogue.py:_forward (the Pallas TPU kernel, via
// mixer_epilogue). Same math, per pixel of B images of H*W pixels, with
// y_k the four direction images of the scan (K2) and g the per-image gates:
//   s   = g[b,0]*y_0 + g[b,1]*y_1 + g[b,2]*y_2 + g[b,3]*y_3   (Di channels)
//   a   = LayerNorm(s) * silu(z)     over the Di channels: mean, then the
//                                    mean of squared deviations (two passes,
//                                    the parity branch), eps 1e-5, weight, bias
//   out = a . W_out^T                out_proj, Di -> Dm, no bias
// The TPU kernel's half-block L/R selects, x^T un-transpose and lane
// padding (statistics over 256 lanes corrected to Di) are TPU layouts: here
// the four images arrive in image order at their real width.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (M = 131,072
// pixels, Di = 234, Dm = 180): the function must read the four direction
// images and z (614 MB) and write out (94 MB), 0.21 ms at 3.35 TB/s, while
// out_proj is 11.0 GFLOP, 0.16 ms at the 67 TFLOP/s float32 peak. Bound by
// bytes.
//
// What the design does about it, kept simple for a first correct kernel:
//   * One warp a pixel combines the four directions, takes the LayerNorm
//     statistics from registers (each lane holds Di/32 channels), applies
//     the norm and the SiLU(z) gate, and writes the gated row once.
//   * out_proj is the SIMT GEMM of simt_gemm.cuh over those rows.
// The gated rows (123 MB) make one round trip through device memory; a
// later change could feed them straight into the GEMM's A-tile loads, as K1
// does with its LayerNorm.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "simt_gemm.cuh"

namespace {

constexpr int kK = 4;  // directions
constexpr int kRowThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp a pixel; V = channels a lane holds (Di <= 32 * V).
// y (B, 4, HW, Di), gates (B, 4, Di), z and gated (B, HW, Di).
template <int V>
__global__ void __launch_bounds__(kRowThreads) combine_norm_gate_kernel(
    const float* __restrict__ y, const float* __restrict__ gates, const float* __restrict__ z,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float* __restrict__ gated,
    long long M, int HW, int Di) {
  const long long m = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // the whole warp leaves together
  const long long b = m / HW;
  const long long p = m - b * HW;
  const long long plane = (long long)HW * Di;  // one direction image
  const float* yp = y + (b * kK * HW + p) * Di;
  const float* gb = gates + b * kK * Di;

  float v[V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    float acc = 0.f;
    if (d < Di) {
      acc = yp[d] * gb[d];
#pragma unroll
      for (int k = 1; k < kK; ++k) acc = fmaf(yp[k * plane + d], gb[k * Di + d], acc);
    }
    v[i] = acc;
    s += acc;
  }
  const float mu = warp_sum(s) / (float)Di;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    if (d < Di) {
      const float dv = v[i] - mu;
      q = fmaf(dv, dv, q);
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)Di + 1e-5f);
  const float* zp = z + m * Di;
  float* out = gated + m * Di;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = lane + 32 * i;
    if (d < Di) out[d] = fmaf((v[i] - mu) * rstd, ln_w[d], ln_b[d]) * silu(zp[d]);
  }
}

}  // namespace

extern "C" {

// y (B, 4, H*W, Di) float32 in image order (K2's output); gates (B, 4, Di);
// z (B, H*W, Di); ln_w, ln_b (Di); w_out (Dm, Di) (torch Linear layout).
// Output out (B, H*W, Dm). Scratch gated >= B*H*W*Di floats. Di <= 1024.
int tpuir_mixer_epilogue_f32(const float* y, const float* gates, const float* z,
                             const float* ln_w, const float* ln_b, const float* w_out,
                             float* gated, float* out, int B, int HW, int Di, int Dm,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || HW <= 0 || Di <= 0 || Di > 1024 || Dm <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * HW;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  if (Di <= 256)
    combine_norm_gate_kernel<8><<<blocks, kRowThreads, 0, st>>>(y, gates, z, ln_w, ln_b, gated,
                                                                M, HW, Di);
  else if (Di <= 512)
    combine_norm_gate_kernel<16><<<blocks, kRowThreads, 0, st>>>(y, gates, z, ln_w, ln_b, gated,
                                                                 M, HW, Di);
  else
    combine_norm_gate_kernel<32><<<blocks, kRowThreads, 0, st>>>(y, gates, z, ln_w, ln_b, gated,
                                                                 M, HW, Di);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_simt_gemm(gated, Di, w_out, (int)M, Dm, Di, StoreRows{out, Dm}, st);
}

}  // extern "C"
