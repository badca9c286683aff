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
// out_proj is 11.0 GFLOP, 0.067 ms on the tensor cores in 3xTF32 (494.7 / 3
// TFLOP/s) and 0.16 ms at the 67 TFLOP/s float32 FMA peak. Bound by bytes
// on the 3xTF32 line here and at every MaIRUNet level (Di 96-768, Dm = Di /
// 2: at most 35 flops a byte, against the line's 49).
//
// What the design does about it:
//   * One warp a pixel combines the four directions, takes the LayerNorm
//     statistics from registers (each lane holds Di/32 channels; two passes,
//     float32 parity), applies the norm and the SiLU(z) gate, and writes the
//     gated row once, padded with zeros to Dp = Di rounded up to 4 floats.
//     A lane loads and stores 4 consecutive channels at a time where Di is a
//     multiple of 4 (MaIRUNet's widths), 2 where it is even (MaIR-CDN's 234).
//   * out_proj runs on the tensor-core GEMM core of tc_gemm.cuh (3xTF32
//     mma.sync, cp.async ring) with its row store; w_out is copied padded to
//     Dp alike where Di is not a multiple of 4 (MaIR-CDN's 234), so that the
//     core copies both operands 16 bytes at a time.
// The gated rows (123 MB at MaIR-CDN@128) still make one round trip through
// device memory, about 0.07 ms of a 0.58 ms call. One kernel that builds
// each block's gated rows in shared memory and runs out_proj against them
// measured slower on this card (PERF.md §6): with the panel in shared
// memory two blocks an SM fit, too few loads are in flight to read the
// direction images at more than about 1.4 TB/s, and the blocks' load and
// product phases did not overlap.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

constexpr int kK = 4;  // directions
constexpr int kRowThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// VW floats at p (VW * 4-byte aligned) into v, and back.
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// One warp a pixel. A lane holds V groups of VW consecutive channels, group
// g = lane + 32 i at channels VW g .. VW g + VW - 1 (Di a multiple of VW, the
// pointers and rows aligned to VW floats, ldg <= 32 V VW), so that it loads
// and stores VW floats at a time.
// y (B, 4, HW, Di), gates (B, 4, Di), z (B, HW, Di); gated (B, HW, ldg) with
// columns [Di, ldg) set to 0.
template <int VW, int V>
__global__ void __launch_bounds__(kRowThreads) combine_norm_gate_kernel(
    const float* __restrict__ y, const float* __restrict__ gates, const float* __restrict__ z,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float* __restrict__ gated,
    long long M, int HW, int Di, int ldg) {
  const long long m = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // the whole warp leaves together
  const long long b = m / HW;
  const long long p = m - b * HW;
  const long long plane = (long long)HW * Di;  // one direction image
  const float* yp = y + (b * kK * HW + p) * Di;
  const float* gb = gates + b * kK * Di;

  float v[V][VW];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = (lane + 32 * i) * VW;
#pragma unroll
    for (int c = 0; c < VW; ++c) v[i][c] = 0.f;
    if (d < Di) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        float yk[VW], gk[VW];
        load_vec<VW>(yp + k * plane + d, yk);
        load_vec<VW>(gb + k * Di + d, gk);
#pragma unroll
        for (int c = 0; c < VW; ++c) v[i][c] = k ? fmaf(yk[c], gk[c], v[i][c]) : yk[c] * gk[c];
      }
    }
#pragma unroll
    for (int c = 0; c < VW; ++c) s += v[i][c];
  }
  const float mu = warp_sum(s) / (float)Di;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((lane + 32 * i) * VW < Di) {
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        const float dv = v[i][c] - mu;
        q = fmaf(dv, dv, q);
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)Di + 1e-5f);
  const float* zp = z + m * Di;
  float* out = gated + m * ldg;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int d = (lane + 32 * i) * VW;
    float o[VW];
    if (d < Di) {
      float zv[VW], w[VW], bb[VW];
      load_vec<VW>(zp + d, zv);
      load_vec<VW>(ln_w + d, w);
      load_vec<VW>(ln_b + d, bb);
#pragma unroll
      for (int c = 0; c < VW; ++c) o[c] = fmaf((v[i][c] - mu) * rstd, w[c], bb[c]) * silu(zv[c]);
      store_vec<VW>(out + d, o);
    } else if (d < ldg) {  // the zero padding, ldg - Di a multiple of VW
#pragma unroll
      for (int c = 0; c < VW; ++c) o[c] = 0.f;
      store_vec<VW>(out + d, o);
    }
  }
}

// The combine kernel for Di: VW floats a load where Di and every pointer
// allow it, and V groups a lane for the padded width dp.
template <int VW>
void launch_combine(const float* y, const float* gates, const float* z, const float* ln_w,
                    const float* ln_b, float* gated, long long M, int HW, int Di, int dp,
                    cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  const int groups = (dp + VW - 1) / VW;  // of VW floats, a row
  if (groups <= 32 * 8 / VW)
    combine_norm_gate_kernel<VW, 8 / VW><<<blocks, kRowThreads, 0, st>>>(
        y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp);
  else if (groups <= 32 * 16 / VW)
    combine_norm_gate_kernel<VW, 16 / VW><<<blocks, kRowThreads, 0, st>>>(
        y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp);
  else
    combine_norm_gate_kernel<VW, 32 / VW><<<blocks, kRowThreads, 0, st>>>(
        y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

// dst (rows, ldd) = src (rows, cols) with columns [cols, ldd) set to 0
__global__ void __launch_bounds__(kRowThreads) pad_weight_kernel(const float* __restrict__ src,
                                                                 float* __restrict__ dst,
                                                                 int rows, int cols, int ldd) {
  const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= (long long)rows * ldd) return;
  const int r = (int)(i / ldd), c = (int)(i - (long long)r * ldd);
  dst[i] = c < cols ? src[(long long)r * cols + c] : 0.f;
}

}  // namespace

extern "C" {

// y (B, 4, H*W, Di) float32 in image order (K2's output); gates (B, 4, Di);
// z (B, H*W, Di); ln_w, ln_b (Di); w_out (Dm, Di) (torch Linear layout).
// Output out (B, H*W, Dm). Scratch, with Dp = Di rounded up to a multiple of
// 4: gated >= B*H*W*Dp floats, w_pad >= Dm*Dp floats (16-byte aligned).
// Di <= 1024.
int tpuir_mixer_epilogue_f32(const float* y, const float* gates, const float* z,
                             const float* ln_w, const float* ln_b, const float* w_out,
                             float* gated, float* w_pad, float* out, int B, int HW, int Di,
                             int Dm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || HW <= 0 || Di <= 0 || Di > 1024 || Dm <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * HW;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int dp = (Di + 3) / 4 * 4;
  const float* ptrs[6] = {y, gates, z, ln_w, ln_b, gated};
  bool a16 = Di % 4 == 0, a8 = Di % 2 == 0;
  for (const float* q : ptrs) a16 = a16 && aligned(q, 16), a8 = a8 && aligned(q, 8);
  if (a16)
    launch_combine<4>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  else if (a8)
    launch_combine<2>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  else
    launch_combine<1>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const float* w = w_out;
  if (dp != Di) {  // w_out's rows padded alike, so that the core copies 16 bytes at a time
    const unsigned pad_blocks = (unsigned)(((long long)Dm * dp + kRowThreads - 1) / kRowThreads);
    pad_weight_kernel<<<pad_blocks, kRowThreads, 0, st>>>(w_out, w_pad, Dm, Di, dp);
    if ((err = (int)cudaGetLastError())) return err;
    w = w_pad;
  }
  const tc::Args p{gated, 0, dp, w, 0, (int)M, Dm, dp};
  return tc::launch_tc_gemm(p, 1, tc::NoPrologue{},
                            tc::StoreOut{out, nullptr, Dm, tc::pairs_aligned(out, nullptr, Dm)},
                            st);
}

}  // extern "C"
