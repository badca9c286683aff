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
// The serving body (tpuir_mixer_epilogue_bf16; the TPU kernel with
// serving=True) reads y and z in bf16 (widened exactly), takes the gated sum
// and the LayerNorm in float32 with the one-pass variance, max(E[s^2] -
// mu^2, 0), and stores the gated rows rounded to bf16 (nearest even), as the
// JAX kernel rounds them for out_proj, padded with zeros to Di rounded up to
// 8 values; out_proj then runs on the core's bf16-operand kernel with a bf16
// copy of W_out padded alike (tc::round_rows_bf16), and the output stays
// float32. y, z and the gated rows move half the bytes of the parity body's.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// VW bf16 at p (VW * 2-byte aligned) into v, widened.
template <int VW>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else if constexpr (VW == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
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

__device__ __forceinline__ __nv_bfloat16 gated_bf16(float v) {
  return __float2bfloat16_rn(v);  // the gated rows' rounding
}

// VW values rounded to bf16 at p (VW * 2-byte aligned).
template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    __nv_bfloat162 a = __halves2bfloat162(gated_bf16(v[0]), gated_bf16(v[1]));
    __nv_bfloat162 b = __halves2bfloat162(gated_bf16(v[2]), gated_bf16(v[3]));
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
  } else if constexpr (VW == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(gated_bf16(v[0]), gated_bf16(v[1]));
  } else {
    *p = gated_bf16(v[0]);
  }
}

// One warp a pixel. A lane holds V groups of VW consecutive channels, group
// g = lane + 32 i at channels VW g .. VW g + VW - 1 (Di a multiple of VW, the
// pointers and rows aligned to VW values, ldg <= 32 V VW), so that it loads
// and stores VW values at a time.
// y (B, 4, HW, Di) and z (B, HW, Di) of TI (float32, or bf16 in the serving
// body), gates (B, 4, Di); gated (B, HW, ldg) of TI (float32, or rounded to
// bf16) with columns [Di, ldg) set to 0. The variance is the mean of squared
// deviations (two passes, the parity body) or, ONE_PASS (the serving body),
// max(E[s^2] - mu^2, 0).
template <int VW, int V, class TI, bool ONE_PASS>
__device__ __forceinline__ void combine_norm_gate(
    const TI* __restrict__ y, const float* __restrict__ gates, const TI* __restrict__ z,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, TI* __restrict__ gated,
    long long M, int HW, int Di, int ldg) {
  const long long m = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // the whole warp leaves together
  const long long b = m / HW;
  const long long p = m - b * HW;
  const long long plane = (long long)HW * Di;  // one direction image
  const TI* yp = y + (b * kK * HW + p) * Di;
  const float* gb = gates + b * kK * Di;

  float v[V][VW];
  float s = 0.f, s2 = 0.f;
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
    for (int c = 0; c < VW; ++c) {
      s += v[i][c];
      if (ONE_PASS) s2 = fmaf(v[i][c], v[i][c], s2);
    }
  }
  const float mu = warp_sum(s) / (float)Di;
  float var;
  if constexpr (ONE_PASS) {
    var = fmaxf(fmaf(-mu, mu, warp_sum(s2) / (float)Di), 0.f);
  } else {
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
    var = warp_sum(q) / (float)Di;
  }
  const float rstd = 1.0f / sqrtf(var + 1e-5f);
  const TI* zp = z + m * Di;
  TI* out = gated + m * ldg;
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

// The kernels: the parity body's (float32) and the serving body's (bf16).
template <int VW, int V, class TI, bool ONE_PASS>
__global__ void __launch_bounds__(kRowThreads) combine_norm_gate_kernel(
    const TI* __restrict__ y, const float* __restrict__ gates, const TI* __restrict__ z,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float* __restrict__ gated,
    long long M, int HW, int Di, int ldg) {
  combine_norm_gate<VW, V, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, ldg);
}

template <int VW, int V, bool ONE_PASS>
__global__ void __launch_bounds__(kRowThreads) combine_norm_gate_bf16_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ gates,
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, __nv_bfloat16* __restrict__ gated, long long M, int HW,
    int Di, int ldg) {
  combine_norm_gate<VW, V, __nv_bfloat16, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di,
                                                   ldg);
}

// The combine kernel with V groups a lane.
template <int VW, int V, class TI, bool ONE_PASS>
void launch_combine_v(const TI* y, const float* gates, const TI* z, const float* ln_w,
                      const float* ln_b, TI* gated, long long M, int HW, int Di, int dp,
                      cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  if constexpr (std::is_same_v<TI, float>)
    combine_norm_gate_kernel<VW, V, TI, ONE_PASS><<<blocks, kRowThreads, 0, st>>>(
        y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp);
  else
    combine_norm_gate_bf16_kernel<VW, V, ONE_PASS><<<blocks, kRowThreads, 0, st>>>(
        y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp);
}

// The combine kernel for Di: VW values a load where Di and every pointer
// allow it, and V groups a lane for the padded width dp.
template <int VW, class TI, bool ONE_PASS>
void launch_combine(const TI* y, const float* gates, const TI* z, const float* ln_w,
                    const float* ln_b, TI* gated, long long M, int HW, int Di, int dp,
                    cudaStream_t st) {
  const int groups = (dp + VW - 1) / VW;  // of VW values, a row
  if (groups <= 32 * 8 / VW)
    launch_combine_v<VW, 8 / VW, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  else if (groups <= 32 * 16 / VW)
    launch_combine_v<VW, 16 / VW, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp,
                                                st);
  else
    launch_combine_v<VW, 32 / VW, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp,
                                                st);
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

// The gated rows, then out_proj: the parity body (TI float: float32 rows
// padded to 4 values, w_out copied so padded where it must be, the 3xTF32
// core) or the serving body (TI bf16: rows rounded to bf16 and padded to 8,
// W_out's bf16 copy padded alike in w_pad, the bf16-operand core); the
// variance one-pass or not.
template <class TI, bool ONE_PASS>
int epilogue(const TI* y, const float* gates, const TI* z, const float* ln_w, const float* ln_b,
             const float* w_out, TI* gated, TI* w_pad, float* out, int B, int HW, int Di, int Dm,
             cudaStream_t st) {
  constexpr bool kBf16 = std::is_same_v<TI, __nv_bfloat16>;
  if (B <= 0 || HW <= 0 || Di <= 0 || Di > 1024 || Dm <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * HW;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int dp = kBf16 ? (Di + 7) / 8 * 8 : (Di + 3) / 4 * 4;
  // VW values a load: every pointer and row aligned to VW values of its type
  constexpr int kIn = (int)sizeof(TI);
  const void* ins[3] = {y, z, gated};
  const void* f32s[3] = {gates, ln_w, ln_b};
  bool a4 = Di % 4 == 0, a2 = Di % 2 == 0;
  for (const void* q : ins) a4 = a4 && aligned(q, 4 * kIn), a2 = a2 && aligned(q, 2 * kIn);
  for (const void* q : f32s) a4 = a4 && aligned(q, 16), a2 = a2 && aligned(q, 8);
  if (a4)
    launch_combine<4, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  else if (a2)
    launch_combine<2, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  else
    launch_combine<1, TI, ONE_PASS>(y, gates, z, ln_w, ln_b, gated, M, HW, Di, dp, st);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const tc::StoreOut store{out, nullptr, Dm, tc::pairs_aligned(out, nullptr, Dm)};
  if constexpr (kBf16) {
    if ((err = tc::round_rows_bf16(w_out, w_pad, Dm, Di, dp, st))) return err;
    const tc::ArgsBf16 p{gated, 0, dp, w_pad, 0, (int)M, Dm, dp};
    return tc::launch_tc_gemm_bf16(p, 1, store, st);
  } else {
    const float* w = w_out;
    if (dp != Di) {  // w_out's rows padded alike, so that the core copies 16 bytes at a time
      const unsigned pad_blocks =
          (unsigned)(((long long)Dm * dp + kRowThreads - 1) / kRowThreads);
      pad_weight_kernel<<<pad_blocks, kRowThreads, 0, st>>>(w_out, w_pad, Dm, Di, dp);
      if ((err = (int)cudaGetLastError())) return err;
      w = w_pad;
    }
    const tc::Args p{gated, 0, dp, w, 0, (int)M, Dm, dp};
    return tc::launch_tc_gemm(p, 1, tc::NoPrologue{}, store, st);
  }
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
  return epilogue<float, false>(y, gates, z, ln_w, ln_b, w_out, gated, w_pad, out, B, HW, Di, Dm,
                                (cudaStream_t)stream);
}

// The serving body: y and z bf16; scratch, with Dp = Di rounded up to a
// multiple of 8: gated >= B*H*W*Dp bf16, w16 >= Dm*Dp bf16 (W_out's copy),
// both 16-byte aligned; the rest as tpuir_mixer_epilogue_f32.
int tpuir_mixer_epilogue_bf16(const __nv_bfloat16* y, const float* gates,
                              const __nv_bfloat16* z, const float* ln_w, const float* ln_b,
                              const float* w_out, __nv_bfloat16* gated, __nv_bfloat16* w16,
                              float* out, int B, int HW, int Di, int Dm, void* stream) {
  return epilogue<__nv_bfloat16, true>(y, gates, z, ln_w, ln_b, w_out, gated, w16, out, B, HW,
                                       Di, Dm, (cudaStream_t)stream);
}

}  // extern "C"
