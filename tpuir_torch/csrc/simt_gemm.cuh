// The float32 SIMT GEMM of the x_proj products of K2 (nss_scan.cu), K3
// (scan_fused_proj.cu) and K5 (nss_fused.cu): out = A . W^T, a batch of
// products, product z reading weight z % w_groups (K3: direction z % 4's).
//
// Each output is one FMA chain over k in ascending order from zero, on the
// float32 FMA pipe, no tensor cores: parity mode is true float32, and the
// rounding is an FMA chain's. (K3's scan compounds x_dbl's rounding over a
// sequence; its source note says why that rounding matters there.) Block
// tile 128 x 48 x 32 of 256 threads, 8 x 3 outputs a thread (rows ty*8..,
// columns tx + 16j); the next k slice is fetched into registers, as float4
// along k where K and the pointers allow, while the current one is
// multiplied, and stored into the other half of a double-buffered tile.
// Every load is bounds-checked, so M, N and K may take any value.
//
// K2's serving body takes A in bf16 (x, as K6 stores it): each value is
// widened exactly, and each weight rounded to bf16 (nearest even), on its
// way into shared memory, so every product of the chain is a product of two
// bf16 values, exact in float32, as the JAX kernel's bf16 x bf16 products
// with float32 sums. The next slice is held raw in registers and converted
// only when it is stored, after the current slice's products: a conversion
// at load would wait on the load and undo the prefetch. A float32 A leaves
// the weights as they are.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGemmBM = 128, kGemmBN = 48, kGemmBK = 32, kGemmThreads = 256;

// A's values as fetched into registers (raw: one value, or four along k),
// and widened to float32 when they are stored into shared memory.
template <class TA>
struct GemmA;
template <>
struct GemmA<float> {
  using raw = float;
  using raw4 = float4;
  static __device__ __forceinline__ raw zero() { return 0.f; }
  static __device__ __forceinline__ raw4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ raw4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float widen(raw v) { return v; }
  static __device__ __forceinline__ float4 widen4(raw4 v) { return v; }
};
template <>
struct GemmA<__nv_bfloat16> {
  using raw = __nv_bfloat16;
  using raw4 = uint2;  // four bf16, 8-byte aligned
  static __device__ __forceinline__ raw zero() { return __ushort_as_bfloat16(0); }
  static __device__ __forceinline__ raw4 zero4() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ raw4 load4(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ float widen(raw v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float4 widen4(raw4 v) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};
// v rounded to bf16 (nearest even), as a float
__device__ __forceinline__ float gemm_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A (batch, M, K) of TA (float or bf16), W (w_groups, N, K), out (batch, M,
// N), all row-major; grid (ceil(M / BM), ceil(N / BN), batch).
template <bool VEC4, class TA>
__global__ void __launch_bounds__(kGemmThreads) simt_gemm_nt_kernel(
    const TA* __restrict__ A, const float* __restrict__ W, float* __restrict__ out, int M,
    int N, int K, int w_groups) {
  constexpr bool kBf16 = std::is_same_v<TA, __nv_bfloat16>;  // W rounded to bf16
  using GA = GemmA<TA>;
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
  __shared__ __align__(16) float Ws[2][kGemmBK][kGemmBN + 1];
  const int z = blockIdx.z;
  A += (long long)z * M * K;
  W += (long long)(z % w_groups) * N * K;
  out += (long long)z * M * N;
  const int m0 = blockIdx.x * kGemmBM, n0 = blockIdx.y * kGemmBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loads: VEC4, k lk4 .. lk4 + 3 of rows lr + 32i; else k lk of rows lr1 + 8i
  constexpr int kA = VEC4 ? kGemmBM / 32 : kGemmBM * kGemmBK / kGemmThreads;
  constexpr int kW = VEC4 ? (kGemmBN + 31) / 32 : kGemmBN * kGemmBK / kGemmThreads;
  const int lk4 = (tid & 7) * 4, lr = tid >> 3;
  const int lk = tid & (kGemmBK - 1), lr1 = tid >> 5;
  typename GA::raw4 ra4[VEC4 ? kA : 1];
  float4 rw4[VEC4 ? kW : 1];
  typename GA::raw ra[VEC4 ? 1 : kA];
  float rw[VEC4 ? 1 : kW];
  float acc[8][3] = {};

  auto fetch = [&](int k0) {
    if constexpr (VEC4) {
      const int k = k0 + lk4;  // K % 4 == 0: the four are in or out together
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int m = m0 + lr + 32 * i;
        ra4[i] = (m < M && k < K) ? GA::load4(A + (long long)m * K + k) : GA::zero4();
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const int r = lr + 32 * i, n = n0 + r;
        rw4[i] = (r < kGemmBN && n < N && k < K)
                     ? *reinterpret_cast<const float4*>(W + (long long)n * K + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      const int k = k0 + lk;
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int m = m0 + lr1 + 8 * i;
        ra[i] = (m < M && k < K) ? A[(long long)m * K + k] : GA::zero();
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const int n = n0 + lr1 + 8 * i;
        rw[i] = (n < N && k < K) ? W[(long long)n * K + k] : 0.f;
      }
    }
  };
  // a weight as stored: rounded to bf16 when A is bf16
  auto wv = [](float v) { return kBf16 ? gemm_round_bf16(v) : v; };
  auto stash = [&](int buf) {
    if constexpr (VEC4) {
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int r = lr + 32 * i;
        const float4 a = GA::widen4(ra4[i]);
        As[buf][lk4][r] = a.x, As[buf][lk4 + 1][r] = a.y;
        As[buf][lk4 + 2][r] = a.z, As[buf][lk4 + 3][r] = a.w;
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const int r = lr + 32 * i;
        if (r < kGemmBN) {
          Ws[buf][lk4][r] = wv(rw4[i].x), Ws[buf][lk4 + 1][r] = wv(rw4[i].y);
          Ws[buf][lk4 + 2][r] = wv(rw4[i].z), Ws[buf][lk4 + 3][r] = wv(rw4[i].w);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kA; ++i) As[buf][lk][lr1 + 8 * i] = GA::widen(ra[i]);
#pragma unroll
      for (int i = 0; i < kW; ++i) Ws[buf][lk][lr1 + 8 * i] = wv(rw[i]);
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    const bool more = k0 + kGemmBK < K;
    if (more) fetch(k0 + kGemmBK);
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float wv[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) wv[j] = Ws[buf][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

// out[z] = A[z] . W[z % w_groups]^T for z < batch: A (batch, M, K) float32,
// or bf16 with W rounded to bf16 at load; W (w_groups, N, K) (a torch Linear
// weight as it is), out (batch, M, N).
template <class TA>
inline int launch_simt_gemm(const TA* A, const float* W, float* out, int M, int N, int K,
                            cudaStream_t st, int batch = 1, int w_groups = 1) {
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN, (unsigned)batch);
  // four A values a load: 16 bytes of float32, 8 of bf16
  const uintptr_t a_align = sizeof(TA) == 4 ? 15 : 7;
  if (K % 4 == 0 && ((uintptr_t)A & a_align) == 0 && ((uintptr_t)W & 15) == 0)
    simt_gemm_nt_kernel<true, TA><<<grid, kGemmThreads, 0, st>>>(A, W, out, M, N, K, w_groups);
  else
    simt_gemm_nt_kernel<false, TA><<<grid, kGemmThreads, 0, st>>>(A, W, out, M, N, K, w_groups);
  return (int)cudaGetLastError();
}

}  // namespace
