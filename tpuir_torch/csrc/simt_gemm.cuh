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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemmBM = 128, kGemmBN = 48, kGemmBK = 32, kGemmThreads = 256;

// A (batch, M, K), W (w_groups, N, K), out (batch, M, N), all row-major;
// grid (ceil(M / BM), ceil(N / BN), batch).
template <bool VEC4>
__global__ void __launch_bounds__(kGemmThreads) simt_gemm_nt_kernel(
    const float* __restrict__ A, const float* __restrict__ W, float* __restrict__ out, int M,
    int N, int K, int w_groups) {
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
  float4 ra4[VEC4 ? kA : 1], rw4[VEC4 ? kW : 1];
  float ra[VEC4 ? 1 : kA], rw[VEC4 ? 1 : kW];
  float acc[8][3] = {};

  auto fetch = [&](int k0) {
    if constexpr (VEC4) {
      const int k = k0 + lk4;  // K % 4 == 0: the four are in or out together
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int m = m0 + lr + 32 * i;
        ra4[i] = (m < M && k < K) ? *reinterpret_cast<const float4*>(A + (long long)m * K + k)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
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
        ra[i] = (m < M && k < K) ? A[(long long)m * K + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const int n = n0 + lr1 + 8 * i;
        rw[i] = (n < N && k < K) ? W[(long long)n * K + k] : 0.f;
      }
    }
  };
  auto stash = [&](int buf) {
    if constexpr (VEC4) {
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int r = lr + 32 * i;
        As[buf][lk4][r] = ra4[i].x, As[buf][lk4 + 1][r] = ra4[i].y;
        As[buf][lk4 + 2][r] = ra4[i].z, As[buf][lk4 + 3][r] = ra4[i].w;
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const int r = lr + 32 * i;
        if (r < kGemmBN) {
          Ws[buf][lk4][r] = rw4[i].x, Ws[buf][lk4 + 1][r] = rw4[i].y;
          Ws[buf][lk4 + 2][r] = rw4[i].z, Ws[buf][lk4 + 3][r] = rw4[i].w;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kA; ++i) As[buf][lk][lr1 + 8 * i] = ra[i];
#pragma unroll
      for (int i = 0; i < kW; ++i) Ws[buf][lk][lr1 + 8 * i] = rw[i];
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

// out[z] = A[z] . W[z % w_groups]^T for z < batch: A (batch, M, K), W
// (w_groups, N, K) (a torch Linear weight as it is), out (batch, M, N).
inline int launch_simt_gemm(const float* A, const float* W, float* out, int M, int N, int K,
                            cudaStream_t st, int batch = 1, int w_groups = 1) {
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN, (unsigned)batch);
  if (K % 4 == 0 && (((uintptr_t)A | (uintptr_t)W) & 15) == 0)
    simt_gemm_nt_kernel<true><<<grid, kGemmThreads, 0, st>>>(A, W, out, M, N, K, w_groups);
  else
    simt_gemm_nt_kernel<false><<<grid, kGemmThreads, 0, st>>>(A, W, out, M, N, K, w_groups);
  return (int)cudaGetLastError();
}

}  // namespace
