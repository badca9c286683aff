// A float32 SIMT GEMM for the MaIR mixer kernels (nss_prologue.cu,
// nss_scan.cu, nss_epilogue.cu, scan_fused_proj.cu): out = A . Wt^T, written
// through an epilogue functor; optionally a batch of such products.
//
// The tile is K1's (fused_block.cu): 64 x 64 outputs a block of 256 threads,
// 4 x 4 a thread, K slices of 16, 128-bit shared-memory reads, the next K
// slice fetched into registers while the current one is multiplied and
// stored into the other half of a double-buffered tile; 16 consecutive
// threads load 64 contiguous bytes of a row. Every load is bounds-checked,
// so M, N, K and the row strides may take any value. Float32 FMA only, no
// tensor cores: parity mode is true float32.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16;

// A is (M, K) row-major with row stride lda; Wt is (N, K) row-major, a
// torch Linear weight as it is. epi(m, n, v) stores output (m, n).
// Batched (gridDim.z products): product z reads rows [z*M, (z+1)*M) of A,
// the weight Wt + (z % w_groups) * N * K, and stores its output row m as
// row z*M + m.
template <class Epi>
__global__ void __launch_bounds__(kGemmThreads) simt_gemm_nt_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ Wt, int M, int N, int K,
    int w_groups, Epi epi) {
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
  __shared__ __align__(16) float Bs[2][kGemmBK][kGemmBN + 4];

  const int z = blockIdx.z;
  A += (long long)z * M * lda;
  Wt += (long long)(z % w_groups) * N * K;
  const int m0 = blockIdx.x * kGemmBM;
  const int n0 = blockIdx.y * kGemmBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns n0 + 4*tx .. +3
  const int ty = tid >> 4;  // output rows    m0 + 4*ty .. +3
  const int lk = tid & (kGemmBK - 1), lr = tid / kGemmBK;
  float ra[4], rb[4];
  float acc[4][4] = {};

  auto fetch = [&](int k0) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + lr + 16 * i;
      ra[i] = (m < M && k < K) ? A[(long long)m * lda + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + lr + 16 * i;
      rb[i] = (n < N && k < K) ? Wt[(long long)n * K + k] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][lk][lr + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[buf][lk][lr + 16 * i] = rb[i];
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
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) epi((long long)z * M + m, n, acc[i][j]);
    }
  }
}

// out[m * ldo + n] = v
struct StoreRows {
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(long long m, int n, float v) const {
    out[m * ldo + n] = v;
  }
};

template <class Epi>
int launch_simt_gemm(const float* A, int lda, const float* Wt, int M, int N, int K, Epi epi,
                     cudaStream_t st, int batch = 1, int w_groups = 1) {
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN, batch);
  simt_gemm_nt_kernel<Epi><<<grid, kGemmThreads, 0, st>>>(A, lda, Wt, M, N, K, w_groups, epi);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

}  // namespace
