// The measurement entry points of the tensor-core GEMM core (tc_gemm.cuh):
// the core alone in 3xTF32 (float32 parity), with its LayerNorm prologue and
// its row store (with an optional residual), and its bf16-operand kernel, so
// that their accuracy and rate can be held against float64 and torch.matmul
// at the shapes of K1's, K6's and K7's products. The port's main paths reach
// the core through those kernels, never through this.
//
// C interface (ctypes, no PyTorch headers): the launch goes on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met is
// returned (0 = success).

#include <cuda_runtime.h>

#include "tc_gemm.cuh"

namespace {

int tc_gemm(const float* a, long long a_batch, int lda, const float* w, long long w_batch,
            const float* resid, float* out, int ldo, const float* ln_stats, const float* ln_w,
            const float* ln_b, int ln_sub_mean, int batch, int M, int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ldo < N) return (int)cudaErrorInvalidValue;
  const tc::Args p{a, a_batch, lda, w, w_batch, M, N, K};
  const tc::StoreOut epi{out, resid, ldo, tc::pairs_aligned(out, resid, ldo)};
  if (ln_w) {
    const tc::LnPrologue ln{reinterpret_cast<const float2*>(ln_stats), ln_w, ln_b, ln_sub_mean};
    return tc::launch_tc_gemm(p, batch, ln, epi, st);
  }
  return tc::launch_tc_gemm(p, batch, tc::NoPrologue{}, epi, st);
}

}  // namespace

extern "C" {

// out[z*M + m, n] (row stride ldo) = resid[same] + sum_k A'[z, m, k] * w[z, n, k]
// for z < batch: A row-major with row stride lda, image z at a + z*a_batch;
// w (N, K) row-major, image z at w + z*w_batch (0: one weight); resid may be
// null. A' = A, or with ln_w set the LayerNorm (A - mu) * rstd * ln_w + ln_b
// (ln_sub_mean 1) or A * rstd * ln_w (ln_sub_mean 0, ln_b null), row r's
// (mu, rstd) at ln_stats[2r], ln_stats[2r + 1] (8-byte aligned), r = z*M + m.
int tpuir_tc_gemm_f32(const float* a, long long a_batch, int lda, const float* w,
                      long long w_batch, const float* resid, float* out, int ldo,
                      const float* ln_stats, const float* ln_w, const float* ln_b,
                      int ln_sub_mean, int batch, int M, int N, int K, void* stream) {
  return tc_gemm(a, a_batch, lda, w, w_batch, resid, out, ldo, ln_stats, ln_w, ln_b, ln_sub_mean,
                 batch, M, N, K, stream);
}

// The bf16-operand kernel (K1's serving body's apply, projection and
// project_out, K7's serving out_proj): a and w bf16 as stored, float32 sums,
// a float32 output; K, lda and the batch strides multiples of 8, a and w
// 16-byte aligned.
int tpuir_tc_gemm_bf16_operands(const __nv_bfloat16* a, long long a_batch, int lda,
                                const __nv_bfloat16* w, long long w_batch, const float* resid,
                                float* out, int ldo, int batch, int M, int N, int K,
                                void* stream) {
  if (ldo < N) return (int)cudaErrorInvalidValue;
  const tc::ArgsBf16 p{a, a_batch, lda, w, w_batch, M, N, K};
  const tc::StoreOut epi{out, resid, ldo, tc::pairs_aligned(out, resid, ldo)};
  return tc::launch_tc_gemm_bf16(p, batch, epi, (cudaStream_t)stream);
}

}  // extern "C"
