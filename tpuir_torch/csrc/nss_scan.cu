// K2: MaIR's four-direction NSS selective scan in float32 on Hopper
// (sm_90a), hand-written, with its projections.
//
// Replaces: tpuir/ops/nss_stripe.py:_forward_core (square tiles, via
// nss_scan_stripe_pre / nss_scan_stripe) and :_launch_single (rectangular
// tiles): one kernel here covers both. Same math. For each image b,
// direction k in 0..3 and position t of the NSS path, with p = ids[k][t]
// the image pixel the path visits at t (tpuir_torch/ops/scan_ids.py, the
// shifted variant being just another table):
//   x_dbl = W_xp[k] . x[b, p]                    (R + 2N values)
//   dt    = softplus(W_dt[k] . x_dbl[:R] + bias[k])   per channel d
//   h_t   = exp(dt * A[k]) * h_{t-1} + dt * x_dbl[R:R+N] * x[b, p]   per (d, n)
//   y     = x_dbl[R+N:] . h_t + D[k] * x[b, p]
// y is written to image position p of direction k's output (B, 4, H, W, D),
// and pooled[b, k, d] is the sum of y over the path. d_state N <= 32.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (L = 16,384
// positions, D = 234 channels, N = 16 states, R = 12): the function must
// read x (123 MB) and write y (491 MB), 0.18 ms at 3.35 TB/s; it does
// 1.96 G state updates, each an exponential and about six float32
// operations, plus 13.7 GFLOP of projections: about 25 GFLOP, 0.38 ms at
// the 67 TFLOP/s float32 peak. The three-pass chunked scan that spreads
// the 16,384 dependent steps of each of the B*K*D = 7,488 recurrences over
// the card takes two exponentials a state update, one a pass, on the MUFU
// pipe (16 lanes an SM against 128 float32 lanes): its floor is 0.95 ms at
// the measured exp2 rate, and the passes are bound by that pipe
// (chunk_scan.cuh).
//
// What the design does about it:
//   * x_dbl depends only on (pixel, k), not on the path, so it is one SIMT
//     GEMM over all pixels first (x . W_xp^T, 4*(R+2N) columns); dt is
//     recomputed from it inside the scan (R FMAs a channel), never stored.
//   * The scan is chunk_scan.cuh's three passes on ImageIdsPath: x and y are
//     read and written through the id table, a block's channels of one
//     pixel a step, so the gather and the scatter coalesce; one MUFU.EX2 a
//     state update a pass, x_dbl rows staged ahead by cp.async and x loaded
//     ahead. A fourth launch here sums the chunks' partial sums of y in
//     chunk order.
//   * The TPU kernel's stripe block maps, half-block L/R buffers, serpentine
//     static slices, x^T frames, lane padding and VMEM segments exist to
//     avoid gathers on the TPU and have no counterpart here.
//
// The serving body (tpuir_nss_scan_bf16; the TPU kernel with serving=True)
// is the same launches on bf16 x and y: x_proj takes x widened and W_xp
// rounded to bf16 at load (simt_gemm.cuh), so x_dbl is the float32 sum of
// exact bf16 products and stays float32 in scratch; the scan runs on
// ImageIdsBf16Path (chunk_scan.cuh), which rounds dt_proj's operands (the
// dt columns of x_dbl and W_dt) in shared memory, keeps B, C, softplus,
// the recurrence and D*x in float32, stores y rounded to nearest even and
// sums pooled from the float32 y. Halving x's and y's bytes moves little:
// the scan is bound by its exponentials, not its bytes.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "simt_gemm.cuh"

extern "C" {

// Floats of scratch tpuir_nss_scan_f32 needs: x_dbl, the chunk states and
// decay products, the chunk partial sums.
long long tpuir_nss_scan_scratch_numel(int B, int L, int D, int N, int R) {
  const long long bk = (long long)B * kK;
  return (long long)B * L * kK * (R + 2 * N) + chunk_state_numel(bk, L, D, N) +
         bk * chunk_count(L) * D;
}

}  // extern "C"

namespace {

template <class Path>
int nss_scan(const typename Path::io_t* x, const int* ids, const float* x_proj_w,
             const float* dt_w, const float* A, const float* Dskip, const float* bias,
             typename Path::io_t* y, float* pooled, float* scratch, int B, int L, int D, int N,
             int R, cudaStream_t st) {
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int C = R + 2 * N;
  const int nchunk = chunk_count(L);
  const long long BK = (long long)B * kK;
  float* xdbl = scratch;
  float* hstate = xdbl + M * kK * C;
  float* decay = hstate + BK * nchunk * D * N;
  float* partial = decay + BK * nchunk * D * N;

  // 0. x_dbl for every pixel and direction: (B*L, D) . (4*C, D)^T
  int err = launch_simt_gemm(x, x_proj_w, xdbl, (int)M, kK * C, D, st);
  if (err) return err;

  // 1-3. the chunked scan through the id table
  const ChunkScanArgs a{x, ids, xdbl, dt_w, A, Dskip, bias, y, hstate, decay, partial,
                        L, D, N, R, nchunk};
  if ((err = run_chunk_scan<Path>(a, BK, st))) return err;
  // 4. pooled sums in chunk order
  return launch_sum_partials<Path>(partial, pooled, BK, nchunk, D, st);
}

}  // namespace

extern "C" {

// x (B, L, D) float32, pixels row-major; ids (4, L) int32, a permutation of
// 0..L-1 per direction; x_proj_w (4, R + 2N, D); dt_w (4, D, R); A (4, D, N)
// (= -exp(A_logs)); Dskip, bias (4, D). Outputs y (B, 4, L, D) in image
// order and pooled (B, 4, D). N <= 32, R <= 64.
int tpuir_nss_scan_f32(const float* x, const int* ids, const float* x_proj_w, const float* dt_w,
                       const float* A, const float* Dskip, const float* bias, float* y,
                       float* pooled, float* scratch, int B, int L, int D, int N, int R,
                       void* stream) {
  return nss_scan<ImageIdsPath>(x, ids, x_proj_w, dt_w, A, Dskip, bias, y, pooled, scratch, B,
                                L, D, N, R, (cudaStream_t)stream);
}

// The serving body: x and y bf16, the weights float32 as tpuir_nss_scan_f32
// takes them (rounded to bf16 where they are products' operands), pooled
// float32; the same scratch.
int tpuir_nss_scan_bf16(const __nv_bfloat16* x, const int* ids, const float* x_proj_w,
                        const float* dt_w, const float* A, const float* Dskip, const float* bias,
                        __nv_bfloat16* y, float* pooled, float* scratch, int B, int L, int D,
                        int N, int R, void* stream) {
  return nss_scan<ImageIdsBf16Path>(x, ids, x_proj_w, dt_w, A, Dskip, bias, y, pooled, scratch,
                                    B, L, D, N, R, (cudaStream_t)stream);
}

}  // extern "C"
