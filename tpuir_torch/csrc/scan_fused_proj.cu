// K3: MaIR's selective scan with fused projections, on sequences already
// gathered along the four NSS paths, in float32 on Hopper (sm_90a),
// hand-written.
//
// Replaces: tpuir/ops/scan_pallas.py:_fused_forward (the Pallas TPU
// kernels _make_fused_kernel_vert / _make_fused_kernel, via
// selective_scan_fused_proj). MaIR takes it on a pyramid level whose H or W
// is not a multiple of scan_len, where the stripe kernel (K2) does not
// apply: the mixer gathers x into xs (B, 4, L, D) by the scan ids and
// scatters y back itself. Same math, per image b, direction k, position t:
//   x_dbl = W_xp[k] . xs[b, k, t]                (R + 2N values)
//   dt    = softplus(W_dt[k] . x_dbl[:R] + bias[k])   per channel d
//   h_t   = exp(dt * A[k]) * h_{t-1} + dt * x_dbl[R:R+N] * xs[b, k, t]
//   y     = x_dbl[R+N:] . h_t + D[k] * xs[b, k, t]
// y (B, 4, L, D) in sequence order; no pooled output, as in the TPU kernel.
// d_state N <= 32 (MaIRUNet's latent level has 32).
//
// What bounds it on this card. At MaIRUNet's latent level of a 481x321
// request (two 48x41 tiles, D = 768, N = 32, R = 24; B*4*L = 15,744
// sequence positions): the function must read xs and write y, 97 MB,
// 0.03 ms at 3.35 TB/s; the projections and the 387 M state updates are
// about 5.5 GFLOP, 0.08 ms at the 67 TFLOP/s float32 peak. The passes
// take two exponentials a state update on the MUFU pipe (chunk_scan.cuh),
// 0.19 ms at the measured exp2 rate; the 1,968 dependent steps of each of
// the B*4*D = 6,144 recurrences leave the card a few chunks of work each.
//
// What the design does about it:
//   * x_dbl is one batched SIMT GEMM (simt_gemm.cuh), B*4 products of
//     (L, D) . (C, D)^T, each direction with its own weight (grid.z).
//   * The scan is chunk_scan.cuh's three passes on SequencePath, the same
//     code as K2's: 256-position chunks from a zero state, the carries
//     chained in chunk order, the chunks rescanned from their true states.
//     No float atomics: the output repeats bit for bit.
//   * The TPU kernel's padding of D to 128 lanes and of L to the chunk, and
//     its (S, P) vertical schedule of the chunk, are TPU layouts with no
//     counterpart here: the kernels mask the ragged channel block and the
//     ragged last chunk themselves.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"
#include "simt_gemm.cuh"

extern "C" {

// Floats of scratch tpuir_scan_fused_proj_f32 needs: x_dbl, the chunk
// states and decay products.
long long tpuir_scan_fused_proj_scratch_numel(int B, int L, int D, int N, int R) {
  const long long bk = (long long)B * kK;
  return bk * L * (R + 2 * N) + chunk_state_numel(bk, L, D, N);
}

// xs (B, 4, L, D) float32 in sequence order; x_proj_w (4, R + 2N, D);
// dt_w (4, D, R); A (4, D, N) (= -exp(A_logs)); Dskip, bias (4, D). Output
// y (B, 4, L, D). N <= 32, R <= 64.
int tpuir_scan_fused_proj_f32(const float* xs, const float* x_proj_w, const float* dt_w,
                              const float* A, const float* Dskip, const float* bias, float* y,
                              float* scratch, int B, int L, int D, int N, int R, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank)
    return (int)cudaErrorInvalidValue;
  const long long BK = (long long)B * kK;
  if (BK * L > 0x7fffffffLL || BK > 65535) return (int)cudaErrorInvalidValue;
  const int C = R + 2 * N;
  const int nchunk = chunk_count(L);
  float* xdbl = scratch;
  float* hstate = xdbl + BK * L * C;
  float* decay = hstate + BK * nchunk * D * N;

  // 0. x_dbl of every sequence position: xs[b, k] (L, D) . x_proj_w[k]^T,
  //    a batch of B*4 products cycling through the 4 directions' weights
  int err = launch_simt_gemm(xs, D, x_proj_w, L, C, D, StoreRows{xdbl, C}, st, (int)BK, kK);
  if (err) return err;

  // 1-3. the chunked scan in sequence order
  const ChunkScanArgs a{xs, nullptr, xdbl, dt_w, A, Dskip, bias, y, hstate, decay, nullptr,
                        L, D, N, R, nchunk};
  return run_chunk_scan<SequencePath>(a, BK, st);
}

}  // extern "C"
