// K4: the plain selective scan (Mamba's S6 recurrence, mamba_ssm's
// selective_scan_fn) in float32 on Hopper (sm_90a), hand-written.
//
// Replaces: tpuir/ops/scan_pallas.py:selective_scan_pallas (the Pallas TPU
// kernel _make_kernel). Same math, per batch b, direction k of K, channel d
// and position t, with delta, B and C given (no projections):
//   dt  = softplus(delta[b, k, t, d] + bias[k, d])
//   h_t = exp(dt * A[k, d]) * h_{t-1} + dt * B[b, k, t] * u[b, k, t, d]   per state n
//   y   = C[b, k, t] . h_t + D[k, d] * u[b, k, t, d]
// u, delta and y are (B, K, L, D), B and C (B, K, L, N), A (K, D, N), D
// and bias (K, D) (the wrapper passes zeros for an absent one, as the JAX
// wrapper does). d_state N <= 32; any K.
//
// What bounds it on this card. At MaIR-CDN's shape (B 8, K 4, L 16,384,
// D 234, N 16): it must read u, delta, B and C and write y, 1.54 GB, 0.46 ms
// at 3.35 TB/s; its 1.96 G state updates of about seven float32 operations
// (an exponential counted as one) are 14.4 GFLOP, 0.21 ms at 67 TFLOP/s.
// Bound by bytes on the data sheet; the three-pass chunked scan that
// spreads the L dependent steps of each of the B*K*D recurrences over the
// card takes two exponentials a state update on the MUFU pipe, 0.95 ms at
// the measured exp2 rate, so its passes are bound by that pipe.
//
// What the design does about it:
//   * chunk_scan.cuh's passes on DeltaPath, the code of K2 and K5:
//     256-position chunks from a zero state, the carries chained in chunk
//     order, the chunks rescanned from their true states, no float atomics
//     (the output repeats bit for bit). u, delta and y are read and written
//     a block's channels a step, coalesced; u, delta and B and C of 16
//     positions are staged ahead by cp.async where the others stage the
//     x_dbl row.
//   * Pass 1 reads u, delta, B and C, and pass 3 reads them again and
//     writes y: about 2.6 GB of traffic for the 1.54 GB the function must
//     move, 0.78 ms at 3.35 TB/s, under the MUFU floor.
//   * The TPU kernel's padding of D to its lane tile and of L to the chunk,
//     its radix-4 Blelloch scan within a chunk and its (K, N, D) transposed
//     A are TPU layouts with no counterpart here.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>

#include "chunk_scan.cuh"

extern "C" {

// Floats of scratch tpuir_selective_scan_f32 needs: the chunk states and
// decay products.
long long tpuir_selective_scan_scratch_numel(int B, int K, int L, int D, int N) {
  return chunk_state_numel((long long)B * K, L, D, N);
}

// u, delta (B, K, L, D) float32; A (K, D, N) (= -exp(A_log)); Bm, Cm
// (B, K, L, N); Dskip, bias (K, D). Output y (B, K, L, D). N <= 32.
int tpuir_selective_scan_f32(const float* u, const float* delta, const float* A, const float* Bm,
                             const float* Cm, const float* Dskip, const float* bias, float* y,
                             float* scratch, int B, int K, int L, int D, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  const long long BK = (long long)B * K;
  if (BK * L > 0x7fffffffLL || BK > 65535) return (int)cudaErrorInvalidValue;
  const int nchunk = chunk_count(L);
  float* hstate = scratch;
  float* decay = hstate + BK * nchunk * D * N;

  ChunkScanArgs a{u, nullptr, nullptr, nullptr, A, Dskip, bias, y, hstate, decay, nullptr,
                  L, D, N, /*R=*/0, nchunk};
  a.delta = delta;
  a.Bm = Bm;
  a.Cm = Cm;
  a.K = K;
  return run_chunk_scan<DeltaPath>(a, BK, st);
}

}  // extern "C"
