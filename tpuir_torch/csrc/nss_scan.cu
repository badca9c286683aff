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
// and pooled[b, k, d] is the sum of y over the path.
//
// What bounds it on this card. At MaIR-CDN@128, batch 8 (L = 16,384
// positions, D = 234 channels, N = 16 states, R = 12): the function must
// read x (123 MB) and write y (491 MB), 0.18 ms at 3.35 TB/s; it does
// 1.96 G state updates, each an exponential and about six float32
// operations, plus 13.7 GFLOP of projections: about 25 GFLOP, 0.38 ms at
// the 67 TFLOP/s float32 peak. Bound by operations, and by the chain of
// 16,384 dependent steps of each of the B*K*D = 7,488 recurrences.
//
// What the design does about it, kept simple for a first correct kernel:
//   * x_dbl depends only on (pixel, k), not on the path, so it is one SIMT
//     GEMM over all pixels first (x . W_xp^T, 4*(R+2N) columns); dt is
//     recomputed from it inside the scan (R FMAs a channel), never stored.
//   * The sequence is cut into chunks of 256 positions, so the recurrences
//     fill the card (B*K*D*chunks threads) instead of walking 16k steps in
//     7,488 threads: (1) each chunk is scanned from a zero state, keeping
//     only its end state and its decay product per (d, n); (2) a short pass
//     chains those carries in chunk order; (3) each chunk is scanned again
//     from its true initial state, now writing y and the chunk's partial sum
//     of y; (4) the partials are summed in chunk order. No float atomics:
//     the result is the same bit for bit on every run.
//   * A block is 128 channels of one (image, direction, chunk), a thread one
//     channel with its N states in registers. x and y are read and written
//     through the id table: at each step the block's threads touch 128
//     consecutive channels of one pixel, so the gather and the scatter
//     coalesce. The path's x_dbl rows are staged in shared memory 32
//     positions at a time, with W_dt transposed there (conflict-free).
//   * The TPU kernel's stripe block maps, half-block L/R buffers, serpentine
//     static slices, x^T frames, lane padding and VMEM segments exist to
//     avoid gathers on the TPU and have no counterpart here.
//
// C interface (ctypes, no PyTorch headers): launches go on the caller's
// stream, nothing is allocated or synchronised, the first cudaError_t met
// is returned (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "simt_gemm.cuh"

namespace {

constexpr int kK = 4;            // directions
constexpr int kChunk = 256;      // positions a chunk
constexpr int kScanThreads = 128;
constexpr int kPosTile = 32;     // path positions staged in shared memory at a time
constexpr int kMaxState = 16;
constexpr int kMaxRank = 64;

__device__ __forceinline__ float softplus(float v) {
  // log(1 + exp(v)) as jax.nn.softplus: max(v, 0) + log1p(exp(-|v|))
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

struct ScanArgs {
  const float* x;      // (B, L, D)
  const int* ids;      // (4, L)
  const float* xdbl;   // (B, L, 4, C), C = R + 2N
  const float* dt_w;   // (4, D, R)
  const float* A;      // (4, D, N), negative
  const float* Dskip;  // (4, D)
  const float* bias;   // (4, D)
  float* y;            // (B, 4, L, D)
  float* hstate;       // (B*4, nchunk, D, N): chunk end states, then initial states
  float* decay;        // (B*4, nchunk, D, N): chunk decay products
  float* partial;      // (B*4, nchunk, D): chunk sums of y
  int L, D, N, R, nchunk;
};

// One pass over a chunk. FINAL = false: from h = 0, store the end state and
// the decay product. FINAL = true: from the chained initial state, store y
// and the chunk's sum of y.
// Grid (ceil(D / 128), nchunk, B*4); dynamic shared memory
// (R*128 + 32*C) floats + 32 ints.
template <bool FINAL>
__global__ void __launch_bounds__(kScanThreads) scan_chunk_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  const int C = a.R + 2 * a.N;
  float* wdt_s = smem;                         // [R][128]
  float* xdbl_s = smem + a.R * kScanThreads;   // [32][C]
  int* ids_s = reinterpret_cast<int*>(xdbl_s + kPosTile * C);

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kScanThreads + tid;
  const int c = blockIdx.y;
  const int bk = blockIdx.z;
  const int b = bk / kK, k = bk - b * kK;
  const bool valid = d < a.D;
  const int N = a.N, R = a.R;

  for (int r = 0; r < R; ++r)
    wdt_s[r * kScanThreads + tid] = valid ? a.dt_w[((long long)k * a.D + d) * R + r] : 0.f;

  const long long kd = (long long)k * a.D + d;
  const long long state = (((long long)bk * a.nchunk + c) * a.D + d) * N;
  float Ak[kMaxState], h[kMaxState], P[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    Ak[n] = (valid && n < N) ? a.A[kd * N + n] : 0.f;
    h[n] = (FINAL && valid && n < N) ? a.hstate[state + n] : 0.f;
    P[n] = 1.f;
  }
  const float bias_d = valid ? a.bias[kd] : 0.f;
  const float D_d = valid ? a.Dskip[kd] : 0.f;
  const float* xb = a.x + (long long)b * a.L * a.D + d;
  float* yb = a.y + (long long)bk * a.L * a.D + d;
  const float* xdbl_b = a.xdbl + (long long)b * a.L * kK * C + k * C;
  const int* ids_k = a.ids + (long long)k * a.L;
  float pool = 0.f;

  const int t0 = c * kChunk;
  const int t1 = min(a.L, t0 + kChunk);
  for (int tt = t0; tt < t1; tt += kPosTile) {
    const int nt = min(kPosTile, t1 - tt);
    __syncthreads();  // the previous tile (and wdt_s on the first) is done with
    if (tid < nt) ids_s[tid] = ids_k[tt + tid];
    __syncthreads();
    for (int e = tid; e < nt * C; e += kScanThreads) {
      const int pos = e / C, cc = e - pos * C;
      xdbl_s[e] = xdbl_b[(long long)ids_s[pos] * kK * C + cc];
    }
    __syncthreads();
    if (!valid) continue;
    for (int p = 0; p < nt; ++p) {
      const long long pix = ids_s[p];
      const float* xd = xdbl_s + p * C;
      const float u = xb[pix * a.D];
      float dr = bias_d;
      for (int r = 0; r < R; ++r) dr = fmaf(wdt_s[r * kScanThreads + tid], xd[r], dr);
      const float dt = softplus(dr);
      const float du = dt * u;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n) {
        if (n < N) {
          const float decay = expf(dt * Ak[n]);
          h[n] = fmaf(decay, h[n], du * xd[R + n]);
          if (FINAL)
            yv = fmaf(xd[R + N + n], h[n], yv);
          else
            P[n] *= decay;
        }
      }
      if (FINAL) {
        yv = fmaf(D_d, u, yv);
        yb[pix * a.D] = yv;
        pool += yv;
      }
    }
  }
  if (!valid) return;
  if (FINAL) {
    a.partial[((long long)bk * a.nchunk + c) * a.D + d] = pool;
  } else {
#pragma unroll
    for (int n = 0; n < kMaxState; ++n) {
      if (n < N) {
        a.hstate[state + n] = h[n];
        a.decay[state + n] = P[n];
      }
    }
  }
}

// Chain the chunk carries in chunk order, one thread a (b, k, d, n):
// hstate[c] becomes the state entering chunk c.
__global__ void __launch_bounds__(256) chain_carries_kernel(float* __restrict__ hstate,
                                                            const float* __restrict__ decay,
                                                            long long BK, int nchunk, int DN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BK * DN) return;
  const long long bk = i / DN;
  const int e = (int)(i - bk * DN);
  float carry = 0.f;
  for (int c = 0; c < nchunk; ++c) {
    const long long off = (bk * nchunk + c) * DN + e;
    const float h_end = hstate[off];
    hstate[off] = carry;
    carry = fmaf(decay[off], carry, h_end);
  }
}

// pooled[bk, d] = sum over chunks, in chunk order, of partial[bk, c, d].
__global__ void __launch_bounds__(256) sum_partials_kernel(const float* __restrict__ partial,
                                                           float* __restrict__ pooled,
                                                           long long BK, int nchunk, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BK * D) return;
  const long long bk = i / D;
  const int d = (int)(i - bk * D);
  float s = 0.f;
  for (int c = 0; c < nchunk; ++c) s += partial[(bk * nchunk + c) * D + d];
  pooled[i] = s;
}

}  // namespace

extern "C" {

// Floats of scratch tpuir_nss_scan_f32 needs: x_dbl, the chunk states and
// decay products, the chunk partial sums.
long long tpuir_nss_scan_scratch_numel(int B, int L, int D, int N, int R) {
  const long long nchunk = (L + kChunk - 1) / kChunk;
  const long long bk = (long long)B * kK;
  return (long long)B * L * kK * (R + 2 * N) + 2 * bk * nchunk * D * N + bk * nchunk * D;
}

// x (B, L, D) float32, pixels row-major; ids (4, L) int32, a permutation of
// 0..L-1 per direction; x_proj_w (4, R + 2N, D); dt_w (4, D, R); A (4, D, N)
// (= -exp(A_logs)); Dskip, bias (4, D). Outputs y (B, 4, L, D) in image
// order and pooled (B, 4, D). N <= 16, R <= 64.
int tpuir_nss_scan_f32(const float* x, const int* ids, const float* x_proj_w, const float* dt_w,
                       const float* A, const float* Dskip, const float* bias, float* y,
                       float* pooled, float* scratch, int B, int L, int D, int N, int R,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || L <= 0 || D <= 0 || N <= 0 || N > kMaxState || R <= 0 || R > kMaxRank)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int C = R + 2 * N;
  const int nchunk = (L + kChunk - 1) / kChunk;
  const long long BK = (long long)B * kK;
  float* xdbl = scratch;
  float* hstate = xdbl + M * kK * C;
  float* decay = hstate + BK * nchunk * D * N;
  float* partial = decay + BK * nchunk * D * N;

  // 0. x_dbl for every pixel and direction: (B*L, D) . (4*C, D)^T
  int err = launch_simt_gemm(x, D, x_proj_w, (int)M, kK * C, D, StoreRows{xdbl, kK * C}, st);
  if (err) return err;

  ScanArgs a{x, ids, xdbl, dt_w, A, Dskip, bias, y, hstate, decay, partial, L, D, N, R, nchunk};
  const dim3 grid((D + kScanThreads - 1) / kScanThreads, nchunk, (unsigned)BK);
  const size_t smem = (size_t)(R * kScanThreads + kPosTile * C) * sizeof(float) +
                      kPosTile * sizeof(int);
  // 1. chunk end states and decay products from a zero state
  scan_chunk_kernel<false><<<grid, kScanThreads, smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  // 2. states entering each chunk
  const long long chains = BK * D * N;
  chain_carries_kernel<<<(unsigned)((chains + 255) / 256), 256, 0, st>>>(hstate, decay, BK,
                                                                         nchunk, D * N);
  if ((err = (int)cudaGetLastError())) return err;
  // 3. y and the chunk sums of y from the true initial states
  scan_chunk_kernel<true><<<grid, kScanThreads, smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  // 4. pooled sums in chunk order
  const long long outs = BK * D;
  sum_partials_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(partial, pooled, BK, nchunk,
                                                                      D);
  return (int)cudaGetLastError();
}

}  // extern "C"
