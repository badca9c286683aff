// The chunked selective scan of MaIR's mixer in float32 on Hopper (sm_90a),
// shared by K2 (nss_scan.cu) and K3 (scan_fused_proj.cu).
//
// Per image b, direction k in 0..3 and channel d, over the L positions t of
// the direction's path, with u the position's input and x_dbl = [dt_r (R) |
// B (N) | C (N)] its projection row (the caller's GEMM writes x_dbl first):
//   dt  = softplus(W_dt[k, d] . dt_r + bias[k, d])
//   h_t = exp(dt * A[k, d, n]) * h_{t-1} + dt * B[n] * u     n < N
//   y   = C . h_t + D[k, d] * u
//
// The sequence is cut into chunks of 256 positions, so that the recurrences
// fill the card (B*4*D*chunks threads) instead of walking L steps in B*4*D
// threads: (1) each chunk is scanned from a zero state, keeping only its
// end state and its decay product per (d, n); (2) a short pass chains those
// carries in chunk order; (3) each chunk is scanned again from its true
// initial state, now writing y (and, for K2, the chunk's partial sum of y);
// (4) K2 sums the partials in chunk order itself. No float atomics: the
// result is the same bit for bit on every run.
//
// A block is 128 channels of one (image, direction, chunk), a thread one
// channel with its states in registers: MAXN of them, a compile-time
// ceiling of 8, 16 or 32 picked per call from N, so that d_state 4 does not
// pay for 32 registers an array; the n < N predicate keeps any N up to the
// ceiling. The positions' x_dbl rows are staged in shared memory 32 at a
// time, with W_dt transposed there (conflict-free). At each step the
// block's threads touch 128 consecutive channels of one position, so the
// reads of x and the writes of y coalesce.
//
// The two callers differ only in where a position's data lives (the Path
// template argument):
//   ImageIdsPath (K2): position t of direction k is image pixel
//     p = ids[k][t]; x (B, L, D) and y (B, 4, L, D) are in image order,
//     x_dbl (B, L, 4, C) pixel-major (one GEMM over all pixels).
//   SequencePath (K3): x, y (B, 4, L, D) and x_dbl (B, 4, L, C) are in
//     sequence order, already gathered by the caller.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kK = 4;            // directions
constexpr int kChunk = 256;      // positions a chunk
constexpr int kScanThreads = 128;
constexpr int kPosTile = 32;     // positions staged in shared memory at a time
constexpr int kMaxState = 32;
constexpr int kMaxRank = 64;

struct ImageIdsPath {
  static constexpr bool kIds = true;
};
struct SequencePath {
  static constexpr bool kIds = false;
};

__device__ __forceinline__ float softplus(float v) {
  // log(1 + exp(v)) as jax.nn.softplus: max(v, 0) + log1p(exp(-|v|))
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

struct ChunkScanArgs {
  const float* x;      // ImageIdsPath (B, L, D); SequencePath (B, 4, L, D)
  const int* ids;      // (4, L): ImageIdsPath only
  const float* xdbl;   // ImageIdsPath (B, L, 4, C); SequencePath (B, 4, L, C); C = R + 2N
  const float* dt_w;   // (4, D, R)
  const float* A;      // (4, D, N), negative
  const float* Dskip;  // (4, D)
  const float* bias;   // (4, D)
  float* y;            // (B, 4, L, D)
  float* hstate;       // (B*4, nchunk, D, N): chunk end states, then initial states
  float* decay;        // (B*4, nchunk, D, N): chunk decay products
  float* partial;      // (B*4, nchunk, D): chunk sums of y, ImageIdsPath only
  int L, D, N, R, nchunk;
};

// One pass over a chunk. FINAL = false: from h = 0, store the end state and
// the decay product. FINAL = true: from the chained initial state, store y
// (and, on ImageIdsPath, the chunk's sum of y).
// Grid (ceil(D / 128), nchunk, B*4); dynamic shared memory
// (R*128 + 32*C) floats + 32 ints.
template <bool FINAL, int MAXN, class Path>
__global__ void __launch_bounds__(kScanThreads) scan_chunk_kernel(ChunkScanArgs a) {
  extern __shared__ float smem[];
  const int C = a.R + 2 * a.N;
  float* wdt_s = smem;                         // [R][128]
  float* xdbl_s = smem + a.R * kScanThreads;   // [32][C]
  int* rows_s = reinterpret_cast<int*>(xdbl_s + kPosTile * C);

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kScanThreads + tid;
  const int c = blockIdx.y;
  const int bk = blockIdx.z;
  const int b = bk / kK, k = bk - b * kK;
  const bool valid = d < a.D;
  const int N = a.N, R = a.R;
  const long long L = a.L;

  for (int r = 0; r < R; ++r)
    wdt_s[r * kScanThreads + tid] = valid ? a.dt_w[((long long)k * a.D + d) * R + r] : 0.f;

  const long long kd = (long long)k * a.D + d;
  const long long state = (((long long)bk * a.nchunk + c) * a.D + d) * N;
  float Ak[MAXN], h[MAXN], P[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    Ak[n] = (valid && n < N) ? a.A[kd * N + n] : 0.f;
    h[n] = (FINAL && valid && n < N) ? a.hstate[state + n] : 0.f;
    P[n] = 1.f;
  }
  const float bias_d = valid ? a.bias[kd] : 0.f;
  const float D_d = valid ? a.Dskip[kd] : 0.f;
  // Row r of a position: the image pixel (ImageIdsPath) or the position
  // itself (SequencePath). x_dbl row r of this (b, k) is at xdbl_b + r * stride.
  const float* xb = a.x + (Path::kIds ? (long long)b : (long long)bk) * L * a.D + d;
  float* yb = a.y + (long long)bk * L * a.D + d;
  const float* xdbl_b = Path::kIds ? a.xdbl + (long long)b * L * kK * C + k * C
                                   : a.xdbl + (long long)bk * L * C;
  const int xdbl_stride = Path::kIds ? kK * C : C;
  float pool = 0.f;

  const int t0 = c * kChunk;
  const int t1 = min(a.L, t0 + kChunk);
  for (int tt = t0; tt < t1; tt += kPosTile) {
    const int nt = min(kPosTile, t1 - tt);
    __syncthreads();  // the previous tile (and wdt_s on the first) is done with
    if (tid < nt) rows_s[tid] = Path::kIds ? a.ids[k * L + tt + tid] : tt + tid;
    __syncthreads();
    for (int e = tid; e < nt * C; e += kScanThreads) {
      const int pos = e / C, cc = e - pos * C;
      xdbl_s[e] = xdbl_b[(long long)rows_s[pos] * xdbl_stride + cc];
    }
    __syncthreads();
    if (!valid) continue;
    for (int p = 0; p < nt; ++p) {
      const long long row = rows_s[p];
      const float* xd = xdbl_s + p * C;
      const float u = xb[row * a.D];
      float dr = bias_d;
      for (int r = 0; r < R; ++r) dr = fmaf(wdt_s[r * kScanThreads + tid], xd[r], dr);
      const float dt = softplus(dr);
      const float du = dt * u;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
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
        yb[row * a.D] = yv;
        if (Path::kIds) pool += yv;
      }
    }
  }
  if (!valid) return;
  if (FINAL) {
    if (Path::kIds) a.partial[((long long)bk * a.nchunk + c) * a.D + d] = pool;
  } else {
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < N) {
        a.hstate[state + n] = h[n];
        a.decay[state + n] = P[n];
      }
    }
  }
}

// Chain the chunk carries in chunk order, one thread a (b, k, d, n):
// hstate[c] becomes the state entering chunk c. (Templated on the path only
// so that a profile tells K2's launches from K3's.)
template <class Path>
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

inline int chunk_count(int L) { return (L + kChunk - 1) / kChunk; }

// Floats of the chunk states and decay products for B*4 = BK sequences.
inline long long chunk_state_numel(long long BK, int L, int D, int N) {
  return 2 * BK * chunk_count(L) * D * N;
}

template <int MAXN, class Path>
int launch_chunk_passes(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  const dim3 grid((a.D + kScanThreads - 1) / kScanThreads, a.nchunk, (unsigned)BK);
  const int C = a.R + 2 * a.N;
  const size_t smem = (size_t)(a.R * kScanThreads + kPosTile * C) * sizeof(float) +
                      kPosTile * sizeof(int);
  int err;
  if (smem > 48 * 1024) {  // R = 64 with N = 32 just passes the default 48 KB
    if ((err = (int)cudaFuncSetAttribute(scan_chunk_kernel<false, MAXN, Path>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    if ((err = (int)cudaFuncSetAttribute(scan_chunk_kernel<true, MAXN, Path>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
  }
  // 1. chunk end states and decay products from a zero state
  scan_chunk_kernel<false, MAXN, Path><<<grid, kScanThreads, smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  // 2. states entering each chunk
  const long long chains = BK * a.D * a.N;
  chain_carries_kernel<Path><<<(unsigned)((chains + 255) / 256), 256, 0, st>>>(
      a.hstate, a.decay, BK, a.nchunk, a.D * a.N);
  if ((err = (int)cudaGetLastError())) return err;
  // 3. y (and the chunk sums of y) from the true initial states
  scan_chunk_kernel<true, MAXN, Path><<<grid, kScanThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Passes 1-3 for BK = B*4 sequences, with the register ceiling picked from N
// (1 <= N <= kMaxState, checked by the caller).
template <class Path>
int run_chunk_scan(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  if (a.N <= 8) return launch_chunk_passes<8, Path>(a, BK, st);
  if (a.N <= 16) return launch_chunk_passes<16, Path>(a, BK, st);
  return launch_chunk_passes<32, Path>(a, BK, st);
}

}  // namespace
