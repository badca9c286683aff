// The chunked selective scan of MaIR's mixer in float32 on Hopper (sm_90a),
// shared by K2 (nss_scan.cu), K3 (scan_fused_proj.cu), K5 (nss_fused.cu)
// and K4 (selective_scan.cu).
//
// Per sequence bk = (b, k) and channel d, over the L positions t of the
// sequence, with u the position's input:
//   dt  = softplus(W_dt[k, d] . dt_r + bias[k, d])   (K4: delta[t, d] + bias[k, d])
//   h_t = exp(dt * A[k, d, n]) * h_{t-1} + dt * B[n] * u     n < N
//   y   = C . h_t + D[k, d] * u
// where x_dbl = [dt_r (R) | B (N) | C (N)] is the position's projection row
// (the caller's GEMM writes x_dbl first); K4 reads B and C as they are.
//
// The sequence is cut into chunks of 256 positions, so that the recurrences
// fill the card (B*K*D*chunks threads) instead of walking L steps in B*K*D
// threads: (1) each chunk is scanned from a zero state, keeping only its
// end state and its decay product per (d, n); (2) a short pass chains those
// carries in chunk order; (3) each chunk is scanned again from its true
// initial state, now writing y (and, for K2 and K5, the chunk's partial sum
// of y); (4) K2 and K5 sum the partials in chunk order. No float atomics:
// the result is the same bit for bit on every run.
//
// A block is 128 channels of one (sequence, chunk), a thread one channel
// with its states in registers: MAXN of them, a compile-time ceiling of 8,
// 16 or 32 picked per call from N, so that d_state 4 does not pay for 32
// registers an array; the n < N predicate keeps any N up to the ceiling.
// The positions' x_dbl rows are staged in shared memory 32 at a time, with
// W_dt transposed there (conflict-free). At each step the block's threads
// touch 128 consecutive channels of one position, so the reads of x and the
// writes of y coalesce.
//
// The callers differ only in where a position's data lives (the Path
// template argument):
//   ImageIdsPath (K2): position t of direction k is image pixel
//     p = ids[k][t]; x (B, L, D) and y (B, 4, L, D) are in image order,
//     x_dbl (B, L, 4, C) pixel-major (one GEMM over all pixels).
//   SequencePath (K3): x, y (B, 4, L, D) and x_dbl (B, 4, L, C) are in
//     sequence order, already gathered by the caller.
//   StripePath (K5): as ImageIdsPath, but the pixel is computed from t
//     (nss_pixel below) instead of read from a table, and directions 2 and
//     3 write y in the transposed (W, H) image layout.
//   DeltaPath (K4): x (the u of mamba's selective_scan_fn), delta and y
//     (B, K, L, D) in sequence order for any K; B and C (B, K, L, N) are
//     staged in place of the x_dbl row (R = 0) and dt comes from delta.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kK = 4;            // directions of MaIR's NSS scan
constexpr int kChunk = 256;      // positions a chunk
constexpr int kScanThreads = 128;
constexpr int kPosTile = 32;     // positions staged in shared memory at a time
constexpr int kMaxState = 32;
constexpr int kMaxRank = 64;

enum class PathKind { kImageIds, kSequence, kStripe, kDelta };

struct ImageIdsPath {
  static constexpr PathKind kKind = PathKind::kImageIds;
};
struct SequencePath {
  static constexpr PathKind kKind = PathKind::kSequence;
};
struct StripePath {
  static constexpr PathKind kKind = PathKind::kStripe;
};
struct DeltaPath {
  static constexpr PathKind kKind = PathKind::kDelta;
};

// x and x_dbl in image order (one row a pixel), y pooled into chunk sums
template <class Path>
constexpr bool kImageRows = Path::kKind == PathKind::kImageIds || Path::kKind == PathKind::kStripe;

__device__ __forceinline__ float softplus(float v) {
  // log(1 + exp(v)) as jax.nn.softplus: max(v, 0) + log1p(exp(-|v|))
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// The cell (i, j) of an Hg x Wg grid that NSS position t visits: vertical
// stripes of width SL (with shift, a lead stripe of width SL/2 first), left
// to right; full stripe s runs bottom-up when s is odd (with shift: even;
// the lead stripe never); within a stripe, odd rows run right to left. The
// last stripe may be narrower. tpuir_torch/ops/scan_ids.py:_nss_flatten
// builds the same path as a table.
__device__ __forceinline__ void nss_cell(int t, int Hg, int Wg, int SL, bool shift, int& i,
                                         int& j) {
  const int half = SL >> 1;
  int r, col0;
  bool flip;
  if (shift && t < Hg * half) {
    r = t;
    col0 = 0;
    flip = false;
  } else {
    const int lead = shift ? Hg * half : 0;
    const int s = (t - lead) / (Hg * SL);
    r = t - lead - s * Hg * SL;
    col0 = (shift ? half : 0) + s * SL;
    flip = (s & 1) != (int)shift;
  }
  const int w = min(SL, (shift && col0 == 0) ? half : Wg - col0);
  const int q = r / w;
  int c = r - q * w;
  if (q & 1) c = w - 1 - c;
  i = flip ? Hg - 1 - q : q;
  j = col0 + c;
}

// Position t of direction k over an H x W image: the pixel it reads (row-major
// in x) and the row it writes in y's direction-k image. Directions 0 and 1
// scan the image, 2 and 3 its transpose (so they write (W, H) images);
// 1 and 3 the 180-degree rotation of those.
__device__ __forceinline__ void nss_pixel(int k, int t, int H, int W, int SL, bool shift,
                                          int& pixel, int& out) {
  const bool tr = k >= 2;
  const int Hg = tr ? W : H, Wg = tr ? H : W;
  int i, j;
  nss_cell(t, Hg, Wg, SL, shift, i, j);
  if (k & 1) {
    i = Hg - 1 - i;
    j = Wg - 1 - j;
  }
  pixel = tr ? j * W + i : i * W + j;
  out = i * Wg + j;
}

struct ChunkScanArgs {
  const float* x;      // ImageIdsPath, StripePath (B, L, D); SequencePath (B, 4, L, D); DeltaPath (B, K, L, D)
  const int* ids;      // (4, L): ImageIdsPath only
  const float* xdbl;   // ImageIdsPath, StripePath (B, L, 4, C); SequencePath (B, 4, L, C); C = R + 2N
  const float* dt_w;   // (4, D, R); not DeltaPath
  const float* A;      // (K, D, N), negative
  const float* Dskip;  // (K, D)
  const float* bias;   // (K, D)
  float* y;            // (B, K, L, D)
  float* hstate;       // (B*K, nchunk, D, N): chunk end states, then initial states
  float* decay;        // (B*K, nchunk, D, N): chunk decay products
  float* partial;      // (B*K, nchunk, D): chunk sums of y, ImageIdsPath and StripePath only
  int L, D, N, R, nchunk;
  // StripePath: the image is H x W (L = H*W), stripes of scan_len, shifted or not
  int H, W, scan_len, shift;
  // DeltaPath: delta (B, K, L, D), Bm and Cm (B, K, L, N), K directions
  const float* delta;
  const float* Bm;
  const float* Cm;
  int K;
};

// One pass over a chunk. FINAL = false: from h = 0, store the end state and
// the decay product. FINAL = true: from the chained initial state, store y
// (and, on image rows, the chunk's sum of y).
// Grid (ceil(D / 128), nchunk, B*K); dynamic shared memory
// (R*128 + 32*C) floats + 64 ints.
template <bool FINAL, int MAXN, class Path>
__global__ void __launch_bounds__(kScanThreads) scan_chunk_kernel(ChunkScanArgs a) {
  constexpr PathKind kind = Path::kKind;
  extern __shared__ float smem[];
  const int C = a.R + 2 * a.N;
  float* wdt_s = smem;                         // [R][128]
  float* xdbl_s = smem + a.R * kScanThreads;   // [32][C]
  int* rows_s = reinterpret_cast<int*>(xdbl_s + kPosTile * C);  // [32] the row read
  int* outs_s = rows_s + kPosTile;             // [32] StripePath: the row written

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kScanThreads + tid;
  const int c = blockIdx.y;
  const int bk = blockIdx.z;
  const int nk = kind == PathKind::kDelta ? a.K : kK;
  const int b = bk / nk, k = bk - b * nk;
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
  // Row r of a position: the image pixel (ImageIdsPath, StripePath) or the
  // position itself (SequencePath, DeltaPath). x_dbl row r of this (b, k)
  // is at xdbl_b + r * stride.
  const float* xb = a.x + (kImageRows<Path> ? (long long)b : (long long)bk) * L * a.D + d;
  const float* deltab = kind == PathKind::kDelta ? a.delta + (long long)bk * L * a.D + d : nullptr;
  float* yb = a.y + (long long)bk * L * a.D + d;
  const float* xdbl_b = kImageRows<Path> ? a.xdbl + (long long)b * L * kK * C + k * C
                                         : a.xdbl + (long long)bk * L * C;
  const int xdbl_stride = kImageRows<Path> ? kK * C : C;
  float pool = 0.f;

  const int t0 = c * kChunk;
  const int t1 = min(a.L, t0 + kChunk);
  for (int tt = t0; tt < t1; tt += kPosTile) {
    const int nt = min(kPosTile, t1 - tt);
    __syncthreads();  // the previous tile (and wdt_s on the first) is done with
    if (tid < nt) {
      if constexpr (kind == PathKind::kImageIds) {
        rows_s[tid] = a.ids[k * L + tt + tid];
      } else if constexpr (kind == PathKind::kStripe) {
        nss_pixel(k, tt + tid, a.H, a.W, a.scan_len, a.shift != 0, rows_s[tid], outs_s[tid]);
      } else {
        rows_s[tid] = tt + tid;
      }
    }
    __syncthreads();
    if constexpr (kind == PathKind::kDelta) {
      // [B (N) | C (N)] of each position (R = 0)
      const long long pos0 = (long long)bk * L + tt;
      for (int e = tid; e < nt * C; e += kScanThreads) {
        const int pos = e / C, cc = e - pos * C;
        xdbl_s[e] = cc < N ? a.Bm[(pos0 + pos) * N + cc] : a.Cm[(pos0 + pos) * N + cc - N];
      }
    } else {
      for (int e = tid; e < nt * C; e += kScanThreads) {
        const int pos = e / C, cc = e - pos * C;
        xdbl_s[e] = xdbl_b[(long long)rows_s[pos] * xdbl_stride + cc];
      }
    }
    __syncthreads();
    if (!valid) continue;
    for (int p = 0; p < nt; ++p) {
      const long long row = rows_s[p];
      const float* xd = xdbl_s + p * C;
      const float u = xb[row * a.D];
      float dr = bias_d;
      if constexpr (kind == PathKind::kDelta) {
        dr += deltab[row * a.D];
      } else {
        for (int r = 0; r < R; ++r) dr = fmaf(wdt_s[r * kScanThreads + tid], xd[r], dr);
      }
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
        if constexpr (kind == PathKind::kStripe)
          yb[(long long)outs_s[p] * a.D] = yv;
        else
          yb[row * a.D] = yv;
        if (kImageRows<Path>) pool += yv;
      }
    }
  }
  if (!valid) return;
  if (FINAL) {
    if (kImageRows<Path>) a.partial[((long long)bk * a.nchunk + c) * a.D + d] = pool;
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
// so that a profile tells the callers' launches apart.)
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

// pooled[bk, d] = sum over chunks, in chunk order, of partial[bk, c, d].
template <class Path>
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

inline int chunk_count(int L) { return (L + kChunk - 1) / kChunk; }

// Floats of the chunk states and decay products for BK sequences.
inline long long chunk_state_numel(long long BK, int L, int D, int N) {
  return 2 * BK * chunk_count(L) * D * N;
}

template <int MAXN, class Path>
int launch_chunk_passes(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  const dim3 grid((a.D + kScanThreads - 1) / kScanThreads, a.nchunk, (unsigned)BK);
  const int C = a.R + 2 * a.N;
  const size_t smem = (size_t)(a.R * kScanThreads + kPosTile * C) * sizeof(float) +
                      2 * kPosTile * sizeof(int);
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

// Passes 1-3 for BK sequences, with the register ceiling picked from N
// (1 <= N <= kMaxState, checked by the caller).
template <class Path>
int run_chunk_scan(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  if (a.N <= 8) return launch_chunk_passes<8, Path>(a, BK, st);
  if (a.N <= 16) return launch_chunk_passes<16, Path>(a, BK, st);
  return launch_chunk_passes<32, Path>(a, BK, st);
}

// Pass 4 on image rows: pooled (BK, D) from the chunk partials in chunk order.
template <class Path>
int launch_sum_partials(const float* partial, float* pooled, long long BK, int nchunk, int D,
                        cudaStream_t st) {
  const long long outs = BK * D;
  sum_partials_kernel<Path><<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(partial, pooled, BK,
                                                                           nchunk, D);
  return (int)cudaGetLastError();
}

}  // namespace
