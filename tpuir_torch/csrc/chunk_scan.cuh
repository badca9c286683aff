// The chunked selective scan of MaIR's mixer in float32 on Hopper (sm_90a),
// shared by K2 (nss_scan.cu), K5 (nss_fused.cu) and K4 (selective_scan.cu);
// K3 (scan_fused_proj.cu) takes its helpers (exp2_mufu, softplus, and
// scan_widen and scan_round_bf16 for its serving body) and scans its short
// gathered sequences in one pass of its own.
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
// A block is bw channels of one (sequence, chunk), a thread one channel with
// its states in registers: MAXN of them, a compile-time ceiling of 4, 8, 16
// or 32 picked per call from N (states past N are zeros, so any N up to
// the ceiling runs). bw is a multiple of 32 that D fills (96, 192, 256 for
// MaIRUNet's 96, 192, 384, 768 channels and MaIR-CDN's 234), so no warp
// idles. At each step the block's threads touch bw consecutive channels of
// one position, so the reads of x and the writes of y coalesce.
//
// What bounds it on this card: the MUFU pipe and the issue slots. Passes 1
// and 3 each take one exponential a state update, and an SM's MUFU pipe
// does 16 a clock against 128 float32 FMAs (P1 measured exp2 at 4.11
// Telem/s, fma at 31.6): a warp's MUFU.EX2 holds the pipe 8 clocks. Besides
// it an update issues 2 FMUL (dt * A, du * B), the FMA into h, in pass 3 the
// FMA of C . h, and half a shared load: about 6 issue slots a warp, plus a
// position's own work (dt's R-term dot, softplus, u, the y store) over N
// updates. So the passes' floor is 2 * updates / the exp2 rate, 0.95 ms at
// MaIR-CDN@128, batch 8, where the two passes take 2.1 of K2's 2.8 ms
// (each about 2.2 times its half of that floor, on an H100 at 700 W). What
// the design does about it:
//   * a decay is exp2 of one product, A being prescaled by log2(e) once a
//     thread: one MUFU.EX2 (ex2.approx) and one FMUL a state update, no
//     range reduction (exp2_mufu);
//   * softplus takes two MUFUs (exp2, and log2 of 1 + e above e = 1/16,
//     a series below), not expf and log1pf;
//   * dt is computed for a group of four positions at once (four
//     independent chains, W_dt read once for the four), then their updates
//     run, so a position's dt latency does not stall its updates;
//   * the state loop runs to the ceiling MAXN with no branch: B and C are
//     float4 broadcasts from a staged row [dt_r (R4) | B (MAXN) | C (MAXN)]
//     padded with zeros, and states past N stay 0;
//   * pass 1 takes the chunk's decay product as exp2(A2 * sum of dt), one
//     MUFU a state a chunk, instead of a running product;
//   * the positions' x_dbl rows are staged 32 at a time (K4: B, C, u and
//     delta, 16 at a time) in a three-tile ring by cp.async, two tiles
//     ahead, and u is loaded a group ahead into registers, so the serial
//     walk does not wait on a load; one __syncthreads a tile; the chunk's
//     rows are read or computed once, with no division, and offsets inside
//     a sequence are 32-bit from one 64-bit base a block;
//   * C . h runs as two chains of FMAs (even and odd fours of states).

// The callers differ only in where a position's data lives (the Path
// template argument):
//   ImageIdsPath (K2): position t of direction k is image pixel
//     p = ids[k][t]; x (B, L, D) and y (B, 4, L, D) are in image order,
//     x_dbl (B, L, 4, C) pixel-major (one GEMM over all pixels).
//   ImageIdsBf16Path (K2's serving body): as ImageIdsPath, with x read and
//     y stored in bf16 (y rounded to nearest even; the chunk sums of y for
//     pooled taken from the float32 y before it is rounded), and dt_proj's
//     operands rounded to bf16 in shared memory (W_dt where it is staged,
//     each tile's dt columns of x_dbl once the tile has landed), so that
//     each dt product is exact in float32 (the JAX kernel's bf16 x bf16
//     dt_proj). B, C and the scan stay float32.
//   StripePath (K5): as ImageIdsPath, but the pixel is computed from t
//     (nss_pixel below) instead of read from a table, and directions 2 and
//     3 write y in the transposed (W, H) image layout.
//   StripeBf16Path (K5's serving body): StripePath with ImageIdsBf16Path's
//     bf16 x and y, rounded dt_proj operands and pooled from the float32 y.
//   DeltaPath (K4): x (the u of mamba's selective_scan_fn), delta and y
//     (B, K, L, D) in sequence order for any K; B and C (B, K, L, N) are
//     staged in place of the x_dbl row (R = 0) and dt comes from delta.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kK = 4;            // directions of MaIR's NSS scan
constexpr int kChunk = 256;      // positions a chunk
constexpr int kMaxScanThreads = 256;  // the widest channel block
constexpr int kStages = 3;       // tiles in the cp.async ring
constexpr int kGroup = 4;        // positions whose dt is computed together
constexpr int kMaxState = 32;
constexpr int kMaxRank = 64;

enum class PathKind { kImageIds, kStripe, kDelta };

// io_t: the type of x and y in device memory
struct ImageIdsPath {
  static constexpr PathKind kKind = PathKind::kImageIds;
  using io_t = float;
};
struct ImageIdsBf16Path {
  static constexpr PathKind kKind = PathKind::kImageIds;
  using io_t = __nv_bfloat16;
};
struct StripePath {
  static constexpr PathKind kKind = PathKind::kStripe;
  using io_t = float;
};
struct StripeBf16Path {
  static constexpr PathKind kKind = PathKind::kStripe;
  using io_t = __nv_bfloat16;
};
struct DeltaPath {
  static constexpr PathKind kKind = PathKind::kDelta;
  using io_t = float;
};

// x and y in bf16, dt_proj's operands rounded to bf16 (the serving body)
template <class Path>
constexpr bool kBf16Io = std::is_same_v<typename Path::io_t, __nv_bfloat16>;

__device__ __forceinline__ float scan_widen(float v) { return v; }
__device__ __forceinline__ float scan_widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void scan_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void scan_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to bf16 (nearest even), as a float
__device__ __forceinline__ float scan_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x and x_dbl in image order (one row a pixel), y pooled into chunk sums
template <class Path>
constexpr bool kImageRows = Path::kKind == PathKind::kImageIds || Path::kKind == PathKind::kStripe;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x as one MUFU.EX2 (relative error about 2^-22; results below 2^-126
// flush to 0)
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(x) as one MUFU.LG2 (absolute error about 2^-22)
__device__ __forceinline__ float log2_mufu(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(1 + exp(v)) as jax.nn.softplus, max(v, 0) + log1p(e) with
// e = exp(-|v|) in (0, 1], on two MUFUs. Below e = 1/16 (dt under 0.061, the
// common case) log1p(e) is its series to e^6 (relative error under 2^-24/7),
// where the MUFU log of 1 + e would lose up to 1e-4 of it; above, the MUFU
// log of 1 + e is within 3e-6 relative.
__device__ __forceinline__ float softplus(float v) {
  const float e = exp2_mufu(-fabsf(v) * kLog2e);
  float q = fmaf(-e, 1.f / 6.f, 1.f / 5.f);
  q = fmaf(-e, q, 0.25f);
  q = fmaf(-e, q, 1.f / 3.f);
  q = fmaf(-e, q, 0.5f);
  q = fmaf(-e, q, 1.f);
  const float l1p = e < 0.0625f ? e * q : log2_mufu(1.f + e) * kLn2;
  return fmaxf(v, 0.f) + l1p;
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
  const void* x;       // Path::io_t: image paths (B, L, D); DeltaPath (B, K, L, D)
  const int* ids;      // (4, L): ImageIdsPath only
  const float* xdbl;   // ImageIdsPath, StripePath (B, L, 4, C); C = R + 2N
  const float* dt_w;   // (4, D, R); not DeltaPath
  const float* A;      // (K, D, N), negative
  const float* Dskip;  // (K, D)
  const float* bias;   // (K, D)
  void* y;             // Path::io_t (B, K, L, D)
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

// Asynchronous 4-byte copy from device memory to shared memory (cp.async,
// through L1), and its group bookkeeping.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Positions a staged tile: 32, or 16 on DeltaPath, whose tiles also hold
// each channel's u and delta.
__host__ __device__ constexpr int pos_tile(bool delta) { return delta ? 16 : 32; }

// The shared memory of one block of bw channels, in floats: W_dt
// transposed [R4][bw]; a ring of kStages tiles, each pos_tile staged rows
// [dt_r (R4) | B (NP) | C (NP)] (CS floats, R padded to a multiple of 4 and
// N to the ceiling MAXN with zeros, so that B and C are read as aligned
// float4 broadcasts and the state loop has no branch) and,
// on DeltaPath, the tile's u and delta [2][pos_tile][bw]; then the chunk's
// rows read (and, on StripePath, written) [kChunk] as ints.
struct ScanSmem {
  int R4, NP, CS, ring, rows;  // offsets of the ring and the rows, in floats
  __host__ __device__ ScanSmem(int R, int maxn, int bw, bool delta) {
    R4 = (R + 3) & ~3;
    NP = maxn;
    CS = R4 + 2 * NP;
    ring = R4 * bw;
    rows = ring + kStages * pos_tile(delta) * (CS + (delta ? 2 * bw : 0));
  }
  __host__ __device__ size_t bytes(bool stripe) const {
    return ((size_t)rows + (stripe ? 2 : 1) * kChunk) * sizeof(float);
  }
};

// One pass over a chunk. FINAL = false: from h = 0, store the end state and
// the decay product. FINAL = true: from the chained initial state, store y
// (and, on image rows, the chunk's sum of y).
// Grid (ceil(D / bw), nchunk, B*K) of bw = scan_block_width(D) threads;
// dynamic shared memory ScanSmem::bytes. Up to d_state 16 off DeltaPath the
// registers are held to three blocks of 256 an SM (85 a thread; at d_state
// 16 105-108 unbounded): 3-10% faster at MaIR-CDN@128 and MaIRUNet's level
// 3, and at d_state 4-8 9-12% faster than a bound of two blocks. K4
// (DeltaPath, u and delta in its tiles) and d_state 32 take two blocks.
template <bool FINAL, int MAXN, class Path>
__global__ void __launch_bounds__(kMaxScanThreads,
                                  Path::kKind != PathKind::kDelta && MAXN <= 16 ? 3 : 2)
    scan_chunk_kernel(ChunkScanArgs a) {
  constexpr PathKind kind = Path::kKind;
  constexpr bool kDeltaRows = kind == PathKind::kDelta;
  using io_t = typename Path::io_t;
  static_assert(MAXN % 4 == 0, "states go in fours");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = a.N, R = a.R, D = a.D;
  const int bw = blockDim.x;
  const ScanSmem lay(R, MAXN, bw, kDeltaRows);
  const int R4 = lay.R4, NP = lay.NP, CS = lay.CS;
  float* wdt_s = smem;
  float* ring_s = smem + lay.ring;
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);
  int* outs_s = rows_s + kChunk;  // StripePath only
  constexpr int T = pos_tile(kDeltaRows);
  const int stage_floats = T * (CS + (kDeltaRows ? 2 * bw : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = bw >> 5;
  const int d = blockIdx.x * bw + tid;
  const int c = blockIdx.y;
  const int bk = blockIdx.z;
  const int nk = kDeltaRows ? a.K : kK;
  const int b = bk / nk, k = bk - b * nk;
  const bool valid = d < D;
  const int t0 = c * kChunk;
  const int nc = min(kChunk, a.L - t0);  // positions of this chunk
  const int ntiles = (nc + T - 1) / T;

  // One 64-bit base a block; offsets inside a sequence are 32-bit (the
  // caller checks L * max(D, 4C) < 2^31).
  const long long L = a.L;
  const int C = R + 2 * N;
  const io_t* xb = static_cast<const io_t*>(a.x) +
                   (kImageRows<Path> ? (long long)b : (long long)bk) * L * D + d;
  const float* deltab = kDeltaRows ? a.delta + (long long)bk * L * D + d : nullptr;
  io_t* yb = static_cast<io_t*>(a.y) + (long long)bk * L * D + d;
  const float* xdbl_b = kImageRows<Path> ? a.xdbl + (long long)b * L * kK * C + k * C
                                         : a.xdbl + (long long)bk * L * C;
  const int xdbl_stride = kImageRows<Path> ? kK * C : C;
  const float* Bm_b = kDeltaRows ? a.Bm + (long long)bk * L * N : nullptr;
  const float* Cm_b = kDeltaRows ? a.Cm + (long long)bk * L * N : nullptr;

  // the rows of the whole chunk, W_dt, and zeros in the rows' padding
  for (int t = tid; t < nc; t += bw) {
    if constexpr (kind == PathKind::kImageIds) {
      rows_s[t] = a.ids[k * a.L + t0 + t];
    } else if constexpr (kind == PathKind::kStripe) {
      nss_pixel(k, t0 + t, a.H, a.W, a.scan_len, a.shift != 0, rows_s[t], outs_s[t]);
    } else {
      rows_s[t] = t0 + t;
    }
  }
  for (int r = 0; r < R4; ++r) {
    const float w = valid && r < R ? a.dt_w[((long long)k * D + d) * R + r] : 0.f;
    wdt_s[r * bw + tid] = kBf16Io<Path> ? scan_round_bf16(w) : w;
  }
  for (int e = tid; e < lay.rows - lay.ring; e += bw) ring_s[e] = 0.f;
  __syncthreads();

  // Stage tile i (T positions) into ring slot i % kStages with cp.async:
  // warp w copies the rows of positions w, w + nwarps, ..., its lanes along
  // the row; on DeltaPath each thread its own channel's u and delta.
  auto stage = [&](int i) {
    float* xs = ring_s + (i % kStages) * stage_floats;
    const int p0 = i * T;
    const int nt = min(T, nc - p0);
    for (int p = warp; p < nt; p += nwarps) {
      float* dst = xs + p * CS;
      if constexpr (kDeltaRows) {  // [B (N) | C (N)] of the position (R = 0)
        const int row = (t0 + p0 + p) * N;
        for (int n = lane; n < N; n += 32) {
          cp_async4(dst + n, Bm_b + row + n);
          cp_async4(dst + NP + n, Cm_b + row + n);
        }
      } else {
        const float* src = xdbl_b + rows_s[p0 + p] * xdbl_stride;
        for (int j = lane; j < R; j += 32) cp_async4(dst + j, src + j);
        for (int j = lane; j < 2 * N; j += 32)
          cp_async4(dst + R4 + j + (j >= N ? NP - N : 0), src + R + j);
      }
    }
    if constexpr (kDeltaRows) {
      if (valid) {
        float* us = xs + T * CS + tid;
        for (int p = 0; p < nt; ++p) {
          cp_async4(us + p * bw, xb + (t0 + p0 + p) * D);
          cp_async4(us + (T + p) * bw, deltab + (t0 + p0 + p) * D);
        }
      }
    }
  };
  // Elsewhere u is loaded a group of kGroup positions ahead into registers,
  // across tiles, as it is in memory (a bf16 u is widened when it is used,
  // so that the load is not waited on early).
  const io_t u0 = static_cast<io_t>(0.f);
  auto load_u = [&](int q) { return q < nc ? xb[rows_s[q] * D] : u0; };
  io_t un[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) un[g] = !kDeltaRows && valid ? load_u(g) : u0;

  const long long kd = (long long)k * D + d;
  const long long state = (((long long)bk * a.nchunk + c) * D + d) * N;
  // A in base 2, so that a decay is exp2 of one product
  float A2[MAXN], h[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    A2[n] = (valid && n < N) ? a.A[kd * N + n] * kLog2e : 0.f;
    h[n] = (FINAL && valid && n < N) ? a.hstate[state + n] : 0.f;
  }
  const float bias_d = valid ? a.bias[kd] : 0.f;
  const float D_d = valid ? a.Dskip[kd] : 0.f;
  float pool = 0.f, sum_dt = 0.f;

  stage(0);
  cp_async_commit();
  if (ntiles > 1) stage(1);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<1>();  // this thread's copies of tile i have landed
    __syncthreads();     // everyone's; and everyone is done with tile i - 1
    if (i + 2 < ntiles) stage(i + 2);  // into tile i - 1's slot
    cp_async_commit();   // (empty at the tail: keeps one group a tile)
    if constexpr (kBf16Io<Path>) {
      // dt_proj's operand: tile i's dt columns rounded to bf16 in place, by
      // the whole block, so that the walk below reads them as it is (a
      // rounding at staging would wait on each load; one at use would cost
      // every channel R conversions a position)
      float* xt = ring_s + (i % kStages) * stage_floats;
      const int nt = min(T, nc - i * T);
      for (int e = tid; e < nt * R; e += bw) {
        const int p = e / R, j = e - p * R;
        xt[p * CS + j] = scan_round_bf16(xt[p * CS + j]);
      }
      __syncthreads();
    }
    if (!valid) continue;
    const float* xs = ring_s + (i % kStages) * stage_floats;
    const float* us = xs + T * CS + tid;
    const int p0 = i * T;
    const int nt = min(T, nc - p0);
    for (int p = 0; p < nt; p += kGroup) {
      // dt and dt * u of the group's positions first: kGroup independent
      // chains (W_dt read once for all of them), then their state updates.
      float dr[kGroup], ug[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        dr[g] = bias_d;
        if constexpr (kDeltaRows) {
          ug[g] = us[(p + g) * bw];
          dr[g] += us[(T + p + g) * bw];
        } else {
          ug[g] = scan_widen(un[g]);
          un[g] = load_u(p0 + p + g + kGroup);
        }
      }
      if constexpr (!kDeltaRows) {
        for (int r = 0; r < R4; r += 4) {
          const float w0 = wdt_s[r * bw + tid], w1 = wdt_s[(r + 1) * bw + tid];
          const float w2 = wdt_s[(r + 2) * bw + tid], w3 = wdt_s[(r + 3) * bw + tid];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float4 x4 = *reinterpret_cast<const float4*>(xs + (p + g) * CS + r);
            dr[g] = fmaf(w3, x4.w, fmaf(w2, x4.z, fmaf(w1, x4.y, fmaf(w0, x4.x, dr[g]))));
          }
        }
      }
      float dtg[kGroup], dug[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        dtg[g] = p + g < nt ? softplus(dr[g]) : 0.f;  // past the tile: no step
        dug[g] = dtg[g] * ug[g];
        if (!FINAL) sum_dt += dtg[g];
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (p + g >= nt) break;
        const float* xd = xs + (p + g) * CS;
        const float dt = dtg[g], du = dug[g];
        const float4* B4 = reinterpret_cast<const float4*>(xd + R4);
        const float4* C4 = reinterpret_cast<const float4*>(xd + R4 + NP);
        float yv[2] = {0.f, 0.f};  // C . h in two chains, even and odd fours
#pragma unroll
        for (int q = 0; q < MAXN / 4; ++q) {  // no branch: states past N are zeros
          const float4 b4 = B4[q];
          const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * q + j;
            h[n] = fmaf(exp2_mufu(dt * A2[n]), h[n], du * bq[j]);
          }
          if (FINAL) {
            const float4 c4 = C4[q];
            float& y = yv[q & 1];
            y = fmaf(c4.x, h[4 * q], y);
            y = fmaf(c4.y, h[4 * q + 1], y);
            y = fmaf(c4.z, h[4 * q + 2], y);
            y = fmaf(c4.w, h[4 * q + 3], y);
          }
        }
        if (FINAL) {
          const float out = fmaf(D_d, ug[g], yv[0] + yv[1]);
          // bf16: rounded to nearest even
          if constexpr (kind == PathKind::kStripe)
            scan_store(yb + outs_s[p0 + p + g] * D, out);
          else
            scan_store(yb + rows_s[p0 + p + g] * D, out);
          if (kImageRows<Path>) pool += out;  // the float32 y, before any rounding
        }
      }
    }
  }
  if (!valid) return;
  if (FINAL) {
    if (kImageRows<Path>) a.partial[((long long)bk * a.nchunk + c) * D + d] = pool;
  } else {
    // the chunk's decay product exp(A * sum of dt), one MUFU a state
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < N) {
        a.hstate[state + n] = h[n];
        a.decay[state + n] = exp2_mufu(A2[n] * sum_dt);
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

// The channel block: a multiple of 32 that D fills, so that no warp idles
// (96 for D = 96, 192 for 192, 256 for 234); above 256, the width of 256,
// 192 or 128 that leaves the fewest idle lanes (192 for 384, 256 for 768).
inline int scan_block_width(int D) {
  if (D <= kMaxScanThreads) return (D + 31) / 32 * 32;
  int best = kMaxScanThreads, idle = 1 << 30;
  for (int w = kMaxScanThreads; w >= 128; w -= 64) {
    const int i = (D + w - 1) / w * w - D;
    if (i < idle) best = w, idle = i;
  }
  return best;
}

template <int MAXN, class Path>
int launch_chunk_passes(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  const int bw = scan_block_width(a.D);
  const dim3 grid((a.D + bw - 1) / bw, a.nchunk, (unsigned)BK);
  const size_t smem = ScanSmem(a.R, MAXN, bw, Path::kKind == PathKind::kDelta)
                          .bytes(Path::kKind == PathKind::kStripe);
  int err;
  if (smem > 48 * 1024) {  // 72 KB at MaIR-CDN's widths
    if ((err = (int)cudaFuncSetAttribute(scan_chunk_kernel<false, MAXN, Path>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    if ((err = (int)cudaFuncSetAttribute(scan_chunk_kernel<true, MAXN, Path>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
  }
  // 1. chunk end states and decay products from a zero state
  scan_chunk_kernel<false, MAXN, Path><<<grid, bw, smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  // 2. states entering each chunk
  const long long chains = BK * a.D * a.N;
  chain_carries_kernel<Path><<<(unsigned)((chains + 255) / 256), 256, 0, st>>>(
      a.hstate, a.decay, BK, a.nchunk, a.D * a.N);
  if ((err = (int)cudaGetLastError())) return err;
  // 3. y (and the chunk sums of y) from the true initial states
  scan_chunk_kernel<true, MAXN, Path><<<grid, bw, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Passes 1-3 for BK sequences, with the register ceiling picked from N
// (1 <= N <= kMaxState, checked by the caller).
template <class Path>
int run_chunk_scan(const ChunkScanArgs& a, long long BK, cudaStream_t st) {
  // 32-bit offsets inside a sequence (x, y and x_dbl rows)
  const int row_floats = a.D > kK * (a.R + 2 * a.N) ? a.D : kK * (a.R + 2 * a.N);
  if ((long long)a.L * row_floats > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (a.N <= 4) return launch_chunk_passes<4, Path>(a, BK, st);
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
